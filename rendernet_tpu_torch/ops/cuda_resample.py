"""Multipass affine voxel resampling: the pass plan in PyTorch, each pass
on the K1 CUDA kernel (``csrc/resample.cu``).

Counterpart of ``rendernet_tpu/ops/pallas_resample.py``. The backward warp
``x <- M q`` of the pose is split into elementary passes, each updating one
coordinate (``x <- a x + b y + c z + d``), i.e. a 1-D linear interpolation
along one array axis whose sample position varies linearly over the grid:

  * each plane angle splits into an exact quarter turn (a transpose, with
    the axis reversals deferred into later passes' coefficients) plus a
    residual in [-45, 45] degrees, done as three unit-slope shears;
  * the isotropic scale and the full translation become three axis scale
    passes whose offsets are solved from the requirement that the whole
    plan equals ``grid_to_grid_matrix``;
  * adjacent same-axis passes merge: 8 interpolation passes per warp
    (axes 0, 2, 0 | 0, 1, 0, 1, 2).

The plan is tensor code around the kernel and runs in float32 on the
device of the pose (matmuls stay out of TF32, which PyTorch leaves off for
matmuls by default). The forward only: the shader training step
differentiates neither voxels nor pose, and the adjoint kernel
(pallas_resample._bwd_kernel, K4) comes with texture training.
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from rendernet_tpu_torch.ops import _native
from rendernet_tpu_torch.ops.transforms import grid_to_grid_matrix, voxel_to_image_axes

__all__ = [
    "build_pass_plan",
    "compose_plan_matrix",
    "apply_interp_pass",
    "interp_pass_plain",
    "rotate_resample_multipass",
    "rotate_resample_to_camera_multipass",
    "rotate_resample_camera_patch_multipass",
]

# Launches of the K1 kernel since the last reset, in all and by (BC, R, L,
# out_lanes), so that a window-emitting pass is told from a full one (the
# wrapper adds one per launch; the CPU path launches nothing).
launches = 0
launches_by_shape: Counter = Counter()


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------
def _shear_steps(plane: Tuple[int, int], theta: torch.Tensor, center: float) -> List:
    """R2D(theta) on (u, v) = plane as ShU(-tan(t/2)) ShV(sin t) ShU(-tan(t/2)),
    each shear anchored at ``center``."""
    u, v = plane
    t2 = -torch.tan(theta * 0.5)
    sn = torch.sin(theta)
    zero = torch.zeros_like(t2)
    one = torch.ones_like(t2)

    def shear(axis, other, slope):
        coeffs = [zero, zero, zero, -slope * center]
        coeffs[axis] = one
        coeffs[other] = slope
        return ("interp", axis, coeffs)

    return [shear(u, v, t2), shear(v, u, sn), shear(u, v, t2)]


_QTURN_LIN = {
    (0, 2): [
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
        [[0, 0, -1], [0, 1, 0], [1, 0, 0]],
        [[-1, 0, 0], [0, 1, 0], [0, 0, -1]],
        [[0, 0, 1], [0, 1, 0], [-1, 0, 0]],
    ],
    (0, 1): [
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
        [[0, -1, 0], [1, 0, 0], [0, 0, 1]],
        [[-1, 0, 0], [0, -1, 0], [0, 0, 1]],
        [[0, 1, 0], [-1, 0, 0], [0, 0, 1]],
    ],
}


def _qturn_matrix(plane, k: torch.Tensor, new_size: int) -> torch.Tensor:
    """Homogeneous [B,4,4] of the exact lattice quarter turn k*90 degrees,
    recentred at (new_size-1)/2."""
    lin = torch.tensor(_QTURN_LIN[plane], dtype=torch.float32, device=k.device)[k]
    c = torch.full((3,), (new_size - 1) / 2.0, dtype=torch.float32, device=k.device)
    trans = c[None] - (lin * c[None, None, :]).sum(-1)
    m = torch.eye(4, dtype=torch.float32, device=k.device).repeat(k.shape[0], 1, 1)
    m[:, :3, :3] = lin
    m[:, :3, 3] = trans
    return m


def _split_quarter(theta: torch.Tensor):
    """theta -> (k in [0, 4), residual in [-45, 45] degrees). ``torch.round``
    rounds half to even like ``jnp.round``; ``torch.remainder`` is the floor
    modulo of ``% 4`` on negative ints (``fmod`` is not)."""
    k = torch.round(theta / (math.pi / 2.0))
    r = theta - k * (math.pi / 2.0)
    return torch.remainder(k.to(torch.int64), 4), r


def build_pass_plan(view_params: torch.Tensor, size: int = 64, new_size: int = 128,
                    max_scale: float | None = None) -> List:
    """Step list of the backward warp: ``("qturn", plane, k [B])`` exact
    lattice turns and ``("interp", axis, coeffs [B, 4])`` 1-D passes. The
    source is assumed embedded centred in the ``new_size`` cube; the
    composition of all steps equals ``[grid_to_grid_matrix | +pad]``.

    ``max_scale``: the static bound on ``view_params[:, 2]`` that narrows the
    adjoint band of the scale passes (``pallas_resample._taps_for_scale``);
    it matters to the adjoint kernel (K4), which this package does not run
    yet. As in JAX, a pose whose scale exceeds it resamples to NaN rather
    than to a quietly wrong gradient; the JAX package also raises on
    concrete poses, which here would stall the device for a host read."""
    view_params = torch.as_tensor(view_params, dtype=torch.float32)
    bsz = view_params.shape[0]
    azimuth = view_params[:, 0] - math.pi * 0.5
    elevation = view_params[:, 1]
    if view_params.shape[1] >= 3:
        scale = view_params[:, 2]
    else:
        scale = torch.ones(bsz, dtype=torch.float32, device=view_params.device)
    if max_scale is not None:
        if max_scale <= 0:
            raise ValueError(f"max_scale must be positive, got {max_scale}")
        limit = float(max_scale) * (1.0 + 1e-6)
        scale = torch.where(scale <= limit, scale, torch.full_like(scale, float("nan")))
    center = new_size / 2.0
    pad = (new_size - size) // 2

    kxz, rxz = _split_quarter(-azimuth)
    kxy, rxy = _split_quarter(elevation)
    steps: List = [("qturn", (0, 2), kxz)]
    steps += _shear_steps((0, 2), rxz, center)
    steps.append(("qturn", (0, 1), kxy))
    steps += _shear_steps((0, 1), rxy, center)

    # Scale passes; offsets tau solved from the composition requirement.
    target = grid_to_grid_matrix(view_params, size=size, new_size=new_size)
    t_target = target[:, :, 3] + float(pad)
    m_pre = compose_plan_matrix(steps, new_size)
    tau = torch.linalg.solve(
        m_pre[:, :3, :3], (t_target - m_pre[:, :3, 3])[..., None]
    )[..., 0]
    inv_s = 1.0 / scale
    zero = torch.zeros_like(inv_s)
    for axis in range(3):
        coeffs = [zero, zero, zero, tau[:, axis]]
        coeffs[axis] = inv_s
        steps.append(("interp", axis, coeffs))

    # Merge adjacent same-axis passes: E1 (self-coef a1) then E2 compose into
    # one pass with row = a1 * row2 + (row1 with its self coef zeroed).
    merged: List = []
    for step in steps:
        if (step[0] == "interp" and merged and merged[-1][0] == "interp"
                and merged[-1][1] == step[1]):
            axis = step[1]
            prev = merged[-1][2]
            a1 = prev[axis]
            row1_rest = list(prev)
            row1_rest[axis] = torch.zeros_like(a1)
            merged[-1] = ("interp", axis, [a1 * c2 + c1r for c2, c1r in zip(step[2], row1_rest)])
        else:
            merged.append(step)
    return [
        ("interp", s[1], torch.stack(s[2], -1)) if s[0] == "interp" else s
        for s in merged
    ]


def compose_plan_matrix(steps: Sequence, new_size: int) -> torch.Tensor:
    """[B,4,4] effective backward map of ``steps`` (the whole plan, or the
    steps so far)."""
    total = None
    for step in steps:
        if step[0] == "qturn":
            m = _qturn_matrix(step[1], step[2], new_size)
        else:
            axis, coeffs = step[1], step[2]
            cols = coeffs.unbind(-1) if isinstance(coeffs, torch.Tensor) else coeffs
            m = torch.eye(4, dtype=torch.float32, device=cols[0].device).repeat(
                cols[0].shape[0], 1, 1)
            m[:, axis, :] = torch.stack(list(cols), -1)
        total = m if total is None else torch.matmul(total, m)
    return total


# ---------------------------------------------------------------------------
# one interpolation pass: K1 and its plain version
# ---------------------------------------------------------------------------
def interp_pass_plain(
    vol: torch.Tensor, params: torch.Tensor, db: int, out_lanes: int | None = None
) -> torch.Tensor:
    """Plain PyTorch version of K1 (same arithmetic, fp32 geometry and math
    on the stored values, one rounding to the stored type at the end)."""
    bc, r, lanes = vol.shape
    ol = lanes if out_lanes is None else out_lanes
    dev = vol.device
    rows = torch.arange(r, device=dev)
    d_a = (rows // db).to(torch.float32)[None, :, None]
    d_b = (rows % db).to(torch.float32)[None, :, None]
    ll = torch.arange(ol, device=dev, dtype=torch.float32)[None, None, :]
    p = params.to(torch.float32)
    al, ca, cb, de = (p[:, i, None, None] for i in range(4))
    pos = al * ll + (ca * d_a + cb * d_b + de)
    i0f = torch.floor(pos)
    w = pos - i0f
    i0 = torch.clamp(i0f, -2, lanes).to(torch.int64)  # both taps stay out of range
    v = vol.to(torch.float32)
    m0 = ((i0 >= 0) & (i0 <= lanes - 1)).to(torch.float32)
    m1 = ((i0 + 1 >= 0) & (i0 + 1 <= lanes - 1)).to(torch.float32)
    g0 = torch.gather(v, 2, torch.clamp(i0, 0, lanes - 1))
    g1 = torch.gather(v, 2, torch.clamp(i0 + 1, 0, lanes - 1))
    return ((1.0 - w) * g0 * m0 + w * g1 * m1).to(vol.dtype)


def apply_interp_pass(
    vol: torch.Tensor, params: torch.Tensor, db: int, out_lanes: int | None = None
) -> torch.Tensor:
    """One 1-D interpolation pass along the minor axis.

    ``vol`` ``[BC, R, L]`` with rows encoding the two other coordinates as
    ``row = d_a * db + d_b``; ``params`` ``[BC, 4]`` = (alpha, c_a, c_b,
    delta): lane l of row (d_a, d_b) samples at
    ``alpha*l + c_a*d_a + c_b*d_b + delta``; out-of-range positions read
    zero. ``out_lanes`` emits only lanes ``[0, out_lanes)``.

    A CUDA tensor runs the K1 kernel; a CPU tensor runs
    :func:`interp_pass_plain`.
    """
    if vol.device.type == "cpu":
        return interp_pass_plain(vol, params, db, out_lanes)
    bc, r, lanes = vol.shape
    ol = lanes if out_lanes is None else int(out_lanes)
    if vol.device.type != "cuda" or params.device != vol.device:
        raise ValueError("apply_interp_pass: vol and params must be on one CUDA device")
    if params.shape != (bc, 4) or not 0 < ol <= lanes or r % db or bc > 65535:
        raise ValueError(f"apply_interp_pass: bad shapes vol {tuple(vol.shape)}, "
                         f"params {tuple(params.shape)}, db {db}, out_lanes {ol}")
    vol = vol.contiguous()
    params = params.to(torch.float32).contiguous()
    out = torch.empty((bc, r, ol), dtype=vol.dtype, device=vol.device)
    lib = _native.load("resample")
    lib.rn_resample_pass.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = lib.rn_resample_pass(
        vol.data_ptr(), params.data_ptr(), out.data_ptr(), _native.dtype_code(vol.dtype),
        bc, r, lanes, ol, db, _native.stream_ptr(vol))
    _native.check(lib, rc, "K1 resample pass")
    global launches
    launches += 1
    launches_by_shape[(bc, r, lanes, ol)] += 1
    return out


# ---------------------------------------------------------------------------
# full multipass warp
# ---------------------------------------------------------------------------
def _qturn_swap(vol: torch.Tensor, plane: Tuple[int, int], k: torch.Tensor):
    """Data movement of a per-sample quarter turn with the flips deferred:
    rot1 = flip_a0 . swap, rot2 = flip_a0 . flip_a1, rot3 = flip_a1 . swap.
    Only the transpose is materialised; the reversals come back as
    per-sample flags that later passes fold into their coefficients.
    ``vol`` is canonical ``[BC, Z, Y, X]``."""
    a0, a1 = (0, 2) if plane == (0, 2) else (1, 2)
    odd = (k % 2) == 1
    swapped = torch.transpose(vol, a0 + 1, a1 + 1)
    vol = torch.where(odd[:, None, None, None], swapped, vol)
    flip_a0 = (k == 1) | (k == 2)
    flip_a1 = (k == 2) | (k == 3)
    return vol, (a0, flip_a0), (a1, flip_a1)


def rotate_resample_multipass(
    voxels: torch.Tensor,
    view_params: torch.Tensor,
    size: int | None = None,
    new_size: int = 128,
    crop_windows: dict | None = None,
    max_scale: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Multipass counterpart of ``ops.resample.rotate_resample``:
    ``[B, S, S, S, C] -> [B, N, N, N, C]`` in ``compute_dtype`` (the volume
    data's storage type through the passes; geometry stays float32).

    ``crop_windows``: optional ``{logical_axis: (start, win_size)}`` (0 = x,
    1 = y, 2 = z) emits only ``[start, start + win_size)`` of those
    destination axes; the window comes out of the axis's last interp pass
    (K1's ``out_lanes``), so later passes run on the cropped rows. ``start``
    may be a float or a 0-d float32 tensor. ``max_scale``: see
    :func:`build_pass_plan`.
    """
    b, s1, s2, s3, c = voxels.shape
    if size is None:
        size = s1
    n = new_size
    dev = voxels.device
    view_params = torch.as_tensor(view_params, dtype=torch.float32, device=dev)
    vol = voxels.to(compute_dtype).movedim(-1, 1).reshape(b * c, s1, s2, s3)
    pad = (n - size) // 2
    vol = F.pad(vol, (pad, n - size - pad) * 3)

    steps = build_pass_plan(view_params, size=size, new_size=n, max_scale=max_scale)
    crop_windows = dict(crop_windows or {})
    last_interp = {step[1]: i for i, step in enumerate(steps) if step[0] == "interp"}
    for ax in crop_windows:
        for later in steps[last_interp[ax] + 1:]:
            if later[0] != "interp" or later[1] == ax:
                raise ValueError(f"axis {ax} cannot be window-cropped: the pass plan "
                                 "touches it after its last interp pass")
    started: dict = {}  # logical axis -> window start (window-local coordinates)
    # logical axis -> [BC] bool: the axis is stored reversed (deferred qturn
    # flip). A pass ON the axis absorbs the flag; passes that read it as a
    # row coordinate fold it into their coefficients and keep it.
    flipped: dict = {}

    def per_c(x):
        return torch.repeat_interleave(x, c, dim=0) if c > 1 else x

    # axes[i] = logical coordinate (0=x, 1=y, 2=z) on array axis i+1.
    axes = [2, 1, 0]

    def to_canonical(vol, axes):
        for want, arr_pos in ((2, 0), (1, 1)):
            cur = axes.index(want)
            if cur != arr_pos:
                vol = torch.transpose(vol, arr_pos + 1, cur + 1)
                axes[arr_pos], axes[cur] = axes[cur], axes[arr_pos]
        return vol

    for i, step in enumerate(steps):
        if step[0] == "qturn":
            plane, k = step[1], per_c(step[2])
            vol = to_canonical(vol, axes)
            vol, (a0, f0), (a1, f1) = _qturn_swap(vol, plane, k)
            for arr_ax, f in ((a0, f0), (a1, f1)):
                lg = axes[arr_ax]
                flipped[lg] = flipped[lg] ^ f if lg in flipped else f
            continue
        axis, coeffs = step[1], per_c(step[2])
        pos = axes.index(axis)
        if pos != 2:
            vol = torch.transpose(vol, pos + 1, 3)
            axes[pos], axes[2] = axes[2], axes[pos]
        a_coord, b_coord = axes[0], axes[1]
        da, db, lanes = vol.shape[1], vol.shape[2], vol.shape[3]
        alpha = coeffs[:, axis]
        delta = coeffs[:, 3]
        # Row coordinates of already-cropped axes are window-local (shifted
        # back by the start); those of flip-deferred axes are stored reversed.
        row_c = {}
        for coord, ext in ((a_coord, da), (b_coord, db)):
            cval = coeffs[:, coord]
            if coord in started:
                delta = delta + cval * started[coord]
            if coord in flipped:
                f = flipped[coord]
                delta = delta + torch.where(f, cval * (ext - 1), 0.0)
                cval = torch.where(f, -cval, cval)
            row_c[coord] = cval
        ca, cb = row_c[a_coord], row_c[b_coord]
        out_lanes = None
        if axis in crop_windows and i == last_interp[axis]:
            start, out_lanes = crop_windows[axis]
            start = torch.as_tensor(start, dtype=torch.float32, device=dev)
            delta = delta + alpha * start
            started[axis] = start
        if axis in flipped:
            # The stored input is reversed along the lane axis: every sample
            # position maps pos -> lanes-1-pos; this pass's output is stored
            # in logical order, so the flag clears.
            f = flipped.pop(axis)
            alpha = torch.where(f, -alpha, alpha)
            ca = torch.where(f, -ca, ca)
            cb = torch.where(f, -cb, cb)
            delta = torch.where(f, float(lanes - 1) - delta, delta)
        params = torch.stack([alpha, ca, cb, delta], dim=-1)
        vol = apply_interp_pass(vol.reshape(b * c, da * db, lanes), params, db, out_lanes)
        vol = vol.reshape(b * c, da, db, -1)

    if flipped:
        raise AssertionError("internal: a deferred quarter-turn flip survived the plan")
    vol = to_canonical(vol, axes)
    _, d1, d2, d3 = vol.shape
    return vol.reshape(b, c, d1, d2, d3).movedim(1, -1)


def rotate_resample_to_camera_multipass(
    voxels: torch.Tensor,
    view_params: torch.Tensor,
    size: int | None = None,
    new_size: int = 128,
    max_scale: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Multipass counterpart of ``rotate_resample_to_camera``."""
    return voxel_to_image_axes(
        rotate_resample_multipass(voxels, view_params, size, new_size,
                                  max_scale=max_scale, compute_dtype=compute_dtype)
    )


def rotate_resample_camera_patch_multipass(
    voxels: torch.Tensor,
    view_params: torch.Tensor,
    offsets,
    patch_size: int,
    size: int | None = None,
    new_size: int = 128,
    max_scale: float | None = None,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Crop-fused multipass resample (``pallas_resample.py:681-712``): equals
    ``rotate_resample_to_camera_multipass(...)[:, u0:u0+P, v0:v0+P]``, with
    the last pass of each cropped axis emitting only the window.
    ``offsets`` = (u0, v0), the crop starts in the image-aligned (row, col)
    axes; depth is never cropped."""
    # Image rows u map to logical y as j = N-1-u (voxel_to_image_axes), so
    # the u-window [u0, u0+P) is the y-window starting at N-P-u0; image
    # columns v map to logical z directly.
    u0, v0 = (float(o) for o in offsets)
    windows = {1: (float(new_size - patch_size) - u0, patch_size), 2: (v0, patch_size)}
    return voxel_to_image_axes(
        rotate_resample_multipass(voxels, view_params, size, new_size, crop_windows=windows,
                                  max_scale=max_scale, compute_dtype=compute_dtype)
    )
