"""Multipass affine voxel resampling: the pass plan in PyTorch, each pass
on the K1 CUDA kernel (``csrc/resample.cu``) and its adjoint on the K4
kernel (``csrc/resample_bwd.cu``).

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

The plan is tensor code around the kernels and runs in float32 on the
device of the pose (matmuls stay out of TF32, which PyTorch leaves off for
matmuls by default). Every pass is differentiable (:func:`apply_interp_pass`,
the custom VJP of ``pallas_resample.py:432-492``): the backward runs K4,
which returns the voxel cotangent over a static band of ``taps`` output
lanes per input lane and the per-lane position cotangent, and a contraction
of the latter against the lane and row coordinates gives the gradient of
the pass coefficients, which flows on through the plan (tan/sin of the
residual angles, the solve for the scale offsets, the flip and crop folds)
into the pose. The quarter-turn counts carry no gradient, as in JAX.

K1 and K4 are persistent kernels over tiles of whole rows, launched with
the plan :func:`pass_plan` makes from the shape: the bulk path (1-D bulk
copies through a ring of shared stages) where rows are whole 16-byte
vectors, else the scalar path of the same kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from rendernet_tpu_torch.ops import _native
from rendernet_tpu_torch.ops.transforms import grid_to_grid_matrix, voxel_to_image_axes

__all__ = [
    "build_pass_plan",
    "compose_plan_matrix",
    "apply_interp_pass",
    "interp_pass_fwd",
    "interp_pass_plain",
    "interp_pass_bwd",
    "interp_pass_bwd_plain",
    "pass_param_grad",
    "pass_plan",
    "rotate_resample_multipass",
    "rotate_resample_to_camera_multipass",
    "rotate_resample_camera_patch_multipass",
]

# Launches since the last reset, in all, by shape and by path: K1
# (``launches``, by (BC, R, L, out_lanes), so that a window-emitting pass is
# told from a full one) and K4 (``bwd_launches``, by (BC, R, L, out_lanes,
# taps)); by path "bulk" or "scalar" (:func:`pass_plan`). Each wrapper adds
# one per launch; the CPU path launches nothing.
launches = 0
launches_by_shape: Counter = Counter()
launches_by_path: Counter = Counter()
bwd_launches = 0
bwd_launches_by_shape: Counter = Counter()
bwd_launches_by_path: Counter = Counter()

# Static adjoint band (``pallas_resample.py:78-104``): input lane i is
# touched by the output lanes l with |alpha*l + o - i| < 1, an open interval
# of length 2/|alpha|, so ceil(2/|alpha|) + 1 taps cover it. Shear passes
# have self-slope 1 (3 taps); the scale passes have self-slope 1/s, and 6
# taps cover s <= 2.
_TAPS_SHEAR = 3
_TAPS_SCALE = 6


def _taps_for_scale(max_scale: float | None) -> int:
    """Tap count of the scale-carrying passes for poses with scale <=
    ``max_scale`` (None: the default bound, s <= 2)."""
    if max_scale is None:
        return _TAPS_SCALE
    if max_scale <= 0:
        raise ValueError(f"max_scale must be positive, got {max_scale}")
    return max(_TAPS_SHEAR, int(math.ceil(2.0 * max_scale - 1e-6)) + 1)


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
        return ("interp", axis, coeffs, _TAPS_SHEAR)

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


@functools.lru_cache(maxsize=None)
def _qturn_table(plane, device: torch.device) -> torch.Tensor:
    """[4, 3, 3] turn table on ``device``, copied once: a copy from the host
    waits for the device's queue."""
    return torch.tensor(_QTURN_LIN[plane], dtype=torch.float32, device=device)


def _qturn_matrix(plane, k: torch.Tensor, new_size: int) -> torch.Tensor:
    """Homogeneous [B,4,4] of the exact lattice quarter turn k*90 degrees,
    recentred at (new_size-1)/2."""
    lin = _qturn_table(plane, k.device)[k]
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
    lattice turns and ``("interp", axis, coeffs [B, 4], taps)`` 1-D passes,
    ``taps`` being the pass's static adjoint band (a merged pass takes the
    wider of its parts'). The source is assumed embedded centred in the
    ``new_size`` cube; the composition of all steps equals
    ``[grid_to_grid_matrix | +pad]``.

    ``max_scale``: the static bound on ``view_params[:, 2]`` that narrows the
    adjoint band of the scale passes (:func:`_taps_for_scale`). As in JAX, a
    pose whose scale exceeds it resamples to NaN rather than to a quietly
    wrong gradient; the JAX package also raises on concrete poses, which
    here would stall the device for a host read."""
    view_params = torch.as_tensor(view_params, dtype=torch.float32)
    bsz = view_params.shape[0]
    azimuth = view_params[:, 0] - math.pi * 0.5
    elevation = view_params[:, 1]
    if view_params.shape[1] >= 3:
        scale = view_params[:, 2]
    else:
        scale = torch.ones(bsz, dtype=torch.float32, device=view_params.device)
    taps_scale = _taps_for_scale(max_scale)
    if max_scale is not None:
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
    # solve_ex: no singularity check, which would wait for the device (the
    # linear part is a rotation); its gradient flows into the pose
    tau = torch.linalg.solve_ex(
        m_pre[:, :3, :3], (t_target - m_pre[:, :3, 3])[..., None]
    )[0][..., 0]
    inv_s = 1.0 / scale
    zero = torch.zeros_like(inv_s)
    for axis in range(3):
        coeffs = [zero, zero, zero, tau[:, axis]]
        coeffs[axis] = inv_s
        steps.append(("interp", axis, coeffs, taps_scale))

    # Merge adjacent same-axis passes: E1 (self-coef a1) then E2 compose into
    # one pass with row = a1 * row2 + (row1 with its self coef zeroed); its
    # self-slope a1 * a2 takes the wider band of the two.
    merged: List = []
    for step in steps:
        if (step[0] == "interp" and merged and merged[-1][0] == "interp"
                and merged[-1][1] == step[1]):
            axis = step[1]
            prev = merged[-1][2]
            a1 = prev[axis]
            row1_rest = list(prev)
            row1_rest[axis] = torch.zeros_like(a1)
            merged[-1] = ("interp", axis, [a1 * c2 + c1r for c2, c1r in zip(step[2], row1_rest)],
                          max(merged[-1][3], step[3]))
        else:
            merged.append(step)
    return [
        ("interp", s[1], torch.stack(s[2], -1), s[3]) if s[0] == "interp" else s
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


# The kernels' launch plan. K1 and K4 are persistent kernels over tiles of
# whole rows of one bc (``csrc/resample_tile.cuh``); this function is the
# one place their geometry is chosen, and the kernels decode it.
PASS_THREADS = 256  # kThreads of resample_tile.cuh: the consumer threads of a CTA
PASS_BULK_THREADS = 288  # kBulkThreads: with the bulk path's producer warp
PASS_PAD = 8  # kPad of resample_tile.cuh: zeros on each side of a staged input row
PASS_MAX_LANES = 6144  # one fp32 row of K4's stage in a ring of two fits a CTA
SMEM_PER_CTA = 232448  # an H100 CTA's dynamic shared memory (227 KB)
SMEM_PER_SM = 233472  # an H100 SM's shared memory (228 KB), 1 KB of it per CTA
# Sizes chosen on an H100 (the fastest of a sweep of 8-64 KB stages, 2 or 3
# stages and 2-8 CTAs per SM at the main path's shapes, timed as CUDA-graph
# replays): a tile's inputs and outputs aim at STAGE_BYTES (K1, K4), the
# bulk path's ring has PASS_STAGES stages, at most MAX_CTAS_PER_SM CTAs.
STAGE_BYTES = {False: 16384, True: 32768}
PASS_STAGES = 2
MAX_CTAS_PER_SM = 4


class PassPlan(NamedTuple):
    """K1's or K4's launch: ``path`` "bulk" (rows are whole 16-byte vectors:
    1-D bulk copies through a ring of ``stages`` shared stages) or "scalar"
    (one stage, ordinary loads and stores); ``rows`` per tile; tiles are
    numbered bc-major, ``tiles_per_bc`` per bc, and CTA i of ``grid`` takes
    tiles i, i + grid, ...; ``smem`` dynamic shared bytes per CTA."""

    path: str
    rows: int
    stages: int
    tiles_per_bc: int
    tiles: int
    grid: int
    smem: int


def _round128(n: int) -> int:
    return -(-n // 128) * 128


def pass_smem(rows: int, lanes: int, ol: int, item: int, adjoint: bool, bulk: bool,
              stages: int) -> int:
    """Shared bytes of a CTA, laid out as the kernels lay them out: 128
    bytes of ring barriers, then ``stages`` stages of a header (alpha,
    1/alpha, two unused floats, o_row per row; fp32), the input rows padded
    with PASS_PAD zeros on both sides (v; for K4 also g) in the stored type
    and, on the bulk path, the output tiles (K1's out; K4's gv, and gp in
    fp32), each piece on a 128-byte boundary (``k1_stage_bytes``,
    ``k4_stage_bytes``)."""
    def padded(width):
        return _round128(rows * (width + 2 * PASS_PAD) * item)

    stage = _round128(16 + 4 * rows) + padded(lanes)
    if adjoint:
        stage += padded(ol)
        if bulk:
            stage += _round128(rows * lanes * item) + _round128(rows * ol * 4)
    elif bulk:
        stage += _round128(rows * ol * item)
    return 128 + stages * stage


@functools.lru_cache(maxsize=None)
def pass_plan(bc: int, r: int, lanes: int, ol: int, dtype: torch.dtype, sm_count: int,
              adjoint: bool = False) -> PassPlan:
    """The launch plan of K1 (``adjoint`` False) or K4 on ``[BC, R, L]`` rows
    emitting ``ol`` lanes, in storage ``dtype``, on a card of ``sm_count``
    SMs. The bulk path needs rows of L and of ``ol`` values to be whole
    16-byte vectors (the wrappers align the base pointers); rows per tile:
    the largest power of two whose inputs and outputs fit STAGE_BYTES (at
    least one row, at most R); as many CTAs per SM as their
    shared memory and 2048 threads allow, up to MAX_CTAS_PER_SM, and no
    more CTAs than tiles."""
    item = {torch.float32: 4, torch.bfloat16: 2}[dtype]
    bulk = lanes * item % 16 == 0 and ol * item % 16 == 0
    stages = PASS_STAGES if bulk else 1
    row_bytes = (2 * lanes + ol) * item + 4 * ol if adjoint else (lanes + ol) * item
    rows = 1 << max(0, (STAGE_BYTES[adjoint] // row_bytes).bit_length() - 1)  # a power of 2
    rows = min(rows, r)
    smem = pass_smem(rows, lanes, ol, item, adjoint, bulk, stages)
    if smem > SMEM_PER_CTA:
        raise ValueError(f"resample pass: {lanes} lanes do not fit a CTA's shared memory")
    tiles_per_bc = -(-r // rows)
    tiles = bc * tiles_per_bc
    threads = PASS_BULK_THREADS if bulk else PASS_THREADS
    per_sm = max(1, min(MAX_CTAS_PER_SM, SMEM_PER_SM // (smem + 1024), 2048 // threads))
    return PassPlan("bulk" if bulk else "scalar", rows, stages, tiles_per_bc, tiles,
                    min(tiles, per_sm * sm_count), smem)


@functools.lru_cache(maxsize=None)
def _plan_args(plan: PassPlan) -> tuple:
    """The plan as the C entries take it (path 1 bulk, 0 scalar)."""
    return (int(plan.path == "bulk"), plan.rows, plan.stages, plan.tiles_per_bc, plan.tiles,
            plan.grid, plan.smem)


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """The K1 / K4 library, its entry's argument types set once."""
    lib = _native.load(name)
    if name == "resample":
        lib.rn_resample_pass.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 12
                                         + [ctypes.c_void_p])
    else:
        lib.rn_resample_pass_bwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 13
                                             + [ctypes.c_void_p])
    return lib


def _check_pass(what: str, vol: torch.Tensor, params: torch.Tensor, db: int, ol: int) -> None:
    bc, r, lanes = vol.shape
    if vol.device.type != "cuda" or params.device != vol.device:
        raise ValueError(f"{what}: vol and params must be on one CUDA device")
    if (params.shape != (bc, 4) or not 0 < ol <= lanes or r % db or lanes > PASS_MAX_LANES
            or bc * r >= 2 ** 31):
        raise ValueError(f"{what}: bad shapes vol {tuple(vol.shape)}, "
                         f"params {tuple(params.shape)}, db {db}, out_lanes {ol} "
                         f"(lanes <= {PASS_MAX_LANES})")


def interp_pass_fwd(
    vol: torch.Tensor, params: torch.Tensor, db: int, out_lanes: int | None = None
) -> torch.Tensor:
    """The K1 wrapper: one interpolation pass (see :func:`apply_interp_pass`)
    with no gradient. A CUDA tensor runs the K1 kernel; a CPU tensor runs
    :func:`interp_pass_plain`."""
    if vol.device.type == "cpu":
        return interp_pass_plain(vol, params, db, out_lanes)
    bc, r, lanes = vol.shape
    ol = lanes if out_lanes is None else int(out_lanes)
    _check_pass("interp_pass_fwd", vol, params, db, ol)
    vol = _native.aligned(vol)
    params = params.to(torch.float32).contiguous()
    out = torch.empty((bc, r, ol), dtype=vol.dtype, device=vol.device)
    plan = pass_plan(bc, r, lanes, ol, vol.dtype, _native.sm_count(vol.device.index))
    lib = _lib("resample")
    rc = lib.rn_resample_pass(
        vol.data_ptr(), params.data_ptr(), out.data_ptr(), _native.dtype_code(vol.dtype),
        r, lanes, ol, db, *_plan_args(plan), _native.stream_ptr(vol))
    _native.check(lib, rc, "K1 resample pass")
    global launches
    launches += 1
    launches_by_shape[(bc, r, lanes, ol)] += 1
    launches_by_path[plan.path] += 1
    return out


# ---------------------------------------------------------------------------
# the adjoint of one pass: K4 and its plain version
# ---------------------------------------------------------------------------
def interp_pass_bwd_plain(
    vol: torch.Tensor, params: torch.Tensor, g: torch.Tensor, db: int, taps: int,
    out_lanes: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 (``pallas_resample._bwd_kernel``, :347):
    ``(gv [BC, R, L]`` in the volume's dtype, ``gp [BC, R, out_lanes]``
    float32). An explicit enumeration of each input lane's band of ``taps``
    output lanes, in the kernel's order and rounding, not autograd through
    :func:`interp_pass_plain`: a band too narrow for the pose drops taps
    here exactly as it does in JAX."""
    bc, r, lanes = vol.shape
    ol = lanes if out_lanes is None else out_lanes
    dev = vol.device
    rows = torch.arange(r, device=dev)
    d_a = (rows // db).to(torch.float32)[None, :, None]
    d_b = (rows % db).to(torch.float32)[None, :, None]
    p = params.to(torch.float32)
    al, ca, cb, de = (p[:, i, None, None] for i in range(4))
    o_row = ca * d_a + cb * d_b + de  # [BC, R, 1]
    v = vol.to(torch.float32)
    gf = g.to(torch.float32)
    if ol < lanes:  # zeros are exactly the out-of-window contribution
        gf = F.pad(gf, (0, lanes - ol))
    ll = torch.arange(lanes, device=dev, dtype=torch.float32)[None, None, :]

    # position cotangent: dout/dpos = v1*m1 - v0*m0, per output lane
    i0 = torch.clamp(torch.floor(al * ll[..., :ol] + o_row), -2, lanes).to(torch.int64)
    m0 = ((i0 >= 0) & (i0 <= lanes - 1)).to(torch.float32)
    m1 = ((i0 + 1 >= 0) & (i0 + 1 <= lanes - 1)).to(torch.float32)
    v0 = torch.gather(v, 2, torch.clamp(i0, 0, lanes - 1))
    v1 = torch.gather(v, 2, torch.clamp(i0 + 1, 0, lanes - 1))
    gp = gf[..., :ol] * (v1 * m1 - v0 * m0)

    # voxel cotangent: gv[i] = sum over the band of g[l] * (1 - |pos_l - i|);
    # l0 clamped to [-taps-1, ol] as in the kernel, which changes no tap's
    # validity and keeps the int conversion in range
    inv_al = 1.0 / al
    b1 = (ll - 1.0 - o_row) * inv_al
    b2 = (ll + 1.0 - o_row) * inv_al
    l0 = torch.clamp(torch.ceil(torch.minimum(b1, b2)), -taps - 1, ol).to(torch.int64)
    acc = torch.zeros((bc, r, lanes), dtype=torch.float32, device=dev)
    for t in range(taps):
        lt = l0 + t
        wgt = 1.0 - torch.abs(al * lt.to(torch.float32) + o_row - ll)
        valid = (wgt > 0.0) & (lt >= 0) & (lt <= ol - 1)
        gl = torch.gather(gf, 2, torch.clamp(lt, 0, lanes - 1))
        acc = acc + torch.where(valid, wgt * gl, 0.0)
    return acc.to(vol.dtype), gp


def interp_pass_bwd(
    vol: torch.Tensor, params: torch.Tensor, g: torch.Tensor, db: int, taps: int,
    out_lanes: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K4 wrapper: the voxel cotangent ``gv`` (volume's dtype) and the
    position cotangent ``gp`` (float32) of one pass, given its output
    cotangent ``g`` ``[BC, R, out_lanes]``. A CUDA tensor runs the K4
    kernel; a CPU tensor runs :func:`interp_pass_bwd_plain`."""
    if vol.device.type == "cpu":
        return interp_pass_bwd_plain(vol, params, g, db, taps, out_lanes)
    bc, r, lanes = vol.shape
    ol = lanes if out_lanes is None else int(out_lanes)
    _check_pass("interp_pass_bwd", vol, params, db, ol)
    if tuple(g.shape) != (bc, r, ol) or g.device != vol.device or taps < 1:
        raise ValueError(f"interp_pass_bwd: bad cotangent {tuple(g.shape)} for vol "
                         f"{tuple(vol.shape)}, out_lanes {ol}, taps {taps}")
    vol = _native.aligned(vol)
    g = _native.aligned(g.to(vol.dtype))
    params = params.to(torch.float32).contiguous()
    gv = torch.empty_like(vol)
    gp = torch.empty((bc, r, ol), dtype=torch.float32, device=vol.device)
    plan = pass_plan(bc, r, lanes, ol, vol.dtype, _native.sm_count(vol.device.index),
                     adjoint=True)
    lib = _lib("resample_bwd")
    rc = lib.rn_resample_pass_bwd(
        vol.data_ptr(), g.data_ptr(), params.data_ptr(), gv.data_ptr(), gp.data_ptr(),
        _native.dtype_code(vol.dtype), r, lanes, ol, db, taps, *_plan_args(plan),
        _native.stream_ptr(vol))
    _native.check(lib, rc, "K4 resample pass adjoint")
    global bwd_launches
    bwd_launches += 1
    bwd_launches_by_shape[(bc, r, lanes, ol, taps)] += 1
    bwd_launches_by_path[plan.path] += 1
    return gv, gp


def pass_param_grad(gp: torch.Tensor, db: int) -> torch.Tensor:
    """``[BC, 4]`` gradient of (alpha, c_a, c_b, delta) from the position
    cotangent ``gp`` ``[BC, R, out_lanes]``: its sums against the lane
    index, the two row coordinates and one (``pallas_resample.py:477-489``),
    as one contraction over lanes and one over rows."""
    bc, r, ol = gp.shape
    dev = gp.device
    lane_basis = torch.stack([torch.arange(ol, device=dev, dtype=torch.float32),
                              torch.ones(ol, device=dev)], -1)  # [OL, 2]
    per_row = torch.matmul(gp, lane_basis)  # [BC, R, 2]: sum_l gp*l, sum_l gp
    rows = torch.arange(r, device=dev)
    row_basis = torch.stack([(rows // db).to(torch.float32), (rows % db).to(torch.float32),
                             torch.ones(r, device=dev)], -1)  # [R, 3]
    by_row = torch.matmul(per_row[..., 1], row_basis)  # [BC, 3]
    return torch.cat([per_row[..., 0].sum(1, keepdim=True), by_row], -1)


class _InterpPass(torch.autograd.Function):
    """One pass with its custom VJP (``_pass_fwd`` / ``_pass_bwd``)."""

    @staticmethod
    def forward(ctx, vol, params, db, out_lanes, taps):
        ctx.save_for_backward(vol, params)
        ctx.db, ctx.out_lanes, ctx.taps = db, out_lanes, taps
        return interp_pass_fwd(vol, params, db, out_lanes)

    @staticmethod
    def backward(ctx, g):
        vol, params = ctx.saved_tensors
        gv, gp = interp_pass_bwd(vol, params, g, ctx.db, ctx.taps, ctx.out_lanes)
        gparams = pass_param_grad(gp, ctx.db).to(params.dtype) if ctx.needs_input_grad[1] \
            else None
        return (gv if ctx.needs_input_grad[0] else None), gparams, None, None, None


def apply_interp_pass(
    vol: torch.Tensor, params: torch.Tensor, db: int, out_lanes: int | None = None,
    *, taps: int = _TAPS_SCALE,
) -> torch.Tensor:
    """One differentiable 1-D interpolation pass along the minor axis.

    ``vol`` ``[BC, R, L]`` with rows encoding the two other coordinates as
    ``row = d_a * db + d_b``; ``params`` ``[BC, 4]`` = (alpha, c_a, c_b,
    delta): lane l of row (d_a, d_b) samples at
    ``alpha*l + c_a*d_a + c_b*d_b + delta``; out-of-range positions read
    zero. ``out_lanes`` emits only lanes ``[0, out_lanes)``. ``taps``: the
    static adjoint band, at least ``2/|alpha| + 1``.

    Forward on K1 (:func:`interp_pass_fwd`), backward on K4
    (:func:`interp_pass_bwd`) plus :func:`pass_param_grad`; CPU tensors take
    the plain versions.
    """
    return _InterpPass.apply(vol, params, db, out_lanes, taps)


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
        axis, coeffs, taps = step[1], per_c(step[2]), step[3]
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
        vol = apply_interp_pass(vol.reshape(b * c, da * db, lanes), params, db, out_lanes,
                                taps=taps)
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
