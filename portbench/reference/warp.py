"""The multipass warp in plain PyTorch: a frozen copy of the port's pass plan
(``ops/cuda_resample.py``) and of its passes' plain form, with the pose
matrices of ``ops/transforms.py``.

The backward warp ``x <- M q`` of a pose is split into exact quarter turns,
three unit-slope shears per plane angle and three axis scale passes whose
offsets solve for the whole plan equalling the pose's grid-to-grid map;
adjacent same-axis passes merge into 8 one-dimensional linear
interpolations. Each pass here is a gather in float32 (or in the dtype the
control asks for), differentiable in the volume by autograd, so the texture
step's grid gradient is the exact adjoint that the port's K4 computes. The
geometry is float32 throughout, as in the port, so both sides sample at the
same positions and differ only in the stored values' precision.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

_TAPS_SHEAR = 3
_TAPS_SCALE = 6


def rotation_around_grid_centroid(view_params: torch.Tensor) -> torch.Tensor:
    """``[B, 3]`` (azimuth, elevation, scale) -> ``[B, 4, 4]`` =
    ``Scale @ Rz(elevation) @ Ry(azimuth - pi/2)``."""
    azimuth = view_params[:, 0] - math.pi * 0.5
    elevation = view_params[:, 1]
    ca, sa = torch.cos(azimuth), torch.sin(azimuth)
    ce, se = torch.cos(elevation), torch.sin(elevation)
    zeros, ones = torch.zeros_like(ca), torch.ones_like(ca)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rot_y = mat([[ca, zeros, -sa, zeros], [zeros, ones, zeros, zeros],
                 [sa, zeros, ca, zeros], [zeros, zeros, zeros, ones]])
    rot_z = mat([[ce, se, zeros, zeros], [-se, ce, zeros, zeros],
                 [zeros, zeros, ones, zeros], [zeros, zeros, zeros, ones]])
    m = torch.matmul(rot_z, rot_y)
    scale = view_params[:, 2]
    s = torch.stack([scale, scale, scale, torch.ones_like(scale)], dim=-1)
    return s[:, :, None] * m


def grid_to_grid_matrix(view_params: torch.Tensor, size: int, new_size: int) -> torch.Tensor:
    """``[B, 3, 4]`` backward map from destination indices to source
    coordinates (R is orthogonal times the scale)."""
    r = rotation_around_grid_centroid(view_params)[:, :3, :3]
    scale = view_params[:, 2][:, None, None]
    r_inv = torch.transpose(r / scale, 1, 2) / scale
    t = -(new_size * 0.5) * torch.sum(r_inv, dim=2) + size * 0.5
    return torch.cat([r_inv, t[:, :, None]], dim=2)


def voxel_to_image_axes(voxels: torch.Tensor) -> torch.Tensor:
    """``[B, A1, A2, D, C]``: swap axes 1 and 2, then flip the new axis 1."""
    return torch.flip(torch.transpose(voxels, 1, 2), dims=(1,))


def _shear_steps(plane, theta, center):
    u, v = plane
    t2 = -torch.tan(theta * 0.5)
    sn = torch.sin(theta)
    zero, one = torch.zeros_like(t2), torch.ones_like(t2)

    def shear(axis, other, slope):
        coeffs = [zero, zero, zero, -slope * center]
        coeffs[axis] = one
        coeffs[other] = slope
        return ("interp", axis, coeffs, _TAPS_SHEAR)

    return [shear(u, v, t2), shear(v, u, sn), shear(u, v, t2)]


_QTURN_LIN = {
    (0, 2): [[[1, 0, 0], [0, 1, 0], [0, 0, 1]], [[0, 0, -1], [0, 1, 0], [1, 0, 0]],
             [[-1, 0, 0], [0, 1, 0], [0, 0, -1]], [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]],
    (0, 1): [[[1, 0, 0], [0, 1, 0], [0, 0, 1]], [[0, -1, 0], [1, 0, 0], [0, 0, 1]],
             [[-1, 0, 0], [0, -1, 0], [0, 0, 1]], [[0, 1, 0], [-1, 0, 0], [0, 0, 1]]],
}


def _qturn_matrix(plane, k: torch.Tensor, new_size: int) -> torch.Tensor:
    lin = torch.tensor(_QTURN_LIN[plane], dtype=torch.float32, device=k.device)[k]
    c = torch.full((3,), (new_size - 1) / 2.0, dtype=torch.float32, device=k.device)
    trans = c[None] - (lin * c[None, None, :]).sum(-1)
    m = torch.eye(4, dtype=torch.float32, device=k.device).repeat(k.shape[0], 1, 1)
    m[:, :3, :3] = lin
    m[:, :3, 3] = trans
    return m


def _split_quarter(theta: torch.Tensor):
    k = torch.round(theta / (math.pi / 2.0))
    r = theta - k * (math.pi / 2.0)
    return torch.remainder(k.to(torch.int64), 4), r


def compose_plan_matrix(steps: Sequence, new_size: int) -> torch.Tensor:
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


def build_pass_plan(view_params: torch.Tensor, size: int, new_size: int) -> List:
    """``("qturn", plane, k [B])`` turns and ``("interp", axis, coeffs [B, 4],
    taps)`` passes whose composition equals the pose's backward map with the
    source centred in the ``new_size`` cube."""
    azimuth = view_params[:, 0] - math.pi * 0.5
    elevation = view_params[:, 1]
    scale = view_params[:, 2]
    center = new_size / 2.0
    pad = (new_size - size) // 2
    kxz, rxz = _split_quarter(-azimuth)
    kxy, rxy = _split_quarter(elevation)
    steps: List = [("qturn", (0, 2), kxz)]
    steps += _shear_steps((0, 2), rxz, center)
    steps.append(("qturn", (0, 1), kxy))
    steps += _shear_steps((0, 1), rxy, center)
    target = grid_to_grid_matrix(view_params, size, new_size)
    t_target = target[:, :, 3] + float(pad)
    m_pre = compose_plan_matrix(steps, new_size)
    tau = torch.linalg.solve_ex(m_pre[:, :3, :3],
                                (t_target - m_pre[:, :3, 3])[..., None])[0][..., 0]
    inv_s = 1.0 / scale
    zero = torch.zeros_like(inv_s)
    for axis in range(3):
        coeffs = [zero, zero, zero, tau[:, axis]]
        coeffs[axis] = inv_s
        steps.append(("interp", axis, coeffs, _TAPS_SCALE))
    merged: List = []
    for step in steps:
        if (step[0] == "interp" and merged and merged[-1][0] == "interp"
                and merged[-1][1] == step[1]):
            axis = step[1]
            prev = merged[-1][2]
            a1 = prev[axis]
            rest = list(prev)
            rest[axis] = torch.zeros_like(a1)
            merged[-1] = ("interp", axis, [a1 * c2 + c1 for c2, c1 in zip(step[2], rest)],
                          max(merged[-1][3], step[3]))
        else:
            merged.append(step)
    return [("interp", s[1], torch.stack(s[2], -1), s[3]) if s[0] == "interp" else s
            for s in merged]


def interp_pass(vol: torch.Tensor, params: torch.Tensor, db: int,
                out_lanes: int | None = None) -> torch.Tensor:
    """One pass along the minor axis of ``vol`` ``[BC, R, L]``: lane ``l`` of
    row ``(d_a, d_b)`` samples at ``alpha l + c_a d_a + c_b d_b + delta``
    (float32 geometry), linear between the two neighbours, zero outside.
    The arithmetic runs in ``vol``'s dtype."""
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
    w = (pos - i0f).to(vol.dtype)
    i0 = torch.clamp(i0f, -2, lanes).to(torch.int64)
    m0 = ((i0 >= 0) & (i0 <= lanes - 1)).to(vol.dtype)
    m1 = ((i0 + 1 >= 0) & (i0 + 1 <= lanes - 1)).to(vol.dtype)
    g0 = torch.gather(vol, 2, torch.clamp(i0, 0, lanes - 1))
    g1 = torch.gather(vol, 2, torch.clamp(i0 + 1, 0, lanes - 1))
    return (1.0 - w) * g0 * m0 + w * g1 * m1


def _qturn_swap(vol, plane, k):
    a0, a1 = (0, 2) if plane == (0, 2) else (1, 2)
    odd = (k % 2) == 1
    swapped = torch.transpose(vol, a0 + 1, a1 + 1)
    vol = torch.where(odd[:, None, None, None], swapped, vol)
    return vol, (a0, (k == 1) | (k == 2)), (a1, (k == 2) | (k == 3))


def rotate_resample(voxels: torch.Tensor, view_params: torch.Tensor, new_size: int,
                    crop_windows: dict | None = None, dtype=torch.float32,
                    quant=None) -> torch.Tensor:
    """``[B, S, S, S, C] -> [B, N, N, N, C]`` through the pass plan, the data
    in ``dtype``; ``crop_windows`` ``{axis: (start, size)}`` emits only that
    window of an axis from its last pass. ``quant``: applied to each pass's
    output (the control's lower precision)."""
    b, s1, s2, s3, c = voxels.shape
    n = new_size
    dev = voxels.device
    view_params = view_params.to(torch.float32)
    vol = voxels.to(dtype).movedim(-1, 1).reshape(b * c, s1, s2, s3)
    pad = (n - s1) // 2
    vol = F.pad(vol, (pad, n - s1 - pad) * 3)
    steps = build_pass_plan(view_params, s1, n)
    crop_windows = dict(crop_windows or {})
    last_interp = {step[1]: i for i, step in enumerate(steps) if step[0] == "interp"}
    started, flipped = {}, {}

    def per_c(x):
        return torch.repeat_interleave(x, c, dim=0) if c > 1 else x

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
        alpha, delta = coeffs[:, axis], coeffs[:, 3]
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
            f = flipped.pop(axis)
            alpha = torch.where(f, -alpha, alpha)
            ca = torch.where(f, -ca, ca)
            cb = torch.where(f, -cb, cb)
            delta = torch.where(f, float(lanes - 1) - delta, delta)
        params = torch.stack([alpha, ca, cb, delta], dim=-1)
        vol = interp_pass(vol.reshape(b * c, da * db, lanes), params, db, out_lanes)
        if quant is not None:
            vol = quant(vol)
        vol = vol.reshape(b * c, da, db, -1)
    vol = to_canonical(vol, axes)
    _, d1, d2, d3 = vol.shape
    return vol.reshape(b, c, d1, d2, d3).movedim(1, -1)


def camera_warp(voxels: torch.Tensor, view_params: torch.Tensor, new_size: int,
                offsets: Tuple[int, int] | None = None, patch: int | None = None,
                dtype=torch.float32, quant=None) -> torch.Tensor:
    """The camera-aligned grid ``[B, N, N, N, C]``, or with ``offsets`` (u0,
    v0) the ``patch`` x ``patch`` window of its image-aligned rows and
    columns, emitted by the last pass of each cropped axis."""
    windows = None
    if offsets is not None:
        u0, v0 = (float(o) for o in offsets)
        windows = {1: (float(new_size - patch) - u0, patch), 2: (v0, patch)}
    return voxel_to_image_axes(rotate_resample(voxels, view_params, new_size, windows, dtype,
                                               quant))
