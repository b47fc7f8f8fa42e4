"""Exact trilinear affine voxel resampling (PyTorch), the CLI's default
``--resample exact`` path and the training step's path on the CPU.

Counterpart of ``rendernet_tpu/ops/resample.py:47-190``: backward-warp a
destination grid through a per-sample affine matrix and trilinearly
interpolate the source grid. A point whose floor falls outside ``[0, S-2]``
on any axis contributes zero (the reference's clamped-corner semantics).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from rendernet_tpu_torch.ops.halo import pad_rows
from rendernet_tpu_torch.ops.transforms import grid_to_grid_matrix, voxel_to_image_axes

__all__ = [
    "trilinear_gather",
    "affine_resample",
    "rotate_resample",
    "rotate_resample_to_camera",
    "rotate_resample_camera_patch",
]


def trilinear_gather(
    voxels: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, zs: torch.Tensor
) -> torch.Tensor:
    """Sample ``voxels[b, z, y, x]`` (``[B, S1, S2, S3, C]``) at fractional
    coordinates ``xs/ys/zs`` (``[B, ...]``); returns ``[B, ..., C]``."""
    b, s1, s2, s3, c = voxels.shape
    coord_shape = xs.shape[1:]
    xs, ys, zs = (t.reshape(b, -1) for t in (xs, ys, zs))
    x0f, y0f, z0f = torch.floor(xs), torch.floor(ys), torch.floor(zs)
    fx, fy, fz = xs - x0f, ys - y0f, zs - z0f
    valid = (
        (x0f >= 0) & (x0f <= s3 - 2)
        & (y0f >= 0) & (y0f <= s2 - 2)
        & (z0f >= 0) & (z0f <= s1 - 2)
    ).to(voxels.dtype)
    x0 = torch.clamp(x0f.long(), 0, s3 - 2)
    y0 = torch.clamp(y0f.long(), 0, s2 - 2)
    z0 = torch.clamp(z0f.long(), 0, s1 - 2)
    flat = voxels.reshape(b, s1 * s2 * s3, c)
    base = (z0 * s2 + y0) * s3 + x0

    def corner(dz: int, dy: int, dx: int) -> torch.Tensor:
        idx = base + (dz * s2 + dy) * s3 + dx
        return torch.gather(flat, 1, idx[:, :, None].expand(-1, -1, c))

    fx = (fx * valid)[:, :, None]
    fy = (fy * valid)[:, :, None]
    fz = (fz * valid)[:, :, None]
    gx = (valid - fx[:, :, 0])[:, :, None]
    gy = (valid - fy[:, :, 0])[:, :, None]
    gz = (valid - fz[:, :, 0])[:, :, None]
    c00 = corner(0, 0, 0) * gx + corner(0, 0, 1) * fx
    c01 = corner(0, 1, 0) * gx + corner(0, 1, 1) * fx
    c10 = corner(1, 0, 0) * gx + corner(1, 0, 1) * fx
    c11 = corner(1, 1, 0) * gx + corner(1, 1, 1) * fx
    c0 = c00 * gy + c01 * fy
    c1 = c10 * gy + c11 * fy
    out = c0 * gz + c1 * fz
    return out.reshape(b, *coord_shape, c)


def _dst_coords(
    matrix: torch.Tensor, out_size: Tuple[int, int, int]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Source coordinates of ``out[b, i, j, k]`` at (x=k, y=j, z=i),
    broadcast from three index vectors (no meshgrid)."""
    d1, d2, d3 = out_size
    dev = matrix.device
    ii = torch.arange(d1, dtype=torch.float32, device=dev)[None, :, None, None]
    jj = torch.arange(d2, dtype=torch.float32, device=dev)[None, None, :, None]
    kk = torch.arange(d3, dtype=torch.float32, device=dev)[None, None, None, :]

    def row(r: int) -> torch.Tensor:
        m = matrix[:, r, :, None, None, None]
        return m[:, 0] * kk + m[:, 1] * jj + m[:, 2] * ii + m[:, 3]

    return row(0), row(1), row(2)


def affine_resample(
    voxels: torch.Tensor, matrix: torch.Tensor, out_size: Sequence[int]
) -> torch.Tensor:
    """Backward-warp ``voxels`` through ``matrix`` ``[B, 3, 4]`` into an
    ``out_size`` grid: ``[B, *out_size, C]``."""
    xs, ys, zs = _dst_coords(matrix, tuple(out_size))
    return trilinear_gather(voxels, xs, ys, zs)


def rotate_resample(
    voxels: torch.Tensor,
    view_params: torch.Tensor,
    size: int | None = None,
    new_size: int = 128,
) -> torch.Tensor:
    """Rotate (+scale) a ``[B, S, S, S, C]`` grid into a ``new_size`` grid;
    pose ``[B, 2|3]`` = (azimuth, elevation[, scale]) in radians."""
    if size is None:
        size = voxels.shape[1]
    matrix = grid_to_grid_matrix(view_params, size=size, new_size=new_size)
    return affine_resample(voxels, matrix, (new_size,) * 3)


def rotate_resample_to_camera(
    voxels: torch.Tensor,
    view_params: torch.Tensor,
    size: int | None = None,
    new_size: int = 128,
) -> torch.Tensor:
    """Rotate+resample, then align axes to image row/column order."""
    return voxel_to_image_axes(rotate_resample(voxels, view_params, size, new_size))


def rotate_resample_camera_patch(
    voxels: torch.Tensor,
    view_params: torch.Tensor,
    offsets: Sequence[int],
    patch_size: int,
    size: int | None = None,
    new_size: int = 128,
    rows: Tuple[int, int] | None = None,
) -> torch.Tensor:
    """Crop-fused resample (``resample.py:190``): equals
    ``rotate_resample_to_camera(...)[:, u0:u0+P, v0:v0+P]`` but gathers only
    the window. ``offsets`` = (u0, v0), the crop starts in the image-aligned
    (row, col) axes; depth is never cropped. ``rows`` = (r0, r1): only the
    patch's rows [r0, r1) (a rank's slab and its halo under spatial
    sharding); rows outside [0, P) are zeros, where SAME padding puts them."""
    if size is None:
        size = voxels.shape[1]
    r0, r1 = (0, patch_size) if rows is None else rows
    c0, c1 = max(r0, 0), min(r1, patch_size)
    matrix = grid_to_grid_matrix(view_params, size=size, new_size=new_size)
    # The image-aligned grid G[b, u, v, d] is the raw resample out[b, i, j, k]
    # at (i = v, j = new_size - 1 - u, k = d) (voxel_to_image_axes), so the
    # window's destination points are generated in G's index order.
    dev = matrix.device
    u = int(offsets[0]) + torch.arange(c0, c1, device=dev)
    v = int(offsets[1]) + torch.arange(patch_size, device=dev)
    xk = torch.arange(new_size, dtype=torch.float32, device=dev)[None, None, None, :]
    yj = (float(new_size - 1) - u.to(torch.float32))[None, :, None, None]
    zi = v.to(torch.float32)[None, None, :, None]

    def row(r: int) -> torch.Tensor:
        m = matrix[:, r, :, None, None, None]
        return m[:, 0] * xk + m[:, 1] * yj + m[:, 2] * zi + m[:, 3]

    return pad_rows(trilinear_gather(voxels, row(0), row(1), row(2)), c0 - r0, r1 - c1, 1)
