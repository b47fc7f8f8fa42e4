"""Pose matrices and voxel-grid axis transforms (PyTorch).

Counterpart of ``rendernet_tpu/ops/transforms.py:31-140`` (the pose matrix,
the grid-to-grid backward map, the camera axis alignment and the
silhouette). Everything runs
in float32 on the device of ``view_params``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["rotation_around_grid_centroid", "grid_to_grid_matrix", "voxel_to_image_axes",
           "image_to_voxel_axes", "silhouette"]


def rotation_around_grid_centroid(view_params: torch.Tensor) -> torch.Tensor:
    """``[B, 2|3]`` (azimuth, elevation[, scale]) in radians ->
    ``[B, 4, 4]`` = ``Scale @ Rz(elevation) @ Ry(azimuth - pi/2)``."""
    view_params = torch.as_tensor(view_params, dtype=torch.float32)
    azimuth = view_params[:, 0] - math.pi * 0.5
    elevation = view_params[:, 1]
    ca, sa = torch.cos(azimuth), torch.sin(azimuth)
    ce, se = torch.cos(elevation), torch.sin(elevation)
    zeros = torch.zeros_like(ca)
    ones = torch.ones_like(ca)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    rot_y = mat([[ca, zeros, -sa, zeros], [zeros, ones, zeros, zeros],
                 [sa, zeros, ca, zeros], [zeros, zeros, zeros, ones]])
    rot_z = mat([[ce, se, zeros, zeros], [-se, ce, zeros, zeros],
                 [zeros, zeros, ones, zeros], [zeros, zeros, zeros, ones]])
    m = torch.matmul(rot_z, rot_y)  # float32; TF32 stays off for matmuls
    if view_params.shape[1] >= 3:
        scale = view_params[:, 2]
        s = torch.stack([scale, scale, scale, torch.ones_like(scale)], dim=-1)
        m = s[:, :, None] * m
    return m


def grid_to_grid_matrix(
    view_params: torch.Tensor, size: int = 64, new_size: int = 128
) -> torch.Tensor:
    """``[B, 3, 4]`` backward map from destination-grid indices (x, y, z, 1)
    to source coordinates, inverted in closed form (R is orthogonal times
    scale)."""
    view_params = torch.as_tensor(view_params, dtype=torch.float32)
    r = rotation_around_grid_centroid(view_params)[:, :3, :3]
    if view_params.shape[1] >= 3:
        scale = view_params[:, 2][:, None, None]
        r_inv = torch.transpose(r / scale, 1, 2) / scale
    else:
        r_inv = torch.transpose(r, 1, 2)
    t = -(new_size * 0.5) * torch.sum(r_inv, dim=2) + size * 0.5
    return torch.cat([r_inv, t[:, :, None]], dim=2)


def voxel_to_image_axes(voxels: torch.Tensor) -> torch.Tensor:
    """``[B, A1, A2, D, C]``: swap axes 1 and 2, then flip the new axis 1."""
    return torch.flip(torch.transpose(voxels, 1, 2), dims=(1,))


def image_to_voxel_axes(voxels: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`voxel_to_image_axes` (``transforms.py:130``)."""
    return torch.transpose(torch.flip(voxels, dims=(1,)), 1, 2)


def silhouette(voxels: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Max-projection along the depth axis: ``[B, H, W, D, C]`` ->
    ``[B, H, W, C]``."""
    return torch.amax(voxels, dim=axis)
