"""Synchronized random crops for patch training.

Counterpart of ``rendernet_tpu/ops/crops.py:41-72``. Crops are spatial
(H, W) only; the depth axis is never cropped (the projection unit needs full
depth). Image crops are the voxel crop scaled by ``image_dim // voxel_dim``.
The offsets are plain Python ints drawn from a ``torch.Generator`` on the
host, so a crop is a slice and costs the device nothing; the JAX package
draws them from a ``jax.random`` key, so the two packages crop at different
places from one seed, and tests hand both the same offsets.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["random_crop_offsets", "crop_voxel", "crop_image"]


def random_crop_offsets(generator: torch.Generator, voxel_dim: int,
                        patch_size: int) -> Tuple[int, int]:
    """Two crop-start offsets, each uniform in ``[0, voxel_dim - patch_size]``."""
    off = torch.randint(0, voxel_dim - patch_size + 1, (2,), generator=generator)
    return int(off[0]), int(off[1])


def crop_voxel(voxels: torch.Tensor, offsets: Sequence[int], patch_size: int) -> torch.Tensor:
    """Crop ``[B, H, W, D, C]`` voxels at (H, W) ``offsets``."""
    u, v = (int(o) for o in offsets)
    return voxels[:, u:u + patch_size, v:v + patch_size]


def crop_image(images: torch.Tensor, offsets: Sequence[int], patch_size: int,
               factor: int) -> torch.Tensor:
    """Crop ``[B, H, W, C]`` images at voxel ``offsets`` scaled by ``factor``."""
    u, v = (int(o) * factor for o in offsets)
    p = patch_size * factor
    return images[:, u:u + p, v:v + p]
