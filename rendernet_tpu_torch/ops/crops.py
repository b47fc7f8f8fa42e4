"""Synchronized random and center crops for patch training.

Counterpart of ``rendernet_tpu/ops/crops.py``. Crops are spatial
(H, W) only; the depth axis is never cropped (the projection unit needs full
depth). Image crops are the voxel crop scaled by ``image_dim // voxel_dim``.
The offsets are plain Python ints drawn from a ``torch.Generator`` on the
host, so a crop is a slice and costs the device nothing; the JAX package
draws them from a ``jax.random`` key, so the two packages crop at different
places from one seed, and tests hand both the same offsets.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "random_crop_offsets",
    "crop_voxel",
    "crop_image",
    "random_crop_voxel_image",
    "random_crop_voxel_texture_image",
    "random_crop_voxel_texture_image_normal",
    "center_crop_voxel_image",
    "center_crop_voxel",
    "center_crop_image",
    "center_pad_cube",
]


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
               factor: int, rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Crop ``[B, H, W, C]`` images at voxel ``offsets`` scaled by ``factor``.
    ``rows`` = (r0, r1): only the crop's image rows for the patch rows [r0,
    r1) (a rank's slab under spatial sharding), ``factor * (u0 + r0)`` to
    ``factor * (u0 + r1)``."""
    u, v = (int(o) * factor for o in offsets)
    p = patch_size * factor
    r0, r1 = (0, patch_size) if rows is None else rows
    return images[:, u + factor * r0:u + factor * r1, v:v + p]


def _random_crop(generator: torch.Generator, voxel_grids, image_grids, patch_size: int):
    """Crop every voxel grid and every image of one sample set at the same
    random offsets (``crops.py:72-147``); unchanged at full size."""
    voxel_dim = voxel_grids[0].shape[1]
    if patch_size == voxel_dim:
        return tuple(voxel_grids) + tuple(image_grids)
    factor = image_grids[0].shape[1] // voxel_dim
    offsets = random_crop_offsets(generator, voxel_dim, patch_size)
    return (tuple(crop_voxel(v, offsets, patch_size) for v in voxel_grids)
            + tuple(crop_image(i, offsets, patch_size, factor) for i in image_grids))


def random_crop_voxel_image(generator: torch.Generator, voxels: torch.Tensor,
                            images: torch.Tensor, patch_size: int):
    """A synchronized random (voxel, image) crop."""
    return _random_crop(generator, (voxels,), (images,), patch_size)


def random_crop_voxel_texture_image(generator: torch.Generator, voxels: torch.Tensor,
                                    texture: torch.Tensor, images: torch.Tensor,
                                    patch_size: int):
    """A synchronized random (voxel, texture grid, image) crop."""
    return _random_crop(generator, (voxels, texture), (images,), patch_size)


def random_crop_voxel_texture_image_normal(generator: torch.Generator, voxels: torch.Tensor,
                                           texture: torch.Tensor, images: torch.Tensor,
                                           normals: torch.Tensor, patch_size: int):
    """A synchronized random (voxel, texture grid, image, normal map) crop."""
    return _random_crop(generator, (voxels, texture), (images, normals), patch_size)


def center_crop_voxel(voxels: torch.Tensor, patch_size: int) -> torch.Tensor:
    """The central ``patch_size`` x ``patch_size`` (H, W) window."""
    start = voxels.shape[1] // 2 - patch_size // 2
    return voxels[:, start:start + patch_size, start:start + patch_size]


def center_crop_image(images: torch.Tensor, patch_size: int) -> torch.Tensor:
    """The central ``patch_size`` x ``patch_size`` window of ``[B, H, W, C]``."""
    start = images.shape[1] // 2 - patch_size // 2
    return images[:, start:start + patch_size, start:start + patch_size]


def center_crop_voxel_image(voxels: torch.Tensor, images: torch.Tensor, patch_size: int):
    """Central (voxel, image) crops, the image's scaled by ``image_dim //
    voxel_dim``."""
    factor = images.shape[1] // voxels.shape[1]
    return center_crop_voxel(voxels, patch_size), center_crop_image(images, patch_size * factor)


def center_pad_cube(voxels: np.ndarray) -> np.ndarray:
    """Zero-pad a dense host array to a cube, centred (``crops.py:150-156``)."""
    cube = max(voxels.shape)
    before = [(cube - e) // 2 for e in voxels.shape]
    after = [cube - e - b for e, b in zip(voxels.shape, before)]
    return np.pad(voxels, list(zip(before, after)), "constant")
