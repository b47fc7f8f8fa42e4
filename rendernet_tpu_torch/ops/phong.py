"""Phong shading: the differentiable half in PyTorch, and the host-side
compositing of the CLIs in numpy.

Counterpart of ``rendernet_tpu/ops/phong.py``, which follows
tools/Phong_shading.py of the reference. The torch functions shade a
normal-map batch (normals encoded as ``img - 0.5``) with a diffuse N.L
term, soft background masks and an ambient/composite step, batch-native
and differentiable in the normals and in the light's azimuth (the inverse
renderer's light variable). Their max/min/clip are written with
``torch.maximum`` / ``torch.minimum``, which split the gradient 0.5/0.5 at
a tie as ``jnp.maximum`` / ``jnp.clip`` do (``torch.clamp`` would pass all
of it): a white-background pixel composites to exactly 1.0, so recon's
gradients sit on that tie. The ``np_*`` mirrors serve the render and
reconstruct CLIs (tools/Phong_shading.py:202-228,247-253).
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "mask_black_background",
    "mask_white_background",
    "phong_shading",
    "phong_composite",
    "generate_light_pos",
    "np_phong_composite",
    "np_generate_light_pos",
]

_SQRT3 = math.sqrt(3.0)


def _sigmoid(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0, 1)`` with its gradient at the bounds."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def mask_black_background(images: torch.Tensor) -> torch.Tensor:
    """Soft foreground mask for images on a black background ([0, 1] input)."""
    norm = torch.linalg.vector_norm(images, dim=3, keepdim=True)
    return _sigmoid(255.0 * norm - 80.0)


def mask_white_background(images: torch.Tensor) -> torch.Tensor:
    """Soft foreground mask for images on a white background ([0, 1] input)."""
    norm = _SQRT3 - torch.linalg.vector_norm(images, dim=3, keepdim=True)
    return _sigmoid(255.0 * norm - 80.0)


def phong_shading(images: torch.Tensor, light_dir: torch.Tensor, light_col: torch.Tensor,
                  k_diffuse: float) -> torch.Tensor:
    """Diffuse N.L shading of ``[B, H, W, 3]`` normal maps in [0, 1] under
    ``[B, 3]`` lights; returns ``[B, H, W, 3]`` clipped to [0, 1]."""
    normals = images - 0.5
    normals = normals / torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    light_dir = light_dir / torch.linalg.vector_norm(light_dir, dim=-1, keepdim=True)
    diffuse = torch.sum(normals * light_dir[:, None, None, :], dim=-1, keepdim=True)
    diffuse = torch.maximum(diffuse, diffuse.new_zeros(()))
    return _clip01(k_diffuse * diffuse * light_col[:, None, None, :])


def phong_composite(images: torch.Tensor, light_dir: torch.Tensor, light_col: torch.Tensor,
                    ambient: float, k_diffuse: float, black_background: bool = False,
                    with_mask: bool = True) -> torch.Tensor:
    """``mask * (ambient + diffuse) + (1 - mask)`` clipped to [0, 1]: the
    background stays white."""
    diffuse = phong_shading(images, light_dir, light_col, k_diffuse)
    if with_mask:
        mask = (mask_black_background(images) if black_background
                else mask_white_background(images))
        compos = mask * (ambient + diffuse) + (1.0 - mask)
    else:
        compos = ambient + diffuse
    return _clip01(compos)


def generate_light_pos(light_azimuth: torch.Tensor, light_elevation: float,
                       batch_size: int) -> torch.Tensor:
    """Spherical -> cartesian light position, z up; differentiable in the
    ``[B, 1]`` azimuth (radians); ``light_elevation`` a scalar in radians."""
    elev = torch.full((batch_size, 1), light_elevation, dtype=torch.float32,
                      device=light_azimuth.device)
    x = torch.sin(elev) * torch.cos(light_azimuth)
    y = torch.sin(elev) * torch.sin(light_azimuth)
    z = torch.cos(elev)
    return torch.cat([x, y, z], dim=1)


# ---------------------------------------------------------------------------
# numpy mirrors (host-side compositing for the CLIs)
# ---------------------------------------------------------------------------
def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def np_phong_composite(images, light_dir, light_col, ambient, k_diffuse,
                       background_col: str = "black", with_mask: bool = True):
    """Diffuse N.L shading of a normal map (normals = image - 0.5) in
    float64, with the reference's soft background mask: on black, bias 150
    on the norm of the image; on white, bias 80 on the norm of 1 - image."""
    images = np.asarray(images, np.float64)
    normals = images - 0.5
    normals = normals / np.linalg.norm(normals, axis=-1, keepdims=True)
    light_dir = np.asarray(light_dir, np.float64)
    light_dir = light_dir / np.linalg.norm(light_dir, axis=-1, keepdims=True)
    diffuse = np.sum(normals * light_dir[:, None, None, :], axis=-1, keepdims=True)
    diffuse = np.maximum(diffuse, 0.0)
    diffuse = np.clip(
        k_diffuse * diffuse * np.asarray(light_col)[:, None, None, :], 0.0, 1.0
    )
    if not with_mask:
        return np.clip(ambient + diffuse, 0.0, 1.0)
    if background_col.lower() != "black":
        mask = _np_sigmoid(255.0 * np.linalg.norm(1.0 - images, axis=3, keepdims=True) - 80.0)
    else:
        mask = _np_sigmoid(255.0 * np.linalg.norm(images, axis=3, keepdims=True) - 150.0)
    return np.clip(mask * (ambient + diffuse) + (1.0 - mask), 0.0, 1.0)


def np_generate_light_pos(elevation: float = 90, azimuth: float = 90) -> np.ndarray:
    """Y-up light position from degrees (the demo CLI's convention)."""
    el = np.array([[elevation]]) * math.pi / 180.0
    az = np.array([[azimuth]]) * math.pi / 180.0
    x = -np.sin(el) * np.cos(az)
    y = np.cos(el)
    z = -np.sin(el) * np.sin(az)
    return np.hstack((x, y, z))
