"""Host-side Phong compositing for the render CLI (numpy).

Counterpart of the numpy mirrors in ``rendernet_tpu/ops/phong.py``
(``np_phong_composite``, ``np_generate_light_pos``), which follow
tools/Phong_shading.py:202-228,247-253 of the reference.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["np_phong_composite", "np_generate_light_pos"]


def _np_sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def np_phong_composite(images, light_dir, light_col, ambient, k_diffuse):
    """Diffuse N.L shading of a normal map (normals = image - 0.5) over a
    black background, with the reference's soft background mask (the JAX
    function's defaults: ``background_col="black"``, ``with_mask=True``)."""
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
