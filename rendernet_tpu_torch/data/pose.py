"""Filename <-> pose parameter conventions (pure Python + numpy).

The port's own copy of ``rendernet_tpu/data/pose.py``. Training images
encode their camera pose in the filename as
``..._p{azimuth}_t{theta}_r{radius}...`` (``tools/data_util.py:13-29,
110-118``):

  * azimuth_rad = azimuth_deg * pi/180
  * elevation_rad = (90 - theta_deg) * pi/180
  * scale = 3.3 / radius  (radius read as a fixed 3-character field)
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["pose_from_name", "pose_to_name_suffix", "name_to_param"]


def pose_from_name(name: str) -> np.ndarray:
    """(azimuth, elevation, scale) in radians / ratio, float32, from a name."""
    pi = name.find("_p")
    ti = name.find("_t")
    ri = name.find("_r")
    azimuth = float(name[pi + 2: ti]) * math.pi / 180.0
    scale = 3.3 / float(name[ri + 2: ri + 5])
    elevation = (90.0 - float(name[ti + 2: ri])) * math.pi / 180.0
    return np.array([azimuth, elevation, scale], dtype=np.float32)


def pose_to_name_suffix(azimuth_deg: float, theta_deg: float, radius: float = 3.3) -> str:
    """Inverse of :func:`pose_from_name`; ``radius`` must format to exactly
    3 characters (e.g. 3.3 -> "3.3")."""
    r = f"{radius:.1f}"
    if len(r) != 3:
        raise ValueError(f"radius must format to 3 chars, got {r!r}")
    return f"_p{azimuth_deg:g}_t{theta_deg:g}_r{r}"


def name_to_param(model_names) -> np.ndarray:
    """Batch 2-param variant (``tools/model_util.py:60-74``): name fields 4
    and 5 scaled by 15 degrees."""
    params = np.zeros([len(model_names), 2], np.float32)
    for i, name in enumerate(model_names):
        content = name.split("_")
        params[i, 0] = float(content[4]) * 15.0 * math.pi / 180.0
        params[i, 1] = float(content[5]) * 15.0 * math.pi / 180.0
    return params
