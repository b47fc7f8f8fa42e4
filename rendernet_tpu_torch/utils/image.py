"""Host-side image saving, counterpart of ``rendernet_tpu/utils/image.py``.

PNGs are encoded with the standard library (zlib) so that rendering needs
no imaging package; GIF sweeps use PIL, imported only when asked for.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

__all__ = ["to_uint8", "encode_png", "save_image", "save_gif"]


def to_uint8(img: np.ndarray, scale: Optional[float] = None) -> np.ndarray:
    """Clip to [0, 255] uint8; ``scale`` multiplies first (e.g. 255 for [0,1])."""
    img = np.asarray(img)
    if scale is not None:
        img = img * scale
    return np.clip(img, 0, 255).astype(np.uint8)


def _as_uint8(img) -> np.ndarray:
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr, scale=255.0 if arr.max() <= 1.5 else None)
    return np.squeeze(arr)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """Encode an HW (grey) or HW3/HW4 array as 8-bit PNG bytes; floats in
    [0, 1] are rescaled."""
    arr = _as_uint8(img)
    if arr.ndim == 2:
        color = 0
        arr = arr[:, :, None]
    elif arr.ndim == 3 and arr.shape[2] in (3, 4):
        color = 2 if arr.shape[2] == 3 else 6
    else:
        raise ValueError(f"cannot encode an image of shape {arr.shape} as PNG")
    h, w = arr.shape[:2]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, -1)], axis=1
    )  # filter type 0 per row
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_image(img: np.ndarray, path: str) -> None:
    """Save an array as a PNG file; floats in [0, 1] are rescaled."""
    with open(path, "wb") as f:
        f.write(encode_png(img))


def save_gif(frames, path: str, fps: float = 12.0) -> None:
    """Save a sequence of HW/HWC frames as an animated GIF (needs PIL)."""
    from PIL import Image

    imgs = [Image.fromarray(_as_uint8(f)) for f in frames]
    imgs[0].save(
        path, save_all=True, append_images=imgs[1:],
        duration=int(1000 / fps), loop=0,
    )
