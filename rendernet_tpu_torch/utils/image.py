"""Host-side image encode/decode/save, counterpart of
``rendernet_tpu/utils/image.py``.

PNGs are encoded with the standard library (zlib), so that rendering and
reconstruction need no imaging package; GIF sweeps use PIL, imported only
when asked for. :func:`decode_image` takes the native decoder
(``native/imgio.cc`` through ``io/native_img.py``) where it builds, as the
JAX package's does (``image.py:26-35``), and otherwise the pure-Python one
below, whose average and Paeth filters run byte by byte (seconds for a
512x512 RGB image that PIL wrote); :data:`decoded_by` counts which one ran.
"""
from __future__ import annotations

import struct
import zlib
from collections import Counter
from typing import Optional

import numpy as np

__all__ = ["to_uint8", "encode_png", "decode_image", "decode_png_python", "save_image",
           "save_gif", "decoded_by"]

# Images decoded by each decoder ("native", "python") since import.
decoded_by: Counter = Counter()


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


_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (none, sub, up, average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ftype = data[pos]
        row = np.frombuffer(data, np.uint8, stride, pos + 1)
        pos += 1 + stride
        if ftype == 0:
            cur = row.copy()
        elif ftype == 1:  # sub: a running sum per sample, modulo 256
            cur = (np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.int64) % 256).astype(
                np.uint8).reshape(-1)
        elif ftype == 2:
            cur = row + prior
        elif ftype in (3, 4):  # average / Paeth: byte by byte, left to right
            cur = bytearray(row.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    cur[x] = (cur[x] + ((a + up[x]) >> 1)) & 0xFF
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    cur[x] = (cur[x] + _paeth(a, up[x], c)) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"bad PNG filter type {ftype} in row {y}")
        out[y] = cur
        prior = out[y]
    return out


def decode_image(buf: bytes) -> np.ndarray:
    """Decode PNG bytes to an HW (grey) or HWC uint8 array: the native
    decoder where it builds and takes the image, else
    :func:`decode_png_python`."""
    from rendernet_tpu_torch.io import native_img

    img = native_img.decode_png(buf)
    if img is not None:
        decoded_by["native"] += 1
        return img
    decoded_by["python"] += 1
    return decode_png_python(buf)


def decode_png_python(buf: bytes) -> np.ndarray:
    """Decode PNG bytes to an HW (grey) or HWC (grey+alpha, RGB, RGBA) uint8
    array in pure Python: 8-bit, non-interlaced, every filter type (what
    ``encode_png`` and common PNG writers produce). Raises on anything
    else."""
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        body = buf[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace} (8-bit grey/RGB/RGBA, not interlaced)")
    ch = _CHANNELS[color]
    data = zlib.decompress(b"".join(idat))
    if len(data) != h * (1 + w * ch):
        raise ValueError("PNG image data has the wrong size")
    img = _unfilter(data, h, w * ch, ch).reshape(h, w, ch)
    return img[:, :, 0] if ch == 1 else img


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
