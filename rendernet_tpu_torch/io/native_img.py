"""ctypes binding to the native PNG decoder (``native/imgio.cc``).

Counterpart of ``rendernet_tpu/io/native_img.py``, with the same
prototypes. ``decode_png(buf)`` returns an HW / HWC uint8 array, or None
when the library is not available or the image is outside its envelope
(16-bit, palette, interlaced, not a PNG); ``utils.image.decode_image`` then
takes the pure-Python decoder. The C call releases the GIL, so the
prefetch thread decodes while the training loop dispatches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from rendernet_tpu_torch.io._native_load import NativeLoader

__all__ = ["available", "decode_png"]


def _setup(lib: ctypes.CDLL) -> None:
    lib.imgio_png_probe.restype = ctypes.c_int
    lib.imgio_png_probe.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32),
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.imgio_png_decode.restype = ctypes.c_int
    lib.imgio_png_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                                     ctypes.c_int64]


_loader = NativeLoader("imgio.cc", _setup, libs=("-lz",))


def available() -> bool:
    return _loader.available()


def error() -> Optional[str]:
    """Why the native decoder is not available, if it is not."""
    return _loader.error()


def decode_png(buf: bytes) -> Optional[np.ndarray]:
    """Decode PNG bytes to uint8 HW (grey) / HWC; None if unsupported."""
    lib = _loader.load()
    if lib is None:
        return None
    w, h, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    if lib.imgio_png_probe(buf, len(buf), ctypes.byref(w), ctypes.byref(h),
                           ctypes.byref(c)) != 0:
        return None
    out = np.empty((h.value, w.value, c.value), np.uint8)
    if lib.imgio_png_decode(buf, len(buf), out.ctypes.data_as(ctypes.c_void_p), out.nbytes):
        return None
    return out[:, :, 0] if c.value == 1 else out
