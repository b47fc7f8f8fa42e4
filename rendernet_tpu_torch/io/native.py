"""ctypes binding to the native binvox codec (``native/voxio.cc``).

Counterpart of ``rendernet_tpu/io/native.py``, with the same prototypes:
binvox RLE decode / encode and a threaded float32 batch decoder. The
library builds at first use (``io/_native_load.py``); ``available()`` is
False where it cannot, and callers fall back to the numpy codec in
``io/binvox.py``.
"""
from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np

from rendernet_tpu_torch.io._native_load import NativeLoader

__all__ = ["available", "decode", "decode_header", "encode", "decode_batch"]


def _setup(lib: ctypes.CDLL) -> None:
    lib.voxio_header.restype = ctypes.c_int
    lib.voxio_decode.restype = ctypes.c_int
    lib.voxio_encode.restype = ctypes.c_int64
    lib.voxio_decode_batch_f32.restype = ctypes.c_int


_loader = NativeLoader("voxio.cc", _setup)


def _lib() -> ctypes.CDLL:
    lib = _loader.load()
    if lib is None:
        raise RuntimeError(f"native voxio unavailable: {_loader.error()}")
    return lib


def available() -> bool:
    return _loader.available()


def decode_header(buf: bytes) -> Tuple[Tuple[int, int, int], Tuple[float, ...], float]:
    lib = _lib()
    dims = (ctypes.c_int32 * 3)()
    trans = (ctypes.c_double * 3)()
    scale = ctypes.c_double()
    rc = lib.voxio_header(buf, len(buf), dims, trans, ctypes.byref(scale))
    if rc:
        raise ValueError(f"binvox header parse failed (status {rc})")
    return tuple(dims), tuple(trans), scale.value


def decode(buf: bytes) -> np.ndarray:
    """Decode one binvox byte string to a dense bool array (xyz order)."""
    lib = _lib()
    (d1, d2, d3), _, _ = decode_header(buf)
    out = np.empty(d1 * d2 * d3, np.uint8)
    rc = lib.voxio_decode(buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          out.size)
    if rc:
        raise ValueError(f"binvox decode failed (status {rc})")
    return out.reshape(d1, d3, d2).astype(bool)


def encode(grid: np.ndarray, translate=(0.0, 0.0, 0.0), scale: float = 1.0) -> bytes:
    """Encode a dense (xyz-order) grid as binvox bytes."""
    lib = _lib()
    grid = np.ascontiguousarray(grid, np.uint8)
    d1, dy, dz = grid.shape
    cap = 300 + 2 * grid.size + 2
    out = np.empty(cap, np.uint8)
    trans = (ctypes.c_double * 3)(*[float(t) for t in translate])
    n = lib.voxio_encode(grid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), d1, dz, dy,
                         trans, ctypes.c_double(float(scale)),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise ValueError("binvox encode buffer too small")
    return bytes(out[:n])


def decode_batch(buffers: List[bytes], dims: Tuple[int, int, int],
                 n_threads: int = 0) -> np.ndarray:
    """Threaded decode of many same-dims binvox buffers -> ``[N, d1, dy,
    dz]`` float32 occupancy."""
    lib = _lib()
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    blob = b"".join(buffers)
    offsets = np.zeros(len(buffers), np.int64)
    lengths = np.asarray([len(b) for b in buffers], np.int64)
    np.cumsum(lengths[:-1], out=offsets[1:])
    d1, d2, d3 = dims
    out = np.empty((len(buffers), d1, d3, d2), np.float32)
    rc = lib.voxio_decode_batch_f32(
        blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(buffers), d1, d2, d3,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if rc:
        raise ValueError(f"batch decode failed (status {rc})")
    return out
