"""Streaming TAR dataset archives (numpy, host side).

Counterpart of ``rendernet_tpu/io/tar_archive.py`` (which follows the
reference ``tools/utils.py:24-109``): each entry is a zlib-compressed
``.npy``, a ``.binvox`` or an encoded image; the reader dispatches on the
extension and pairs image entries with their binvox model by name.
"""
from __future__ import annotations

import io
import tarfile
import time
import zlib
from typing import Iterator, Optional, Tuple

import numpy as np

from rendernet_tpu_torch.io import binvox as binvox_rw
from rendernet_tpu_torch.utils.image import decode_image

PREFIX = "data/"
SUFFIX = ".npy.z"

__all__ = ["NpyTarWriter", "NpyTarReader", "derive_model_name"]


class NpyTarWriter:
    """Write numpy arrays into a tar stream as zlib-compressed .npy entries."""

    def __init__(self, fname: str):
        self.tfile = tarfile.open(fname, "w|")

    def add(self, arr: np.ndarray, name: str) -> None:
        sio = io.BytesIO()
        np.save(sio, arr)
        zbuf = zlib.compress(sio.getvalue())
        tinfo = tarfile.TarInfo(f"{PREFIX}{name}{SUFFIX}")
        tinfo.size = len(zbuf)
        tinfo.mtime = int(time.time())
        self.tfile.addfile(tinfo, io.BytesIO(zbuf))

    def close(self) -> None:
        self.tfile.close()

    def __enter__(self) -> "NpyTarWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def derive_model_name(entry_name: str) -> str:
    """The paired binvox model name of an image entry: ShapeNet entries
    ``model_<cls>_<idx>_..._p{az}_t{el}_r{radius}`` pair with
    ``<p0>_<p1>_<p2>_clean``; Basel-face entries ``ply<id>_...`` with
    ``ply<id>``."""
    parts = entry_name.split("_")
    if "ply" in parts[0]:
        return parts[0]
    return "_".join(parts[:3]) + "_clean"


class NpyTarReader:
    """Iterate (array, name) pairs out of a dataset tar stream:
    ``*.npy.z`` / ``*.npy`` -> the array; ``*.binvox`` -> (dense bool
    array, derived model name); ``*.png`` / ``*.jpg`` -> (float32 HW(C)
    image, entry stem). Undecodable images and other entries yield
    ``(None, None)``."""

    def __init__(self, fname: str):
        self.tfile = tarfile.open(fname, "r|*")

    def __iter__(self) -> Iterator[Tuple[Optional[np.ndarray], Optional[str]]]:
        return self

    def __next__(self):
        while True:
            entry = self.tfile.next()
            if entry is None:
                self.close()
                raise StopIteration()
            if not entry.isfile():
                continue
            fileobj = self.tfile.extractfile(entry)
            if fileobj is None:
                continue
            return self._decode(entry.name, fileobj.read())

    next = __next__

    def _decode(self, name: str, contents: bytes):
        components = name.split(".")
        if components[-1].lower() == "z":
            contents = zlib.decompress(contents)
            components.pop()
        ext = components[-1].lower()
        # Strip only the trailing extension(s): pose fields like "r3.3"
        # contain dots.
        stem = name.rsplit("/", 1)[-1]
        if stem.lower().endswith(".z"):
            stem = stem[:-2]
        if stem.lower().endswith("." + ext):
            stem = stem[: -(len(ext) + 1)]
        if ext == "npy":
            return np.load(io.BytesIO(contents)), stem
        if ext == "binvox":
            return binvox_rw.decode_bytes(contents), derive_model_name(stem)
        if ext in ("jpg", "jpeg", "png"):
            try:
                image = decode_image(contents).astype(np.float32)
            except Exception:
                return None, None
            return image, stem
        return None, None

    def close(self) -> None:
        # Idempotent, and safe when a consumer abandons a loader mid-stream
        # and garbage collection closes a half-torn-down tarfile.
        try:
            self.tfile.close()
        except (OSError, AttributeError):
            pass

    def __enter__(self) -> "NpyTarReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
