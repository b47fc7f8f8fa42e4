"""Binvox voxel-file I/O (numpy), the port's own copy of the dense codec.

Counterpart of ``rendernet_tpu/io/binvox.py``: the run-length-encoded
``.binvox`` format (https://www.patrickmin.com/binvox/binvox.html). After
the ASCII header, payload bytes come in (value, count) pairs; the flat voxel
order on disk is x-major, then z, then y ("xzy"), and reading transposes it
to ``data[x, y, z]``. Runs are expanded with ``np.repeat`` and re-encoded
with one diff/cumsum pass. :func:`decode_bytes` prefers the native codec
(``io/native.py``, ``native/voxio.cc``) and falls back to numpy, as the JAX
package's does (``binvox.py:36-46``).
"""
from __future__ import annotations

import dataclasses
import io as _io
from typing import BinaryIO, Sequence

import numpy as np

__all__ = [
    "Voxels",
    "read_header",
    "read_as_3d_array",
    "write",
    "save_binvox",
    "load_binvox",
    "decode_bytes",
]


def decode_bytes(buf: bytes) -> np.ndarray:
    """Decode binvox bytes to a dense ``[x, y, z]`` bool array, with the
    native codec where it builds, else the numpy one."""
    from rendernet_tpu_torch.io import native

    if native.available():
        try:
            return native.decode(buf)
        except ValueError:
            pass  # malformed for the strict native parser; let numpy try
    return read_as_3d_array(_io.BytesIO(buf)).data


@dataclasses.dataclass
class Voxels:
    """A dense binvox model: ``data`` is a 3-D bool array indexed
    ``[x, y, z]``; ``dims``/``translate``/``scale`` relate voxel indices to
    model coordinates."""

    data: np.ndarray
    dims: Sequence[int]
    translate: Sequence[float]
    scale: float


def read_header(fp: BinaryIO) -> tuple[list[int], list[float], float]:
    """Parse the ASCII header, leaving ``fp`` at the start of the payload."""
    magic = fp.readline().strip()
    if not magic.startswith(b"#binvox"):
        raise IOError("not a binvox file (missing '#binvox' magic)")
    dims: list[int] = []
    translate = [0.0, 0.0, 0.0]
    scale = 1.0
    while True:
        line = fp.readline()
        if not line:
            raise IOError("binvox header ended before 'data' line")
        fields = line.strip().split()
        if not fields:
            continue
        key = fields[0]
        if key == b"dim":
            dims = [int(v) for v in fields[1:4]]
        elif key == b"translate":
            translate = [float(v) for v in fields[1:4]]
        elif key == b"scale":
            scale = float(fields[1])
        elif key == b"data":
            break
    if len(dims) != 3:
        raise IOError("binvox header missing 'dim' line")
    return dims, translate, scale


def read_as_3d_array(fp: BinaryIO) -> Voxels:
    """Read a binvox stream into a dense ``[x, y, z]`` bool array."""
    dims, translate, scale = read_header(fp)
    raw = np.frombuffer(fp.read(), dtype=np.uint8)
    flat = np.repeat(raw[::2], raw[1::2]).astype(bool)
    n_expected = int(np.prod(dims))
    if flat.size != n_expected:
        raise IOError(
            f"binvox payload decodes to {flat.size} voxels, expected {n_expected}"
        )
    data = np.transpose(flat.reshape(dims), (0, 2, 1))
    return Voxels(data, dims, translate, scale)


def _encode_rle(flat: np.ndarray) -> bytes:
    """Run-length encode with the format's maximum run of 255."""
    flat = flat.astype(np.uint8)
    if flat.size == 0:
        return b""
    boundaries = np.flatnonzero(np.diff(flat)) + 1
    starts = np.concatenate(([0], boundaries))
    ends = np.concatenate((boundaries, [flat.size]))
    values = flat[starts]
    lengths = ends - starts
    n_chunks = -(-lengths // 255)
    out_values = np.repeat(values, n_chunks)
    out_counts = np.full(out_values.shape, 255, dtype=np.int64)
    out_counts[np.cumsum(n_chunks) - 1] = lengths - (n_chunks - 1) * 255
    pairs = np.empty(out_values.size * 2, dtype=np.uint8)
    pairs[0::2] = out_values
    pairs[1::2] = out_counts.astype(np.uint8)
    return pairs.tobytes()


def write(model: Voxels, fp: BinaryIO) -> None:
    """Write a dense model in binary binvox format."""
    fp.write(b"#binvox 1\n")
    fp.write(("dim " + " ".join(map(str, model.dims)) + "\n").encode())
    fp.write(("translate " + " ".join(map(str, model.translate)) + "\n").encode())
    fp.write(f"scale {model.scale}\n".encode())
    fp.write(b"data\n")
    fp.write(_encode_rle(np.transpose(model.data, (0, 2, 1)).reshape(-1)))


def save_binvox(data: np.ndarray, fname: str) -> None:
    """Save a dense 3-D binary array as ``.binvox`` (unit scale)."""
    with open(fname, "wb") as f:
        write(Voxels(np.asarray(data), list(data.shape), [0.0, 0.0, 0.0], 1.0), f)


def load_binvox(path: str, dtype=np.float32) -> np.ndarray:
    """Path -> dense ``[x, y, z]`` array of the given dtype."""
    with open(path, "rb") as f:
        return read_as_3d_array(f).data.astype(dtype)
