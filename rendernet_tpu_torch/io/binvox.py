"""Binvox voxel-file I/O (numpy), the port's own copy of the codec.

Counterpart of ``rendernet_tpu/io/binvox.py``: the run-length-encoded
``.binvox`` format (https://www.patrickmin.com/binvox/binvox.html). After
the ASCII header, payload bytes come in (value, count) pairs; the flat voxel
order on disk is x-major, then z, then y ("xzy"), and reading with
``fix_coords`` (the default) transposes it to ``data[x, y, z]``. Models are
dense 3-D arrays or sparse ``(3, N)`` coordinate arrays. Runs are expanded with ``np.repeat`` and re-encoded
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
    "read_as_coord_array",
    "dense_to_sparse",
    "sparse_to_dense",
    "write",
    "save_binvox",
    "load_binvox",
    "loads",
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
    """A binvox model (``binvox.py:49-79``): ``data`` is a 3-D bool array
    (dense) or a ``(3, N)`` coordinate array (sparse);
    ``dims``/``translate``/``scale`` relate voxel indices to model
    coordinates; ``axis_order`` says whether axis 1 is y (``"xyz"``) or z
    (``"xzy"``, the order on disk)."""

    data: np.ndarray
    dims: Sequence[int]
    translate: Sequence[float]
    scale: float
    axis_order: str = "xyz"

    def __post_init__(self) -> None:
        if self.axis_order not in ("xyz", "xzy"):
            raise ValueError(f"unsupported axis order: {self.axis_order!r}")

    def clone(self) -> "Voxels":
        return Voxels(self.data.copy(), list(self.dims), list(self.translate), self.scale,
                      self.axis_order)

    def write(self, fp: BinaryIO) -> None:
        write(self, fp)


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


def read_as_3d_array(fp: BinaryIO, fix_coords: bool = True) -> Voxels:
    """Read a binvox stream into a dense bool array: ``[x, y, z]`` with
    ``fix_coords``, else in the on-disk order ``[x, z, y]``."""
    dims, translate, scale = read_header(fp)
    raw = np.frombuffer(fp.read(), dtype=np.uint8)
    flat = np.repeat(raw[::2], raw[1::2]).astype(bool)
    n_expected = int(np.prod(dims))
    if flat.size != n_expected:
        raise IOError(
            f"binvox payload decodes to {flat.size} voxels, expected {n_expected}"
        )
    data = flat.reshape(dims)
    if fix_coords:
        return Voxels(np.transpose(data, (0, 2, 1)), dims, translate, scale, "xyz")
    return Voxels(data, dims, translate, scale, "xzy")


def read_as_coord_array(fp: BinaryIO, fix_coords: bool = True) -> Voxels:
    """Read a binvox stream into a sparse ``(3, N)`` coordinate array:
    rows (x, y, z) with ``fix_coords``, else (x, z, y)
    (``binvox.py:136-148``)."""
    vox = read_as_3d_array(fp, fix_coords=True)
    x, y, z = np.nonzero(vox.data)
    data, order = (np.vstack((x, y, z)), "xyz") if fix_coords else (np.vstack((x, z, y)), "xzy")
    return Voxels(np.ascontiguousarray(data), vox.dims, vox.translate, vox.scale, order)


def dense_to_sparse(voxel_data: np.ndarray, dtype=np.int64) -> np.ndarray:
    """Dense 3-D array -> ``(3, N)`` nonzero coordinates, in their order."""
    if voxel_data.ndim != 3:
        raise ValueError("voxel_data should be a 3-D array")
    return np.asarray(np.nonzero(voxel_data), dtype)


def sparse_to_dense(voxel_data: np.ndarray, dims, dtype=bool) -> np.ndarray:
    """``(3, N)`` coordinates -> a dense array of ``dims`` (an int for a
    cube), dropping coordinates out of range."""
    if voxel_data.ndim != 2 or voxel_data.shape[0] != 3:
        raise ValueError("voxel_data should be a (3, N) array")
    if np.isscalar(dims):
        dims = [int(dims)] * 3
    dims = [int(d) for d in dims]
    xyz = voxel_data.astype(np.int64)
    valid = ~np.any((xyz < 0) | (xyz >= np.asarray(dims).reshape(3, 1)), axis=0)
    out = np.zeros(dims, dtype=dtype)
    out[tuple(xyz[:, valid])] = True
    return out


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
    """Write a model in binary binvox format, in its ``axis_order`` (a
    sparse model is densified first)."""
    data = model.data
    if data.ndim == 2:
        data = sparse_to_dense(data, model.dims)
    fp.write(b"#binvox 1\n")
    fp.write(("dim " + " ".join(map(str, model.dims)) + "\n").encode())
    fp.write(("translate " + " ".join(map(str, model.translate)) + "\n").encode())
    fp.write(f"scale {model.scale}\n".encode())
    fp.write(b"data\n")
    if model.axis_order == "xyz":
        data = np.transpose(data, (0, 2, 1))
    fp.write(_encode_rle(data.reshape(-1)))


def save_binvox(data: np.ndarray, fname: str) -> None:
    """Save a dense 3-D binary array as ``.binvox`` (unit scale)."""
    with open(fname, "wb") as f:
        write(Voxels(np.asarray(data), list(data.shape), [0.0, 0.0, 0.0], 1.0), f)


def load_binvox(path: str, dtype=np.float32) -> np.ndarray:
    """Path -> dense ``[x, y, z]`` array of the given dtype."""
    with open(path, "rb") as f:
        return read_as_3d_array(f).data.astype(dtype)


def loads(buf: bytes) -> Voxels:
    """Parse a binvox byte string into a dense model."""
    return read_as_3d_array(_io.BytesIO(buf))
