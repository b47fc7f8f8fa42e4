"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with nvcc into its own shared library with a plain C
interface (``-gencode arch=compute_90a,code=sm_90a -shared -Xcompiler
-fPIC``), loaded with ctypes. The build runs at first use, into
``rendernet_tpu_torch/_build/``, keyed on a hash of the sources and flags,
so a fresh checkout builds everything it runs. :func:`build_all` starts one
nvcc per source at once and waits for all of them.

Every C entry takes device pointers and the caller's CUDA stream as
``void*``, launches on that stream without synchronising, and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

__all__ = ["SOURCES", "build_all", "load", "check", "dtype_code", "stream_ptr", "aligned",
           "sm_count"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("resample", "resample_bwd", "conv3d", "conv3d_wgrad", "winograd", "winograd_wgrad",
           "conv2d", "conv2d_wgrad", "adam")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else shutil.which("nvcc")
    if not path or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build_all() -> Dict[str, str]:
    """Build every kernel library, one nvcc per source in parallel; returns
    each source's compiler log (ptxas register and shared-memory report)."""
    started = {n: _start(n) for n in SOURCES}
    logs = {}
    for n, s in started.items():
        logs[n] = _finish(n, s) if s else _target(n).with_suffix(".log").read_text()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        if name not in _libs:
            started = _start(name)
            if started:
                _finish(name, started)
            lib = ctypes.CDLL(str(_target(name)))
            lib.rn_error_string.argtypes = [ctypes.c_int]
            lib.rn_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.rn_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def dtype_code(dtype: torch.dtype) -> int:
    """The C entries' storage-type code: 0 float32, 1 bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16 storage, got {dtype}")
    return codes[dtype]


def stream_ptr(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the raw handle (a
    fraction of a microsecond; building a ``torch.cuda.Stream`` to read it
    takes several, and the serving and recon paths are host-bound)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index`` (the
    persistent kernels' grid: one CTA per SM)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels load 16-byte
    vectors), copied only where it is not."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t
