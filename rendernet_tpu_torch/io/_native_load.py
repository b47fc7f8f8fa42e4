"""Build and load the repo's native host-I/O libraries (``native/*.cc``).

The port's own copy of the JAX package's loader idiom (a lock, build at
first use, ``ctypes.CDLL``, prototype setup), with its own build: each
source compiles with ``g++`` into ``rendernet_tpu_torch/_build/``, keyed on
a hash of the source and the flags, so a fresh checkout builds what it
loads and nothing is written into ``native/``. Where there is no compiler
or the build fails, :meth:`NativeLoader.load` returns None and the callers
take their pure-Python paths; :meth:`NativeLoader.error` says why.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional, Sequence

__all__ = ["NativeLoader", "NATIVE_DIR", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG.parent / "native"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread"]


class NativeLoader:
    """Lazily build and load ``native/<source>``; ``setup(lib)`` declares
    the ctypes prototypes on the first successful load. ``libs`` are the
    link flags (the Makefile's)."""

    def __init__(self, source: str, setup: Callable[[ctypes.CDLL], None],
                 libs: Sequence[str] = ()) -> None:
        self._source = NATIVE_DIR / source
        self._setup = setup
        self._libs = list(libs)
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False
        self._error: Optional[str] = None

    def target(self) -> Path:
        h = hashlib.sha256(" ".join(CXX_FLAGS + self._libs).encode())
        h.update(self._source.read_bytes())
        return BUILD_DIR / f"{self._source.stem}-{h.hexdigest()[:16]}.so"

    def _build(self, out: Path) -> None:
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if not cxx:
            raise RuntimeError("no C++ compiler (g++) on PATH")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, str(self._source), "-o", str(tmp), *self._libs],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {self._source.name}: {proc.stderr[-2000:]}")
        os.replace(tmp, out)

    def load(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._tried:
                return self._lib
            self._tried = True
            try:
                out = self.target()
                if not out.exists():
                    self._build(out)
                lib = ctypes.CDLL(str(out))
            except (OSError, RuntimeError, subprocess.SubprocessError) as e:
                self._error = str(e)
                return None
            self._setup(lib)
            self._lib = lib
            return lib

    def available(self) -> bool:
        return self.load() is not None

    def error(self) -> Optional[str]:
        """Why the library is not available (None when it loaded or was
        not tried)."""
        return self._error
