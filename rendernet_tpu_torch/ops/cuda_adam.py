"""Adam's update of every parameter in one pass, on the CUDA kernel
``csrc/adam.cu``, with its plain per-tensor version.

No TPU kernel corresponds: the JAX package leaves Adam to optax, and XLA
fuses the update into the jitted step. :func:`adam_` updates parameters and
both moments in place: for each tensor, with fp32 arithmetic in
:func:`adam_moments`' order,

    m = (1 - b1) g + b1 m          v = (1 - b2) (g g) + b2 v
    u = (m / bc1) / (sqrt(v / bc2) + eps)   (in the gradient's dtype)
    p += u * lr                             (likewise)

and stores the moments rounded to their dtype: ``optim.scale_by_adam``
followed by ``scale_by_learning_rate`` and ``apply_updates``, bit for bit.
It runs the kernel on CUDA tensors (fp32 parameters; fp32 or bf16
gradients and moments, each kind of one dtype; contiguous tensors on one
card; anything else raises); :func:`adam_plain` is its plain version.

The kernel walks a table of chunks, (tensor, first element) pairs of at
most :data:`CHUNK` elements, beside a table of each tensor's parameter and
moment pointers and size. Both are built once for a parameter set
(:func:`chunk_table`, :func:`_tables`) and kept on the device; the
gradients' pointers, new every step, go in the launch's parameters.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from rendernet_tpu_torch.ops import _native

__all__ = ["CHUNK", "MAX_TENSORS", "adam_", "adam_moments", "adam_plain", "chunk_table"]

# The kernel's compiled constants (``csrc/adam.cu``; checked at load):
# tensors a launch takes (their gradient pointers fill 3 KB of the launch's
# parameters), elements a chunk, threads a CTA. A set of more tensors takes
# one launch per MAX_TENSORS.
MAX_TENSORS = 384
CHUNK = 8192
THREADS = 256
# CTAs per SM of the persistent grid: 8 x 256 threads fill an SM.
BLOCKS_PER_SM = 8

# Launches since the last reset, the tensors they updated, and the launches
# by the number of tensors in a launch.
launches = 0
tensors = 0
launches_by_shape: Counter = Counter()

Scalar = Union[torch.Tensor, float]


def adam_moments(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor, bc1: torch.Tensor,
                 bc2: torch.Tensor, b1: float, b2: float, eps: float
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tensor's Adam step before the learning rate: (the bias-corrected
    step in ``g``'s dtype, the new moments in fp32). The moments are loaded
    in fp32 and their caller stores them rounded to their dtype."""
    g32 = g.to(torch.float32)
    m32 = (1 - b1) * g32 + b1 * m.to(torch.float32)
    v32 = (1 - b2) * (g32 * g32) + b2 * v.to(torch.float32)
    step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
    return step.to(g.dtype), m32, v32


@torch.no_grad()
def adam_plain(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
               mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor], bc1: torch.Tensor,
               bc2: torch.Tensor, lr: Scalar, *, b1: float, b2: float, eps: float) -> None:
    """Plain PyTorch version of the kernel: tensor by tensor, in place."""
    for p, g, m, v in zip(params, grads, mu, nu):
        u, m32, v32 = adam_moments(g, m, v, bc1, bc2, b1, b2, eps)
        m.copy_(m32)
        v.copy_(v32)
        p.add_((u * lr).to(p.dtype))


def chunk_table(numels: Sequence[int]) -> np.ndarray:
    """[n, 2] int32 rows (tensor, first element): each tensor cut into
    chunks of at most CHUNK elements, tensors in order; empty tensors have
    none."""
    rows = [(t, s) for t, n in enumerate(numels) for s in range(0, n, CHUNK)]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 2)


@functools.lru_cache(maxsize=None)
def _lib():
    """The library, its entries' argument types set and its constants
    checked once."""
    lib = _native.load("adam")
    lib.rn_adam_constants.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.rn_adam_constants.restype = None
    lib.rn_adam.argtypes = ([ctypes.POINTER(ctypes.c_void_p), ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
                            + [ctypes.c_void_p] * 3 + [ctypes.c_float, ctypes.c_int]
                            + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p])
    consts = (ctypes.c_int * 4)()
    lib.rn_adam_constants(consts)
    if tuple(consts) != (MAX_TENSORS, CHUNK, THREADS, 32):
        raise RuntimeError(f"csrc/adam.cu's constants {tuple(consts)} differ from the wrapper's "
                           f"{(MAX_TENSORS, CHUNK, THREADS, 32)}")
    return lib


@functools.lru_cache(maxsize=8)
def _tables(key: tuple, device: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(tensor table [n, 4] int64 rows (p, m, v, numel), chunk table, grid)
    on ``device`` for a parameter set ``key`` = ((p, m, v, numel), ...) of
    data pointers: built at a set's first step, reused while its tensors
    stay where they are (a key names its pointers, so a hit is always
    right)."""
    rows = np.asarray(key, dtype=np.int64).reshape(-1, 4)
    chunks = chunk_table(rows[:, 3].tolist())
    dev = torch.device("cuda", device)
    grid = min(len(chunks), _native.sm_count(device) * BLOCKS_PER_SM)
    return (torch.from_numpy(rows).to(dev), torch.from_numpy(chunks).to(dev), grid)


def _check(params, grads, mu, nu, scalars) -> Tuple[torch.dtype, torch.dtype]:
    """Raise outside the kernel's envelope; returns (gradient, moment) dtypes."""
    dev = params[0].device
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError(f"adam_: {len(params)} params, {len(grads)} grads, {len(mu)} / "
                         f"{len(nu)} moments")
    gdt, mdt = grads[0].dtype, mu[0].dtype
    if gdt not in (torch.float32, torch.bfloat16) or mdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"adam_: gradients and moments must be float32 or bfloat16, got "
                        f"{gdt} and {mdt}")
    for p, g, m, v in zip(params, grads, mu, nu):
        if p.dtype != torch.float32 or g.dtype != gdt or m.dtype != mdt or v.dtype != mdt:
            raise TypeError(f"adam_: float32 parameters, gradients of one dtype and moments of "
                            f"one dtype; got {p.dtype}, {g.dtype}, {m.dtype}, {v.dtype}")
        n = p.numel()
        if not g.numel() == m.numel() == v.numel() == n or n >= 2 ** 31:
            raise ValueError(f"adam_: sizes {n}, {g.numel()}, {m.numel()}, {v.numel()}")
        if not (p.is_contiguous() and g.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("adam_: the kernel takes contiguous tensors")
        if not g.device == m.device == v.device == p.device == dev:
            raise ValueError(f"adam_: tensors on {p.device}, {g.device}, {m.device}, {v.device}; "
                             f"the first parameter is on {dev}")
    for s in scalars:
        if isinstance(s, torch.Tensor) and (s.device != dev or s.dtype != torch.float32
                                            or s.numel() != 1):
            raise ValueError(f"adam_: bc1, bc2 and lr must be float32 scalars on {dev}")
    return gdt, mdt


@torch.no_grad()
def adam_(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
          mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor], bc1: torch.Tensor,
          bc2: torch.Tensor, lr: Scalar, *, b1: float, b2: float, eps: float) -> None:
    """Adam's step of every tensor, in place (see the module docstring):
    ``bc1`` / ``bc2`` the bias corrections and ``lr`` the signed learning
    rate, fp32 device scalars (``lr`` may be a float)."""
    if params[0].device.type != "cuda":
        raise ValueError(f"adam_: the kernel takes CUDA tensors, got {params[0].device}")
    gdt, mdt = _check(params, grads, mu, nu, (bc1, bc2, lr))
    lib = _lib()
    lr_tensor = isinstance(lr, torch.Tensor)
    # PyTorch's product of a bf16 step and an fp32 device scalar rounds the
    # scalar to bf16 first; a Python float enters it unrounded.
    round_lr = int(lr_tensor and gdt == torch.bfloat16)
    hyper = (1 - b1, b1, 1 - b2, b2, eps)
    stream = _native.stream_ptr(params[0])
    global launches, tensors
    for lo in range(0, len(params), MAX_TENSORS):
        sl = slice(lo, lo + MAX_TENSORS)
        key = tuple((p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel())
                    for p, m, v in zip(params[sl], mu[sl], nu[sl]))
        table, chunks, grid = _tables(key, params[0].device.index)
        if grid == 0:
            continue
        gp = [g.data_ptr() for g in grads[sl]]
        rc = lib.rn_adam((ctypes.c_void_p * len(gp))(*gp), len(gp), table.data_ptr(),
                         chunks.data_ptr(), chunks.shape[0], _native.dtype_code(gdt),
                         _native.dtype_code(mdt), bc1.data_ptr(), bc2.data_ptr(),
                         lr.data_ptr() if lr_tensor else None,
                         0.0 if lr_tensor else float(lr), round_lr, *hyper, grid, stream)
        _native.check(lib, rc, "Adam")
        launches += 1
        tensors += len(gp)
        launches_by_shape[len(gp)] += 1
