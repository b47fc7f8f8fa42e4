"""Narrow-channel SAME 3x3x3 stride-1 conv on the K2 CUDA kernel
(``csrc/conv3d.cu``).

Counterpart of ``rendernet_tpu/ops/pallas_conv3d.py``, forward only: the
training slice adds the data gradient (this kernel on flipped, io-swapped
weights) and the weight-gradient kernel. ``[B,H,W,D,C] @ [3,3,3,C,co]
-> [B,H,W,D,co]`` with fp32 accumulation, for co in {16, 32, 64}.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as F

from rendernet_tpu_torch.ops import _native

__all__ = ["nc_conv3d", "nc_conv3d_plain", "nc_conv3d_supported"]

# Launches of the K2 kernel since the last reset, in all and by input shape
# (the CPU path launches none).
launches = 0
launches_by_shape: Counter = Counter()


def nc_conv3d_supported(x_shape, w_shape, stride) -> bool:
    """The envelope of ``pallas_conv3d.nc_conv3d_supported`` (:66-83), kept
    as it is so that the two packages route the same convs to their
    kernels. The depth clauses come from the TPU kernel's 128-lane depth
    packing; the CUDA kernel masks its own edges and needs none of them."""
    if len(x_shape) != 5 or len(w_shape) != 5:
        return False
    kh, kw, kd, ci, co = w_shape
    if (kh, kw, kd) != (3, 3, 3) or any(s != 1 for s in stride):
        return False
    if co not in (16, 32, 64):
        return False
    f = 128 // co
    b, h, wdim, d, c = x_shape
    if c != ci:
        return False
    return d % f == 0 and d // f >= 1 and (wdim * (d // f)) % 8 == 0 and h >= 1


def nc_conv3d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: the 27 taps as fp32 products of the
    stored values, summed in fp32, rounded once to ``x.dtype``."""
    b, h, wd, d, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)).to(torch.float32)
    wf = w.to(torch.float32)
    y = None
    for kh in range(3):
        for kw in range(3):
            for kd in range(3):
                tap = torch.matmul(xp[:, kh:kh + h, kw:kw + wd, kd:kd + d, :], wf[kh, kw, kd])
                y = tap if y is None else y + tap
    return y.to(x.dtype)


def nc_conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3x3 conv, ``[B,H,W,D,C] @ [3,3,3,C,co]``.

    A CUDA tensor inside :func:`nc_conv3d_supported` runs the K2 kernel (any
    other CUDA input raises); a CPU tensor runs :func:`nc_conv3d_plain`.
    """
    if x.device.type == "cpu":
        return nc_conv3d_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device or w.dtype != x.dtype:
        raise ValueError("nc_conv3d: x and w must be on one CUDA device, in one dtype")
    if not nc_conv3d_supported(x.shape, w.shape, (1, 1, 1)):
        raise ValueError(f"nc_conv3d: {tuple(x.shape)} @ {tuple(w.shape)} is outside "
                         "the kernel's envelope; gate calls with nc_conv3d_supported")
    b, h, wd, d, c = x.shape
    co = w.shape[-1]
    cp = -(-c // 16) * 16
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel loads 16-byte vectors
        x = x.clone()
    wp = torch.zeros((27, cp, co), dtype=x.dtype, device=x.device)
    wp[:, :c] = w.reshape(27, c, co)
    out = torch.empty((b, h, wd, d, co), dtype=x.dtype, device=x.device)
    lib = _native.load("conv3d")
    lib.rn_conv3d.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    rc = lib.rn_conv3d(x.data_ptr(), wp.data_ptr(), out.data_ptr(), _native.dtype_code(x.dtype),
                       b, h, wd, d, c, cp, co, _native.stream_ptr(x))
    _native.check(lib, rc, "K2 conv3d")
    global launches
    launches += 1
    launches_by_shape[(b, h, wd, d, c)] += 1
    return out
