"""Fused Winograd F(2x2,3x3) conv for the wide 2D res stacks on the K3 CUDA
kernel (``csrc/winograd.cu``).

Counterpart of ``rendernet_tpu/ops/pallas_winograd.py``, forward only: the
training slice adds the data gradient (this kernel on flipped, io-swapped
weights) and the weight gradient. The plain version is
``ops.winograd.winograd3x3``.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from rendernet_tpu_torch.ops import _native
from rendernet_tpu_torch.ops.winograd import winograd3x3

__all__ = ["wino_conv2d", "wino_conv2d_plain", "wino_conv2d_supported"]

# Launches of the K3 kernel since the last reset, in all and by input shape
# (the CPU path launches none).
launches = 0
launches_by_shape: Counter = Counter()

wino_conv2d_plain = winograd3x3


def wino_conv2d_supported(x_shape, w_shape, stride) -> bool:
    """The envelope of ``pallas_winograd.wino_conv2d_supported`` (:118-144):
    SAME 3x3 stride 1, even H and W, ci >= 256, ci and co multiples of 128,
    batch >= 8 (at batch 1 the JAX kernel was measured slower than the plain
    conv, so single frames keep the conv path).

    Its VMEM clause (``_tiles`` must find a (bn, bb, th) tiling that fits the
    TPU's scoped VMEM) is left out: the CUDA kernel's tile is fixed (32
    tiles x 64 channels x 16 input channels per step) and fits an SM's
    shared memory for every shape, and ci, co multiples of 128 cover its
    16- and 64-channel steps."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    kh, kw, ci, co = w_shape
    if (kh, kw) != (3, 3) or tuple(stride) != (1, 1):
        return False
    b, h, w, c = x_shape
    if c != ci or ci % 128 or co % 128 or ci < 256:
        return False
    return h % 2 == 0 and w % 2 == 0 and b >= 8


def wino_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3 conv ``[B,H,W,C] @ [3,3,C,K]`` via Winograd.

    A CUDA tensor inside :func:`wino_conv2d_supported` runs the K3 kernel
    (any other CUDA input raises); a CPU tensor runs the plain version. The
    C entry first forms U = G w G^T (fp32, cast to ``x.dtype``) into a
    scratch buffer, then runs the fused convolution.
    """
    if x.device.type == "cpu":
        return wino_conv2d_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("wino_conv2d: x and w must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wino_conv2d: float32 or bfloat16 storage, got {x.dtype}")
    if not wino_conv2d_supported(x.shape, w.shape, (1, 1)):
        raise ValueError(f"wino_conv2d: {tuple(x.shape)} @ {tuple(w.shape)} is outside "
                         "the kernel's envelope; gate calls with wino_conv2d_supported")
    b, h, wd, c = x.shape
    k = w.shape[-1]
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel loads 16-byte vectors
        x = x.clone()
    w = w.to(x.dtype).contiguous()
    u = torch.empty((16, c, k), dtype=x.dtype, device=x.device)
    out = torch.empty((b, h, wd, k), dtype=x.dtype, device=x.device)
    lib = _native.load("winograd")
    lib.rn_winograd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = lib.rn_winograd(x.data_ptr(), w.data_ptr(), u.data_ptr(), out.data_ptr(),
                         _native.dtype_code(x.dtype), b, h, wd, c, k, _native.stream_ptr(x))
    _native.check(lib, rc, "K3 winograd")
    global launches
    launches += 1
    launches_by_shape[(b, h, wd, c)] += 1
    return out
