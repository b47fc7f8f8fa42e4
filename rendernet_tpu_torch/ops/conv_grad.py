"""Pieces of the plain conv and of the SAME stride-1 conv's backward that
the kernel wrappers (``cuda_conv3d``, ``cuda_winograd``), the exact
rewrites (``ops/phase_conv.py``, the layers' sub-pixel deconvs and
depth-packed conv) and the layers share.

Plain PyTorch: a channels-last conv with explicit pads (JAX's
``lax.conv_general_dilated``), the adjoint's kernel and the direct weight
gradient (cuDNN on the card; JAX leaves the same weight gradient to XLA).
Weights are in JAX layout, spatial + (in, out).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["conv_wgrad", "flip_io", "gather_taps", "plain_conv", "plain_conv_wgrad",
           "same_pads"]


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF / XLA SAME padding (low, high): the odd extra pad goes high."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def plain_conv(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
               pads: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, stride, pads)`` on channels-last
    ``x`` with a JAX-layout ``w``: (low, high) zero pads per spatial dim,
    the conv itself cuDNN's (on the card) or ATen's. It reaches no kernel
    of the port: the rewrites call it directly, as JAX's call XLA's conv."""
    ndim = w.dim() - 2
    xc = x.movedim(-1, 1)
    if any(lo != hi for lo, hi in pads):
        xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
        padding = 0
    else:
        padding = [lo for lo, _ in pads]
    conv = F.conv2d if ndim == 2 else F.conv3d
    w_t = w.permute(ndim + 1, ndim, *range(ndim))
    return conv(xc, w_t, stride=tuple(stride), padding=padding).movedim(1, -1)


def flip_io(w: torch.Tensor) -> torch.Tensor:
    """The adjoint's kernel: spatially flipped, in/out swapped."""
    ndim = w.dim() - 2
    return torch.flip(w, tuple(range(ndim))).transpose(ndim, ndim + 1)


def plain_conv_wgrad(x: torch.Tensor, gy: torch.Tensor, w_shape) -> torch.Tensor:
    """Weight gradient (JAX layout, ``x.dtype``) of the SAME stride-1
    odd-kernel conv of channels-last ``x`` with output cotangent ``gy``."""
    ks = tuple(w_shape[:-2])
    if any(k % 2 == 0 for k in ks):
        raise ValueError(f"odd kernels only, got {ks}")
    grad = torch.nn.grad.conv2d_weight if len(ks) == 2 else torch.nn.grad.conv3d_weight
    gw = grad(x.movedim(-1, 1), (w_shape[-1], w_shape[-2]) + ks, gy.movedim(-1, 1),
              padding=tuple(k // 2 for k in ks))
    return gw.permute(*range(2, gw.dim()), 1, 0)


_INDEX: Dict[tuple, torch.Tensor] = {}


def _device_index(idx: np.ndarray, device: torch.device) -> torch.Tensor:
    """``idx`` as a tensor on ``device``, made once per (index, device): a
    fresh host-to-device copy per call would synchronize the stream. Not
    kept while ``torch.export`` traces: the tensor made then is fake."""
    if torch.compiler.is_compiling():
        return torch.as_tensor(idx, device=device)
    key = (idx.tobytes(), device)
    t = _INDEX.get(key)
    if t is None:
        t = _INDEX[key] = torch.as_tensor(idx, device=device)
    return t


def gather_taps(w: torch.Tensor, idx: np.ndarray) -> torch.Tensor:
    """``w``'s taps (its leading dim) picked by ``idx`` (-1: a zero tap),
    differentiable in ``w``: ``[n, ...] -> [len(idx), ...]``. The rewrites
    build their kernels with it: one gather, whatever the number of taps."""
    w_ext = torch.cat([w, w.new_zeros((1,) + tuple(w.shape[1:]))])
    return w_ext.index_select(0, _device_index(np.where(idx < 0, w.shape[0], idx), w.device))


def conv_wgrad(x: torch.Tensor, gy: torch.Tensor, w_shape, stride: Sequence[int],
               pads: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Weight gradient (JAX layout, ``x.dtype``) of :func:`plain_conv`
    ``(x, w, stride, pads)`` with output cotangent ``gy``."""
    ndim = len(w_shape) - 2
    xc = F.pad(x.movedim(-1, 1), [p for lo_hi in reversed(pads) for p in lo_hi])
    grad = torch.nn.grad.conv2d_weight if ndim == 2 else torch.nn.grad.conv3d_weight
    gw = grad(xc, (w_shape[-1], w_shape[-2]) + tuple(w_shape[:ndim]), gy.movedim(-1, 1),
              stride=tuple(stride))
    return gw.permute(*range(2, gw.dim()), 1, 0)
