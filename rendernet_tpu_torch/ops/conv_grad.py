"""Pieces of the SAME stride-1 conv's backward that the kernel wrappers
(``cuda_conv3d``, ``cuda_winograd``) and the layers share.

Plain PyTorch: the adjoint's kernel and the direct weight gradient (cuDNN
on the card; JAX leaves the same weight gradient to XLA). Weights are in
JAX layout, spatial + (in, out).
"""
from __future__ import annotations

import torch

__all__ = ["flip_io", "plain_conv_wgrad"]


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
