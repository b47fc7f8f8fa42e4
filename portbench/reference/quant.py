"""The control's precision: the reference with every convolution's and
matrix product's operands in fp8, the step below the cells' bfloat16.

Forward operands are e4m3 and gradients e5m2, each tensor scaled by its own
amax (per-tensor scaling, as fp8 training and serving do); the products
accumulate in float32. The warp's passes store e4m3 too.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((t.float() / scale).to(dtype).float() * scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to scaled e4m3; its gradient rounded to scaled e5m2."""
    return _Fp8.apply(t)
