"""Layers of the shader network (PyTorch, forward only).

Counterpart of ``rendernet_tpu/nn/layers.py``. Activations stay channels
last (NHWC / NDHWC) as in JAX. The functional ops take JAX-layout weights
(HWIO / DHWIO; TF conv-transpose kernels spatial + (out, in)); the
``nn.Module``s store PyTorch layouts (OIHW / OIDHW; conv-transpose
(in, out) + spatial), with child names that mirror the TF variable scopes
(``encoder.e_conv1.e_conv1.weight`` is ``encoder/e_conv1/e_conv1/weights``;
see ``compat/jax_params.py``). Parameters are float32 and are cast to the
activations' dtype at each use, as ``Module.param`` casts to the compute
dtype (``layers.py:129``). Dropout is the identity at inference and has no
op here.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rendernet_tpu_torch.nn import init
from rendernet_tpu_torch.ops import cuda_conv3d, cuda_winograd

__all__ = [
    "CUDA_CONV3D",
    "WINOGRAD_2D",
    "to_jax_layout",
    "to_torch_layout",
    "prelu",
    "conv_op",
    "conv_transpose_op",
    "Conv",
    "ConvTranspose",
    "ConvUnit",
    "ResBlock",
    "ProjectionUnit",
]

# K2 (ops/cuda_conv3d.py) for the 3x3x3 stride-1 convs inside its envelope,
# mirroring layers.PALLAS_CONV3D: "auto" uses it for CUDA tensors; True
# also routes CPU tensors through the wrapper (its plain version); False
# never.
CUDA_CONV3D = "auto"

# K3 (ops/cuda_winograd.py) for the wide 3x3 stride-1 2D convs inside its
# envelope, mirroring layers.WINOGRAD_2D = "pallas". Off by default; the
# render CLI's --fast turns it on.
WINOGRAD_2D = False


def to_jax_layout(w: torch.Tensor) -> torch.Tensor:
    """(out, in) + spatial [conv] or (in, out) + spatial [conv transpose]
    -> spatial + (in, out) [HWIO] or spatial + (out, in) [TF transpose]."""
    return w.permute(*range(2, w.dim()), 1, 0)


def to_torch_layout(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_jax_layout`."""
    n = w.dim()
    return w.permute(n - 1, n - 2, *range(n - 2))


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Parametric ReLU with a per-channel alpha (channels last)."""
    return torch.clamp_min(x, 0.0) + alpha.to(x.dtype) * torch.clamp_max(x, 0.0)


def _same_pads(size: int, k: int, s: int):
    """TF SAME padding: the odd extra pad goes on the high side."""
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _plain_conv(x: torch.Tensor, w: torch.Tensor, stride, ndim: int) -> torch.Tensor:
    pads = [_same_pads(x.shape[1 + i], w.shape[i], stride[i]) for i in range(ndim)]
    xc = x.movedim(-1, 1)
    if any(lo != hi for lo, hi in pads):
        xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
        padding = 0
    else:
        padding = [lo for lo, _ in pads]
    conv = F.conv2d if ndim == 2 else F.conv3d
    y = conv(xc, to_torch_layout(w), stride=tuple(stride), padding=padding)
    return y.movedim(1, -1)


def _use_conv3d_kernel(x: torch.Tensor) -> bool:
    return x.is_cuda if CUDA_CONV3D == "auto" else bool(CUDA_CONV3D)


def conv_op(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int], ndim: int) -> torch.Tensor:
    """TF-SAME conv of channels-last ``x`` with an HWIO / DHWIO ``w``,
    routed to K2 or K3 inside their envelopes (``layers.py:285-346``)."""
    stride = tuple(stride)
    if (ndim == 3 and _use_conv3d_kernel(x)
            and cuda_conv3d.nc_conv3d_supported(x.shape, w.shape, stride)):
        return cuda_conv3d.nc_conv3d(x, w)
    if (ndim == 2 and WINOGRAD_2D
            and cuda_winograd.wino_conv2d_supported(x.shape, w.shape, stride)):
        return cuda_winograd.wino_conv2d(x, w)
    return _plain_conv(x, w, stride, ndim)


def conv_transpose_op(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
                      ndim: int) -> torch.Tensor:
    """TF-semantics transposed conv (``tf.nn.conv*_transpose``, SAME,
    output = input * stride) of channels-last ``x`` with a TF-layout kernel
    (spatial + (out, in)): the adjoint of the SAME forward conv, i.e. the
    full transposed conv cropped by that conv's low pad (for k4/s1 the
    forward pads (1, 2), so the crop starts at 1; k4/s2 pads (1, 1))."""
    stride = tuple(stride)
    ks = w.shape[:ndim]
    if any(k < s for k, s in zip(ks, stride)):
        raise ValueError(f"conv transpose with kernel {tuple(ks)} < stride {stride}")
    convt = F.conv_transpose2d if ndim == 2 else F.conv_transpose3d
    y = convt(x.movedim(-1, 1), to_torch_layout(w), stride=stride)
    for i in range(ndim):
        lo = max(ks[i] - stride[i], 0) // 2
        y = y.narrow(2 + i, lo, x.shape[1 + i] * stride[i])
    return y.movedim(1, -1)


class Conv(nn.Module):
    """SAME conv + bias; ``weight`` is (out, in) + kernel."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: Sequence[int], generator: torch.Generator):
        super().__init__()
        self.stride = tuple(stride)
        w = init.xavier_uniform(tuple(kernel) + (in_ch, out_ch), generator)
        self.weight = nn.Parameter(to_torch_layout(w).contiguous())
        self.bias = nn.Parameter(init.constant((out_ch,), 0.001))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = to_jax_layout(self.weight).to(x.dtype)
        return conv_op(x, w, self.stride, len(self.stride)) + self.bias.to(x.dtype)


class ConvTranspose(nn.Module):
    """TF-semantics transposed conv + bias; ``weight`` is (in, out) + kernel,
    PyTorch's ConvTranspose layout."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Sequence[int],
                 stride: Sequence[int], generator: torch.Generator):
        super().__init__()
        self.stride = tuple(stride)
        w = init.xavier_uniform(tuple(kernel) + (out_ch, in_ch), generator)
        self.weight = nn.Parameter(to_torch_layout(w).contiguous())
        self.bias = nn.Parameter(init.constant((out_ch,), 0.001))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = to_jax_layout(self.weight).to(x.dtype)
        return conv_transpose_op(x, w, self.stride, len(self.stride)) + self.bias.to(x.dtype)


class ConvUnit(nn.Module):
    """A scope holding one conv (named like the scope) and its PReLU alpha:
    ``e_convN/e_convN/{weights,biases}`` and ``e_convN/alpha``."""

    def __init__(self, name: str, conv: nn.Module, out_ch: int):
        super().__init__()
        self.conv_name = name
        self.add_module(name, conv)
        self.alpha = nn.Parameter(init.zeros((out_ch,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(getattr(self, self.conv_name)(x), self.alpha)


class ResBlock(nn.Module):
    """conv -> PReLU -> conv, plus the identity skip (``layers.py:608-635``)."""

    def __init__(self, ch: int, ndim: int, generator: torch.Generator):
        super().__init__()
        k, s = (3,) * ndim, (1,) * ndim
        self.con1_3X3 = Conv(ch, ch, k, s, generator)
        self.alpha = nn.Parameter(init.zeros((ch,)))
        self.conv2_3x3 = Conv(ch, ch, k, s, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = prelu(self.con1_3X3(x), self.alpha)
        return self.conv2_3x3(net) + x


class ProjectionUnit(nn.Module):
    """The learned 3D->2D projection (``layers.py:804``): fold (depth,
    channel) into channels, then a 1x1 conv + PReLU."""

    def __init__(self, ch: int, generator: torch.Generator):
        super().__init__()
        self.Conv = Conv(ch, ch, (1, 1), (1, 1), generator)
        self.alpha = nn.Parameter(init.zeros((ch,)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, d, c = x.shape
        return prelu(self.Conv(x.reshape(b, h, w, d * c)), self.alpha)
