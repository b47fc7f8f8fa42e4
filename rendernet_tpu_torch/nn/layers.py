"""Layers of the shader network (PyTorch).

Counterpart of ``rendernet_tpu/nn/layers.py``. Activations stay channels
last (NHWC / NDHWC) as in JAX. The functional ops take JAX-layout weights
(HWIO / DHWIO; TF conv-transpose kernels spatial + (out, in)); the
``nn.Module``s store PyTorch layouts (OIHW / OIDHW; conv-transpose
(in, out) + spatial), with child names that mirror the TF variable scopes
(``encoder.e_conv1.e_conv1.weight`` is ``encoder/e_conv1/e_conv1/weights``;
see ``compat/jax_params.py``). Parameters are float32 and are cast to the
activations' dtype at each use, as ``Module.param`` casts to the compute
dtype (``layers.py:129``), so their gradients arrive in the activations'
dtype and are cast back to float32 by that cast's own gradient.

The training half: :func:`dropout` in train mode, the
save-pre-activation-only residual unit (:func:`act_conv`, the JAX
``_act_conv`` custom VJP, :553-586) and :func:`res_block_stack` with
``remat`` as ``torch.utils.checkpoint``.

For the inverse renderer's pretrained-style networks: :class:`FullyConnected`
and the ``relu`` res block (no alpha), whose ReLU is ``torch.maximum``: it
splits the gradient 0.5/0.5 at an exact zero as ``jnp.maximum`` does
(``torch.relu`` passes none).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from rendernet_tpu_torch.nn import init
from rendernet_tpu_torch.ops import cuda_conv3d, cuda_winograd
from rendernet_tpu_torch.ops.conv_grad import flip_io, plain_conv_wgrad

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
    "FullyConnected",
    "ResBlock",
    "ProjectionUnit",
    "act_conv",
    "conv_weight_grad",
    "dropout",
    "res_block_stack",
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


def _kernel_for(x: torch.Tensor, w_shape, stride, ndim: int):
    """Which kernel runs this conv (``layers.py:285-346``): ``"conv3d"``
    (K2) for the 3x3x3 stride-1 convs inside its envelope, ``"wino"`` (K3)
    for the wide 3x3 stride-1 2D ones with :data:`WINOGRAD_2D` on, else
    None (the plain conv). The forward and both gradients route alike."""
    use_k2 = x.is_cuda if CUDA_CONV3D == "auto" else bool(CUDA_CONV3D)
    if ndim == 3 and use_k2 and cuda_conv3d.nc_conv3d_supported(x.shape, w_shape, stride):
        return "conv3d"
    if ndim == 2 and WINOGRAD_2D and cuda_winograd.wino_conv2d_supported(x.shape, w_shape,
                                                                          stride):
        return "wino"
    return None


def conv_op(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int], ndim: int) -> torch.Tensor:
    """TF-SAME conv of channels-last ``x`` with an HWIO / DHWIO ``w``, on the
    kernel :func:`_kernel_for` picks."""
    stride = tuple(stride)
    kernel = _kernel_for(x, w.shape, stride, ndim)
    if kernel == "conv3d":
        return cuda_conv3d.nc_conv3d(x, w)
    if kernel == "wino":
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


def conv_weight_grad(x: torch.Tensor, gy: torch.Tensor, w_shape, ndim: int) -> torch.Tensor:
    """Weight gradient (JAX layout) of :func:`conv_op`'s SAME stride-1
    odd-kernel conv of ``x``, on the kernel the forward's route implies:
    K2w for K2's convs, the Winograd weight gradient (K6 or the direct one,
    as ``cuda_winograd.WGRAD`` says) for K3's, else the plain conv's. The
    JAX counterpart is the VJP of ``_conv_op`` in ``_act_conv_bwd``."""
    kernel = _kernel_for(x, w_shape, (1,) * ndim, ndim)
    if kernel == "conv3d":
        return cuda_conv3d.nc_conv3d_wgrad(x, gy)
    if kernel == "wino":
        return cuda_winograd.weight_grad(x, gy)
    return plain_conv_wgrad(x, gy, w_shape)


class _ActConv(torch.autograd.Function):
    """PReLU -> SAME stride-1 odd-kernel conv -> + bias, saving only the
    pre-activation, alpha and the weights (``layers.py:547-586``)."""

    @staticmethod
    def forward(ctx, z, alpha, w, b, ndim):
        ctx.ndim = ndim
        ctx.save_for_backward(z, alpha, w)
        return conv_op(prelu(z, alpha), w, (1,) * ndim, ndim) + b

    @staticmethod
    def backward(ctx, g):
        z, alpha, w = ctx.saved_tensors
        ndim = ctx.ndim
        axes = tuple(range(g.dim() - 1))
        y = prelu(z, alpha)  # the only recompute: elementwise, no conv
        gw = conv_weight_grad(y, g, w.shape, ndim).to(w.dtype)
        gb = torch.sum(g, dim=axes)
        gy = conv_op(g, flip_io(w), (1,) * ndim, ndim)
        gz = torch.where(z > 0, gy, alpha * gy)
        galpha = torch.sum(gy * torch.clamp_max(z, 0.0), dim=axes)
        return gz.to(z.dtype), galpha.to(alpha.dtype), gw, gb.to(g.dtype), None


def act_conv(z: torch.Tensor, alpha: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             ndim: int) -> torch.Tensor:
    """``conv_op(prelu(z, alpha), w) + b`` as one unit whose backward keeps
    the pre-activation ``z`` only and recomputes ``prelu(z)`` (one
    elementwise op, no conv). It calls the weight- and data-gradient
    kernels directly (:func:`conv_weight_grad`; :func:`conv_op` on the
    flipped, io-swapped weights), so no data gradient is computed only to
    be thrown away. Same math as the unfused layers."""
    return _ActConv.apply(z, alpha, w, b, ndim)


def dropout(x: torch.Tensor, keep_prob: float, generator: torch.Generator | None,
            train: bool = True) -> torch.Tensor:
    """Inverted dropout (``layers.py:822-828``): in train mode with
    ``keep_prob < 1`` each value is kept with probability ``keep_prob`` and
    scaled by ``1 / keep_prob``; the identity otherwise. The mask is drawn
    from ``generator`` (on ``x``'s device); ``jax.random`` draws other bits
    from one seed, so the two packages agree in distribution only."""
    if not train or keep_prob >= 1.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout requires a generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


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


class FullyConnected(nn.Module):
    """``x @ W + b`` (``layers.py:527``); ``weight`` is (out, in), PyTorch's
    Linear layout (JAX keeps (in, out): the carry-over transposes it),
    initialised normal(0.02), biases 0.001."""

    def __init__(self, in_size: int, out_size: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(init.normal((in_size, out_size), generator).t().contiguous())
        self.bias = nn.Parameter(init.constant((out_size,), 0.001))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.weight.to(x.dtype).t()) + self.bias.to(x.dtype)


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
    """conv -> PReLU -> conv, plus the identity skip (``layers.py:608-635``).
    With ``preact`` the PReLU and the second conv run as :func:`act_conv`.
    ``activation="relu"`` is the pretrained-weights variant: a plain ReLU and
    no alpha parameter."""

    def __init__(self, ch: int, ndim: int, generator: torch.Generator,
                 activation: str = "prelu"):
        super().__init__()
        if activation not in ("prelu", "relu"):
            raise ValueError(f"activation must be 'prelu' or 'relu', got {activation!r}")
        self.ndim = ndim
        self.activation = activation
        k, s = (3,) * ndim, (1,) * ndim
        self.con1_3X3 = Conv(ch, ch, k, s, generator)
        if activation == "prelu":
            self.alpha = nn.Parameter(init.zeros((ch,)))
        self.conv2_3x3 = Conv(ch, ch, k, s, generator)

    def forward(self, x: torch.Tensor, preact: bool = False) -> torch.Tensor:
        net = self.con1_3X3(x)
        if self.activation == "relu":
            if preact:
                raise ValueError("preact applies to PReLU blocks only")
            net = self.conv2_3x3(torch.maximum(net, net.new_zeros(())))
        elif preact:
            c2 = self.conv2_3x3
            net = act_conv(net, self.alpha.to(net.dtype), to_jax_layout(c2.weight).to(net.dtype),
                           c2.bias.to(net.dtype), self.ndim)
        else:
            net = self.conv2_3x3(prelu(net, self.alpha))
        return net + x


def res_block_stack(blocks: Sequence[ResBlock], x: torch.Tensor, remat: bool = False,
                    preact: bool = False) -> torch.Tensor:
    """Apply the res blocks in order (``res_block_stack``, :650-700).

    ``remat`` recomputes each block's forward in the backward pass
    (``torch.utils.checkpoint``, non-reentrant): one block's activations
    live at a time instead of all of them. ``preact`` keeps only each
    block's first pre-activation (:func:`act_conv`); ``remat`` subsumes it,
    as in JAX. JAX's ``use_scan`` runs the same blocks as one ``lax.scan``,
    whose gain is compile time; PyTorch compiles nothing, so there is no
    scan here."""
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(blk, x, use_reentrant=False)
        else:
            x = blk(x, preact=preact and not remat)
    return x


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
