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

The fused wide-conv route (:data:`CUDA_CONV2D`, mirroring
``layers.PALLAS_CONV2D``): eligible 2D res stacks run resident in HWNC with
every block as two fused K5 calls (``ops/cuda_conv2d.py``), and other
eligible 3x3 stride-1 2D convs (the stacks' skip convs) take the NHWC K5 op.

The exact rewrites that JAX leaves to XLA, in plain PyTorch: the
phase-space strided conv (``ops/phase_conv.py``, :data:`PHASE_CONV3D`), the
depth-packed 3D conv (:data:`DEPTH_PACK`) and the sub-pixel forms of the
K=4 transposed convs, which :func:`conv_transpose_op` takes on every device
as JAX does. Their inner convs are plain (:func:`conv_grad.plain_conv`),
never a kernel, so they add no launch.

Spatial sharding (``ops/halo.py``): every conv and deconv, the res blocks
and their stacks take an optional ``shard``, this rank's
:class:`~rendernet_tpu_torch.ops.halo.RowShard` of the activations' rows
(axis 1; axis 0 of the HWNC stacks), or None for the whole tensor (the code
path without sharding). A sharded conv extends its slab by the rows it
reads from its neighbours (:func:`conv_halo`, :func:`deconv_halo`), runs
the same routed op on the extended slab and keeps its own output rows
(:func:`on_slab`); the crop's adjoint gives the discarded rows no
cotangent, so the weight gradients count this rank's rows only, partial
sums that the train step sums over the model axis.

For the inverse renderer's pretrained-style networks: :class:`FullyConnected`
and the ``relu`` res block (no alpha), whose ReLU is ``torch.maximum``: it
splits the gradient 0.5/0.5 at an exact zero as ``jnp.maximum`` does
(``torch.relu`` passes none).
"""
from __future__ import annotations

import functools
import itertools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from rendernet_tpu_torch.nn import init
from rendernet_tpu_torch.ops import cuda_conv2d, cuda_conv3d, cuda_winograd, phase_conv, winograd
from rendernet_tpu_torch.ops.conv_grad import (conv_wgrad, flip_io, gather_taps, plain_conv,
                                               plain_conv_wgrad, same_pads)
from rendernet_tpu_torch.ops.halo import RowShard, exchange
from rendernet_tpu_torch.utils.spans import span

__all__ = [
    "CUDA_CONV2D",
    "CUDA_CONV3D",
    "DEPTH_PACK",
    "PHASE_CONV3D",
    "PHASE_MAX_FANIN",
    "WINOGRAD_2D",
    "to_jax_layout",
    "to_torch_layout",
    "jax_layout_weight",
    "prelu",
    "conv_op",
    "conv_transpose_op",
    "conv_halo",
    "deconv_halo",
    "on_slab",
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

# The depth-packed 3D conv (``layers.py:150-152,211-282``): a stride-1
# odd-kernel 3D conv with co < 128 computes f depth-consecutive outputs
# per position as one conv of depth stride f and f*co output channels.
# "auto": off for CPU tensors (JAX's "auto" is the TPU backend) and off for
# CUDA tensors: K2 is checked first and takes every such conv of the
# models on the card, so no path reaches it, and at res1's shape with K2
# off it loses to the plain conv (H100 80GB HBM3, 700 W, chip_smoke.py
# phase 9, fwd + bwd: 32.77 against 2.91 ms in bf16 at batch 24, 20.54
# against 14.13 in fp32 at batch 8; K2 1.89 / 9.33). True / False force it.
DEPTH_PACK = "auto"

# The phase-space rewrite of the strided 3D convs (``ops/phase_conv.py``;
# ``layers.py:160-175``): False, True (only where the phase-folded fan-in
# ci * prod(stride) <= PHASE_MAX_FANIN: the shader's e_conv1 and e_conv2,
# the texture's and recon's e_conv2), "all" (every strided 3D conv that
# divides evenly) or "auto": off for CPU tensors, as JAX off the TPU, and
# "all" for CUDA tensors. On the card the fan-in gate is a measured
# negative (JAX's TPU gate does not carry over): in chip_smoke.py's A/B
# (H100 80GB HBM3, 700 W; batch 24, bf16, patch 128, median of 3 steps)
# the texture step took 315.60 ms off, 317.59 with the gate and 298.65 with
# "all", whose phase form of the 5-channel e_conv1 replaces cuDNN's 22.9 ms
# data gradient; the shader step 452.76 / 442.28 / 438.02 (its two strided
# convs pass the gate, so True and "all" route alike). PERF.md has the
# rows and the final run's arms.
PHASE_CONV3D = "auto"
PHASE_MAX_FANIN = 16

# Winograd F(2x2, 3x3) for the wide 3x3 stride-1 2D convs, JAX's three
# values (``layers.py:176-192,327-340``): "pallas" runs K3
# (ops/cuda_winograd.py) inside its envelope; True or "xla" runs the plain
# Winograd expression (ops/winograd.py) inside ``winograd3x3_supported``
# (cin, cout >= 256, any batch), differentiated by autograd; False never.
# Off by default; the render CLI's --fast sets "pallas".
WINOGRAD_2D = False

# K5/K5w (ops/cuda_conv2d.py) for the wide 3x3 stride-1 2D convs inside
# ``wc_conv2d_supported``, mirroring layers.PALLAS_CONV2D (off by default,
# as in JAX): "auto" uses them for CUDA tensors; True also routes CPU
# tensors through the wrappers (their plain versions); False never. Checked
# before WINOGRAD_2D, as JAX's _conv_op checks PALLAS_CONV2D first.
CUDA_CONV2D = False


def _conv2d_on(x: torch.Tensor) -> bool:
    return x.is_cuda if CUDA_CONV2D == "auto" else bool(CUDA_CONV2D)


def _phase_mode(x: torch.Tensor):
    if PHASE_CONV3D == "auto":
        return "all" if x.is_cuda else False
    return PHASE_CONV3D


def _depth_pack_on() -> bool:
    return DEPTH_PACK != "auto" and bool(DEPTH_PACK)


def to_jax_layout(w: torch.Tensor) -> torch.Tensor:
    """(out, in) + spatial [conv] or (in, out) + spatial [conv transpose]
    -> spatial + (in, out) [HWIO] or spatial + (out, in) [TF transpose]."""
    return w.permute(*range(2, w.dim()), 1, 0)


def to_torch_layout(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_jax_layout`."""
    n = w.dim()
    return w.permute(n - 1, n - 2, *range(n - 2))


class _CastToJaxLayout(torch.autograd.Function):
    """``to_jax_layout(w).to(dtype)`` whose gradient comes back contiguous
    in ``w``'s layout and dtype, in the one copy that casts it back."""

    @staticmethod
    def forward(ctx, w, dtype):
        ctx.w_dtype = w.dtype
        return to_jax_layout(w).to(dtype)

    @staticmethod
    def backward(ctx, g):
        return to_torch_layout(g).to(ctx.w_dtype, memory_format=torch.contiguous_format), None


def jax_layout_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``to_jax_layout(w).to(dtype)``. Where the cast differentiates ``w``,
    its gradient is made contiguous in the cast back (autograd's own would
    keep the layout the backward produced, a permuted view of ``w``'s, and
    the optimizer's fused update would copy it again: it takes contiguous
    tensors); the values are the same either way."""
    if dtype == w.dtype or not (w.requires_grad and torch.is_grad_enabled()):
        return to_jax_layout(w).to(dtype)
    return _CastToJaxLayout.apply(w, dtype)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Parametric ReLU with a per-channel alpha (channels last), as JAX's
    ``maximum(x, 0) + alpha * minimum(x, 0)``: at x = 0 exactly (zero
    biases on an empty region of the grid) the gradient splits 0.5 / 0.5
    as ``jnp.maximum`` / ``jnp.minimum``'s does, where ``clamp_min`` /
    ``clamp_max`` would pass all of it to both terms."""
    zero = x.new_zeros(())
    with span("weights"):
        alpha = alpha.to(x.dtype)
    return torch.maximum(x, zero) + alpha * torch.minimum(x, zero)


def _plain_conv(x: torch.Tensor, w: torch.Tensor, stride, ndim: int) -> torch.Tensor:
    """The SAME conv as one plain conv (JAX's ``lax.conv_general_dilated``)."""
    pads = [same_pads(x.shape[1 + i], w.shape[i], stride[i]) for i in range(ndim)]
    return plain_conv(x, w, stride, pads)


def _depth_pack_factor(x_shape, w_shape, stride) -> int:
    """Pack factor f for the stride-1 odd-kernel 3D conv, or 1 where it is
    ineligible (``layers.py:211-230``): the largest f in (8, 4, 2) with
    f*co and f*ci <= 128 that divides the depth (and is below it)."""
    if len(w_shape) != 5 or any(s != 1 for s in stride):
        return 1
    kh, kw, kd, ci, co = w_shape
    if kh % 2 == 0 or kw % 2 == 0 or kd % 2 == 0 or co >= 128:
        return 1
    d = x_shape[3]
    for f in (8, 4, 2):
        if co * f <= 128 and ci * f <= 128 and d % f == 0 and d > f:
            return f
    return 1


@functools.lru_cache(maxsize=None)
def _pack_index(kd: int, f: int) -> np.ndarray:
    """The packed kernel's depth taps: slot z of output block j holds tap
    z - j, or none (-1); ``[(kd + f - 1) * f]``."""
    z, j = np.meshgrid(np.arange(kd + f - 1), np.arange(f), indexing="ij")
    return np.where((z - j >= 0) & (z - j < kd), z - j, -1).reshape(-1)


def _packed_kernel(w: torch.Tensor, f: int) -> torch.Tensor:
    """``[kh,kw,kd,ci,co] -> [kh,kw,kd+f-1,ci,f*co]``: the kernel at ``f``
    depth offsets in disjoint output-channel blocks; linear in ``w``."""
    kh, kw, kd, ci, co = w.shape
    taps = gather_taps(w.movedim(2, 0), _pack_index(kd, f))
    taps = taps.reshape(kd + f - 1, f, kh, kw, ci, co).permute(2, 3, 0, 4, 1, 5)
    return taps.reshape(kh, kw, kd + f - 1, ci, f * co)


def _depth_pads(w_shape):
    kh, kw, kd = w_shape[:3]
    return [(kh // 2,) * 2, (kw // 2,) * 2, (kd // 2, kd - 1 - kd // 2)]


def _depth_packed_expr(x: torch.Tensor, w: torch.Tensor, f: int) -> torch.Tensor:
    """The SAME stride-1 3D conv, depth-packed (``layers.py:233-255``): a
    depth-stride-``f`` conv with the packed kernel emits ``f`` depth
    positions per step; ``[*, D/f, f*co] -> [*, D, co]`` is a reshape."""
    y = plain_conv(x, _packed_kernel(w, f), (1, 1, f), _depth_pads(w.shape))
    b, a1, a2, dp, _ = y.shape
    return y.reshape(b, a1, a2, dp * f, w.shape[-1])


def _depth_packed_wgrad(x: torch.Tensor, gy: torch.Tensor, w_shape, f: int) -> torch.Tensor:
    """Weight gradient of :func:`_depth_packed_expr`: the packed conv's own
    (f*co output channels), pulled back through the packing (the f
    blocks' slices summed in block order)."""
    kh, kw, kd, ci, co = w_shape
    b, h, wd, d, _ = gy.shape
    gwp = conv_wgrad(x, gy.reshape(b, h, wd, d // f, f * co), (kh, kw, kd + f - 1, ci, f * co),
                     (1, 1, f), _depth_pads(w_shape))
    g6 = gwp.reshape(kh, kw, kd + f - 1, ci, f, co)
    gw = g6[:, :, 0:kd, :, 0]
    for j in range(1, f):
        gw = gw + g6[:, :, j:j + kd, :, j]
    return gw


class _DepthPackedConv(torch.autograd.Function):
    """``layers.py:258-282``: the data gradient is the depth-packed conv of
    the cotangent with the flipped, io-swapped kernel; the weight gradient
    is :func:`_depth_packed_wgrad`."""

    @staticmethod
    def forward(ctx, x, w, f):
        ctx.f = f
        ctx.save_for_backward(x, w)
        return _depth_packed_expr(x, w, f)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(x.dtype)
        gx = _depth_packed_expr(gy, flip_io(w), ctx.f).to(x.dtype) \
            if ctx.needs_input_grad[0] else None
        gw = _depth_packed_wgrad(x, gy, w.shape, ctx.f).to(w.dtype) \
            if ctx.needs_input_grad[1] else None
        return gx, gw, None


def _depth_packed_conv(x: torch.Tensor, w: torch.Tensor, f: int) -> torch.Tensor:
    return _DepthPackedConv.apply(x, w, f)


def _kernel_for(x: torch.Tensor, w_shape, stride, ndim: int, x_shape=None):
    """Which route runs this conv, in the order of JAX's ``_conv_op``
    (``layers.py:285-346``): ``"conv3d"`` (K2) for the 3x3x3 stride-1 convs
    inside its envelope; ``"phase"`` (``ops/phase_conv.py``) for the
    strided 3D convs with :data:`PHASE_CONV3D` on, inside the fan-in gate
    unless it is "all"; ``"depth_pack"`` with :data:`DEPTH_PACK` on;
    ``"conv2d"`` (K5) for the wide 3x3 stride-1 2D convs with
    :data:`CUDA_CONV2D` on; ``"wino"`` (K3) for those with
    :data:`WINOGRAD_2D` "pallas", ``"wino_xla"`` (the plain Winograd
    expression) with any other true value; else None (the plain conv).
    The forward and both gradients route alike. ``x_shape``: route a
    tensor of that shape (and ``x``'s device and dtype)."""
    shape = tuple(x.shape if x_shape is None else x_shape)
    use_k2 = x.is_cuda if CUDA_CONV3D == "auto" else bool(CUDA_CONV3D)
    if ndim == 3 and use_k2 and cuda_conv3d.nc_conv3d_supported(shape, w_shape, stride):
        return "conv3d"
    phase = _phase_mode(x)
    if ndim == 3 and phase and phase_conv.phase_conv3d_supported(shape, w_shape, stride):
        fanin = shape[-1]
        for s in stride:
            fanin *= s
        if phase == "all" or fanin <= PHASE_MAX_FANIN:
            return "phase"
    if ndim == 3 and _depth_pack_on() and _depth_pack_factor(shape, w_shape, stride) > 1:
        return "depth_pack"
    if ndim == 2 and _conv2d_on(x) and cuda_conv2d.wc_conv2d_supported(shape, w_shape, stride):
        return "conv2d"
    if ndim == 2 and WINOGRAD_2D:
        if WINOGRAD_2D == "pallas":
            if cuda_winograd.wino_conv2d_supported(shape, w_shape, stride, x.dtype):
                return "wino"
        elif winograd.winograd3x3_supported(shape, w_shape, stride):
            return "wino_xla"
    return None


def conv_op(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int], ndim: int) -> torch.Tensor:
    """TF-SAME conv of channels-last ``x`` with an HWIO / DHWIO ``w``, on the
    route :func:`_kernel_for` picks."""
    stride = tuple(stride)
    kernel = _kernel_for(x, w.shape, stride, ndim)
    if kernel == "conv3d":
        return cuda_conv3d.nc_conv3d(x, w)
    if kernel == "phase":
        return phase_conv.phase_conv3d(x, w, stride)
    if kernel == "depth_pack":
        return _depth_packed_conv(x, w, _depth_pack_factor(x.shape, w.shape, stride))
    if kernel == "conv2d":
        return cuda_conv2d.wc_conv2d(x, w)
    if kernel == "wino":
        return cuda_winograd.wino_conv2d(x, w)
    if kernel == "wino_xla":
        return winograd.winograd3x3(x, w)
    return _plain_conv(x, w, stride, ndim)


def _deconv_s1_k4(x: torch.Tensor, w: torch.Tensor, ndim: int) -> torch.Tensor:
    """Adjoint of a SAME stride-1 K=4 conv as a plain conv
    (``layers.py:402-411``): that conv pads (1, 2), so the adjoint is the
    flipped, io-swapped kernel with the mirrored pads (2, 1)."""
    return plain_conv(x, flip_io(w), (1,) * ndim, [(2, 1)] * ndim)


# Sub-pixel taps per dim: output phase 0 takes kernel taps {t0: 3, t1: 1},
# phase 1 {t1: 2, t2: 0} of the 3-tap conv (``layers.py:424-434``).
_SUBPIXEL_TAPS = ({0: 3, 1: 1}, {1: 2, 2: 0})


@functools.lru_cache(maxsize=None)
def _subpixel_index(ndim: int) -> np.ndarray:
    """The phase kernel's slots ``[3]*ndim x 2^ndim`` (tap t, phase p): the
    index of the K=4 kernel tap it holds, or -1."""
    nph = 2 ** ndim
    idx = np.full((3,) * ndim + (nph,), -1, np.int64)
    for p in range(nph):
        bits = [(p >> (ndim - 1 - d)) & 1 for d in range(ndim)]
        for taps_ks in itertools.product(*[_SUBPIXEL_TAPS[b].items() for b in bits]):
            t_idx = tuple(t for t, _ in taps_ks)
            idx[t_idx + (p,)] = np.ravel_multi_index(tuple(k for _, k in taps_ks), (4,) * ndim)
    return idx.reshape(-1)


def _deconv_s2_k4(x: torch.Tensor, w: torch.Tensor, ndim: int) -> torch.Tensor:
    """Adjoint of a SAME stride-2 K=4 conv as a sub-pixel conv
    (``layers.py:414-453``): one stride-1 3-tap conv producing all 2^ndim
    output phases in channels, then a depth-to-space interleave. ``w`` is
    TF-transpose layout, spatial + (out, in)."""
    co, ci = w.shape[ndim], w.shape[ndim + 1]
    nph = 2 ** ndim
    taps = gather_taps(w.reshape(4 ** ndim, co, ci), _subpixel_index(ndim))
    wp = taps.reshape((3,) * ndim + (nph, co, ci)).movedim(-1, ndim)
    z = plain_conv(x, wp.reshape((3,) * ndim + (ci, nph * co)), (1,) * ndim, [(1, 1)] * ndim)
    b, sp = x.shape[0], tuple(x.shape[1:1 + ndim])
    z = z.reshape((b,) + sp + (2,) * ndim + (co,))
    perm = [0] + [a for d in range(ndim) for a in (1 + d, 1 + ndim + d)] + [1 + 2 * ndim]
    return z.permute(perm).reshape((b,) + tuple(2 * s for s in sp) + (co,))


def _plain_conv_transpose(x: torch.Tensor, w: torch.Tensor, stride, ndim: int) -> torch.Tensor:
    """The transposed conv as PyTorch's own (cuDNN's on the card): the full
    transposed conv cropped by the forward conv's low pad (for k4/s1 the
    forward pads (1, 2), so the crop starts at 1; k4/s2 pads (1, 1)). The
    oracle of the sub-pixel forms, and the route of every other kernel."""
    ks = w.shape[:ndim]
    if any(k < s for k, s in zip(ks, stride)):
        raise ValueError(f"conv transpose with kernel {tuple(ks)} < stride {stride}")
    convt = F.conv_transpose2d if ndim == 2 else F.conv_transpose3d
    y = convt(x.movedim(-1, 1), to_torch_layout(w), stride=stride)
    for i in range(ndim):
        lo = max(ks[i] - stride[i], 0) // 2
        y = y.narrow(2 + i, lo, x.shape[1 + i] * stride[i])
    return y.movedim(1, -1)


def _deconv_route(ks, stride):
    """``"s1_k4"`` / ``"s2_k4"`` for the K=4 transposed convs at stride 1 /
    2 (``layers.py:456-466``, every device), else None (the plain one)."""
    if all(k == 4 for k in ks):
        if all(s == 1 for s in stride):
            return "s1_k4"
        if all(s == 2 for s in stride):
            return "s2_k4"
    return None


def conv_transpose_op(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int],
                      ndim: int) -> torch.Tensor:
    """TF-semantics transposed conv (``tf.nn.conv*_transpose``, SAME,
    output = input * stride) of channels-last ``x`` with a TF-layout kernel
    (spatial + (out, in)): the adjoint of the SAME forward conv. K=4 at
    stride 1 and 2 take the plain-conv forms JAX takes on every backend
    (:func:`_deconv_s1_k4`, :func:`_deconv_s2_k4`); other kernels
    :func:`_plain_conv_transpose`."""
    stride = tuple(stride)
    route = _deconv_route(w.shape[:ndim], stride)
    if route == "s1_k4":
        return _deconv_s1_k4(x, w, ndim)
    if route == "s2_k4":
        return _deconv_s2_k4(x, w, ndim)
    return _plain_conv_transpose(x, w, stride, ndim)


def conv_halo(k: int, s: int, align: int = 1) -> Tuple[int, int]:
    """Halo rows (above, below) of a SAME conv with kernel ``k`` and stride
    ``s`` along the rows, on a slab whose start and length are multiples of
    ``s``: the SAME pads ``((k - s) // 2, the rest)`` of any extent that
    ``s`` divides, each rounded up to a multiple of ``max(s, align)``.
    The extended slab then starts at a multiple of ``s`` and ``s`` divides
    its length, so the SAME conv of it pads as the whole tensor's does and
    its output row ``a / s + i`` is the slab's output row ``i``: it reads
    rows ``s * i - pad_lo .. s * i - pad_lo + k - 1`` of the slab, all
    inside the extended one. Rows the halo adds beyond the pads (e_conv1's
    (2, 2) for its pads (1, 2) at stride 2) keep the extended slab aligned
    to the stride; no output that is kept reads them."""
    total = max(k - s, 0)
    step = max(s, align)
    return step * -(-(total // 2) // step), step * -(-(total - total // 2) // step)


def deconv_halo(k: int, s: int) -> Tuple[int, int]:
    """Halo rows (above, below) of a TF-SAME transposed conv with kernel
    ``k`` and stride ``s`` (output = input x s): its output row ``o`` sums
    input rows ``i`` with ``o = s * i + t - pad_lo`` over taps ``t < k``,
    ``pad_lo = (k - s) // 2`` the forward conv's, so the slab's output rows
    ``[s * i0, s * i1)`` read input rows ``i0 - (k - 1 - pad_lo) // s`` to
    ``i1 - 1 + (pad_lo - 1 + s) // s``. K=4: (1, 1) at stride 2, (2, 1)
    at stride 1."""
    pad_lo = max(k - s, 0) // 2
    return (k - 1 - pad_lo) // s, (pad_lo - 1 + s) // s


def on_slab(fn, x: torch.Tensor, shard: RowShard, halo: Tuple[int, int], up: int = 1,
            down: int = 1, axis: int = 1, extended: bool = False) -> torch.Tensor:
    """``fn`` on this rank's rows of ``x``: the slab extended by ``halo``
    (:func:`~rendernet_tpu_torch.ops.halo.exchange`; with ``extended`` the
    caller has put those rows in place), then the rows of ``fn``'s output
    that belong to the slab, ``fn`` mapping ``n`` input rows to ``n * up /
    down`` output rows. ``down`` (a stride) must divide the slab and the
    halo, else ``ValueError``."""
    lo, hi = halo
    xe = x if extended else exchange(x, lo, hi, shard, axis)
    h = xe.shape[axis] - lo - hi
    if (h * up) % down or (lo * up) % down or (hi * up) % down:
        raise ValueError(f"a slab of {h} rows with a halo of {halo} is not aligned to the "
                         f"stride {down}: the patch must divide by 2 x the model axis")
    y = fn(xe)
    return y.narrow(axis, lo * up // down, h * up // down)


def _conv_slab_halo(x: torch.Tensor, w_shape, stride, ndim: int) -> Tuple[int, int]:
    """:func:`conv_halo` of a conv, rounded up to whole 2-row output tiles
    where the extended slab routes to a Winograd form: the extended slab
    then starts at an even row of the whole tensor and the tiles fall
    where they fall without sharding."""
    halo = conv_halo(w_shape[0], stride[0])
    if ndim == 2 and any(halo):
        tiled = conv_halo(w_shape[0], stride[0], 2)
        shape = (x.shape[0], x.shape[1] + sum(tiled)) + tuple(x.shape[2:])
        if _kernel_for(x, w_shape, stride, ndim, shape) in ("wino", "wino_xla"):
            return tiled
    return halo


def conv_slab(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int], ndim: int,
              shard: RowShard | None, extended: bool = False) -> torch.Tensor:
    """:func:`conv_op` on this rank's rows (``shard``; None: the whole
    tensor): the slab extended by :func:`conv_halo`, the routed op, the
    slab's output rows. ``extended``: ``x`` already holds the halo rows."""
    stride = tuple(stride)
    if shard is None:
        return conv_op(x, w, stride, ndim)
    halo = conv_halo(w.shape[0], stride[0]) if extended else \
        _conv_slab_halo(x, w.shape, stride, ndim)
    return on_slab(lambda xe: conv_op(xe, w, stride, ndim), x, shard, halo, 1, stride[0],
                   extended=extended)


def conv_weight_grad(x: torch.Tensor, gy: torch.Tensor, w_shape, ndim: int) -> torch.Tensor:
    """Weight gradient (JAX layout) of :func:`conv_op`'s SAME stride-1
    odd-kernel conv of ``x``, on the route the forward's implies: K2w for
    K2's convs, the depth-packed weight gradient for that route's, K5w for
    K5's, the Winograd weight gradient (K6 or the direct one, as
    ``cuda_winograd.WGRAD`` says) for K3's, the plain Winograd
    expression's by autograd for ``"wino_xla"``, else the plain conv's.
    The JAX counterpart is the VJP of ``_conv_op`` in ``_act_conv_bwd``."""
    kernel = _kernel_for(x, w_shape, (1,) * ndim, ndim)
    if kernel == "conv3d":
        return cuda_conv3d.nc_conv3d_wgrad(x, gy)
    if kernel == "depth_pack":
        return _depth_packed_wgrad(x, gy, w_shape, _depth_pack_factor(x.shape, w_shape,
                                                                      (1,) * ndim))
    if kernel == "conv2d":
        return cuda_conv2d.conv2d_wgrad(cuda_conv2d.nhwc_to_hwnc(x), cuda_conv2d.nhwc_to_hwnc(gy))
    if kernel == "wino":
        return cuda_winograd.weight_grad(x, gy)
    if kernel == "wino_xla":  # linear in w: its VJP at any w, here 0
        with torch.enable_grad():
            w0 = torch.zeros(tuple(w_shape), dtype=x.dtype, device=x.device, requires_grad=True)
            (gw,) = torch.autograd.grad(winograd.winograd3x3(x.detach(), w0), w0, gy)
        return gw
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
            train: bool = True, shard: RowShard | None = None) -> torch.Tensor:
    """Inverted dropout (``layers.py:822-828``): in train mode with
    ``keep_prob < 1`` each value is kept with probability ``keep_prob`` and
    scaled by ``1 / keep_prob``; the identity otherwise. The mask is drawn
    from ``generator`` (on ``x``'s device); ``jax.random`` draws other bits
    from one seed, so the two packages agree in distribution only. With a
    ``shard`` ``x`` is this rank's rows: the mask is drawn at the whole
    tensor's shape and sliced, so the ranks of a model axis draw the rows
    of the one mask a run without sharding draws."""
    if not train or keep_prob >= 1.0:
        return x
    if generator is None:
        raise ValueError("train-mode dropout requires a generator")
    if shard is None:
        keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    else:
        whole = list(x.shape)
        whole[shard.axis] *= shard.size
        keep = shard.take(torch.rand(whole, generator=generator, device=x.device) < keep_prob)
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

    def forward(self, x: torch.Tensor, shard: RowShard | None = None,
                extended: bool = False) -> torch.Tensor:
        """``shard``, ``extended``: :func:`conv_slab`."""
        with span("weights"):
            w = jax_layout_weight(self.weight, x.dtype)
            b = self.bias.to(x.dtype)
        return conv_slab(x, w, self.stride, len(self.stride), shard, extended) + b


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

    def forward(self, x: torch.Tensor, shard: RowShard | None = None) -> torch.Tensor:
        """``shard``: this rank's rows, extended by :func:`deconv_halo`; its
        output rows are ``stride`` x its input rows."""
        with span("weights"):
            w = jax_layout_weight(self.weight, x.dtype)
            b = self.bias.to(x.dtype)
        ndim = len(self.stride)
        if shard is None:
            y = conv_transpose_op(x, w, self.stride, ndim)
        else:
            s = self.stride[0]
            y = on_slab(lambda xe: conv_transpose_op(xe, w, self.stride, ndim), x, shard,
                        deconv_halo(w.shape[0], s), up=s)
        return y + b


class FullyConnected(nn.Module):
    """``x @ W + b`` (``layers.py:527``); ``weight`` is (out, in), PyTorch's
    Linear layout (JAX keeps (in, out): the carry-over transposes it),
    initialised normal(0.02), biases 0.001."""

    def __init__(self, in_size: int, out_size: int, generator: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(init.normal((in_size, out_size), generator).t().contiguous())
        self.bias = nn.Parameter(init.constant((out_size,), 0.001))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("weights"):
            w, b = jax_layout_weight(self.weight, x.dtype), self.bias.to(x.dtype)
        return torch.matmul(x, w) + b


class ConvUnit(nn.Module):
    """A scope holding one conv (named like the scope) and its PReLU alpha:
    ``e_convN/e_convN/{weights,biases}`` and ``e_convN/alpha``."""

    def __init__(self, name: str, conv: nn.Module, out_ch: int):
        super().__init__()
        self.conv_name = name
        self.add_module(name, conv)
        self.alpha = nn.Parameter(init.zeros((out_ch,)))

    def forward(self, x: torch.Tensor, shard: RowShard | None = None, **kw) -> torch.Tensor:
        """``shard`` (and ``extended``, for a conv): the conv's (a
        :class:`FullyConnected` unit takes none)."""
        layer = getattr(self, self.conv_name)
        return prelu(layer(x) if shard is None else layer(x, shard=shard, **kw), self.alpha)


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

    def forward(self, x: torch.Tensor, preact: bool = False,
                shard: RowShard | None = None) -> torch.Tensor:
        """``shard``: this rank's rows; each conv exchanges its halo (with
        ``preact``, :func:`act_conv` runs on the pre-activation's extended
        slab: ``prelu`` is elementwise, so it commutes with the exchange,
        and its alpha and weight gradients are the slab's partial sums)."""
        net = self.con1_3X3(x, shard=shard)
        if self.activation == "relu":
            if preact:
                raise ValueError("preact applies to PReLU blocks only")
            net = self.conv2_3x3(torch.maximum(net, net.new_zeros(())), shard=shard)
        elif preact:
            c2 = self.conv2_3x3
            with span("weights"):
                args = (self.alpha.to(net.dtype), jax_layout_weight(c2.weight, net.dtype),
                        c2.bias.to(net.dtype), self.ndim)
            if shard is None:
                net = act_conv(net, *args)
            else:
                net = on_slab(lambda ze: act_conv(ze, *args), net, shard,
                              _conv_slab_halo(net, args[1].shape, (1,) * self.ndim, self.ndim))
        else:
            net = self.conv2_3x3(prelu(net, self.alpha), shard=shard)
        return net + x

    def forward_hwnc(self, xh: torch.Tensor, shard: RowShard | None = None) -> torch.Tensor:
        """The block on an HWNC input as two fused K5 ops (``_res_stack_hwnc``'s
        body, ``layers.py:776-784``): prelu/relu(conv1 + b1), then
        conv2 + b2 + xh. Parameters are cast to ``xh``'s dtype. ``shard``:
        this rank's rows (axis 0 here), each op on its slab extended by one
        row each side; the residual is the first op's extended input."""
        dt = xh.dtype
        c1, c2 = self.con1_3X3, self.conv2_3x3
        with span("weights"):
            w1, b1 = jax_layout_weight(c1.weight, dt), c1.bias.to(dt)
            w2, b2 = jax_layout_weight(c2.weight, dt), c2.bias.to(dt)
            alpha = self.alpha.to(dt) if self.activation == "prelu" else None
        if alpha is not None:
            def first(x):
                return cuda_conv2d.wc_conv2d_prelu_hwnc(x, w1, b1, alpha)
        else:
            def first(x):
                return cuda_conv2d.wc_conv2d_relu_hwnc(x, w1, b1)
        if shard is None:
            return cuda_conv2d.wc_conv2d_res_hwnc(first(xh), w2, b2, xh)
        xe = exchange(xh, 1, 1, shard, 0)
        net = on_slab(first, xe, shard, (1, 1), axis=0, extended=True)
        return on_slab(lambda ne: cuda_conv2d.wc_conv2d_res_hwnc(ne, w2, b2, xe), net, shard,
                       (1, 1), axis=0)


def _hwnc_stack(blocks: Sequence[ResBlock], x: torch.Tensor, halo_rows: int = 0) -> bool:
    """Whether the stack runs HWNC-resident on K5 (``layers.py:683-697``):
    2D 3x3 blocks whose width is the input's, :data:`CUDA_CONV2D` on, and
    the input (its rows extended by ``halo_rows`` on a sharded slab) inside
    ``wc_conv2d_supported`` with two output-sized streams (the fused
    epilogues' envelope)."""
    if not blocks or blocks[0].ndim != 2 or not _conv2d_on(x):
        return False
    c = x.shape[-1]
    shape = (x.shape[0], x.shape[1] + halo_rows) + tuple(x.shape[2:])
    return (tuple(blocks[0].con1_3X3.weight.shape) == (c, c, 3, 3)
            and cuda_conv2d.wc_conv2d_supported(shape, (3, 3, c, c), (1, 1), obufs=2))


def res_block_stack(blocks: Sequence[ResBlock], x: torch.Tensor, remat: bool = False,
                    preact: bool = False, shard: RowShard | None = None) -> torch.Tensor:
    """Apply the res blocks in order (``res_block_stack``, :650-700).

    ``remat`` recomputes each block's forward in the backward pass
    (``torch.utils.checkpoint``, non-reentrant): one block's activations
    live at a time instead of all of them. ``preact`` keeps only each
    block's first pre-activation (:func:`act_conv`); ``remat`` subsumes it,
    as in JAX. JAX's ``use_scan`` runs the same blocks as one ``lax.scan``,
    whose gain is compile time; PyTorch compiles nothing, so there is no
    scan here.

    A stack that :func:`_hwnc_stack` admits runs as JAX's
    ``_res_stack_hwnc`` (:755-801): one transpose to HWNC, each block as
    :meth:`ResBlock.forward_hwnc` (under ``remat``, checkpointed), one
    transpose back. As in JAX, that route ignores ``preact``. ``shard``:
    this rank's rows (the blocks exchange their halos; under ``remat`` the
    recompute exchanges again)."""
    if _hwnc_stack(blocks, x, 2 if shard is not None else 0):
        xh = cuda_conv2d.nhwc_to_hwnc(x)
        for blk in blocks:
            if remat and torch.is_grad_enabled():
                xh = torch.utils.checkpoint.checkpoint(blk.forward_hwnc, xh, shard,
                                                       use_reentrant=False)
            else:
                xh = blk.forward_hwnc(xh, shard)
        return cuda_conv2d.hwnc_to_nhwc(xh)
    for blk in blocks:
        if remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(blk, x, False, shard, use_reentrant=False)
        else:
            x = blk(x, preact=preact and not remat, shard=shard)
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
