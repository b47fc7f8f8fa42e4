"""Wide-channel SAME 3x3 stride-1 2D conv in HWNC layout with fused res-block
epilogues, on the K5 CUDA kernel (``csrc/conv2d.cu``), and its weight
gradient on the K5w kernel (``csrc/conv2d_wgrad.cu``).

Counterpart of ``rendernet_tpu/ops/pallas_conv2d.py``. The activations of a
fused res-block stack stay in HWNC (``[H, W, B, C]``) between one transpose
pair, as in JAX; weights are HWIO ``[3, 3, C, co]``. The public ops are
differentiable (one ``torch.autograd.Function`` each, mirroring the custom
VJPs at :476-604):

* :func:`wc_conv2d_hwnc` -- ``conv(x, w)``;
* :func:`wc_conv2d_prelu_hwnc` -- ``prelu(conv(x, w) + b, alpha)``;
* :func:`wc_conv2d_relu_hwnc` -- ``relu(conv(x, w) + b)``;
* :func:`wc_conv2d_res_hwnc` -- ``conv(x, w) + b + res``;
* :func:`wc_conv2d` -- the NHWC conv (two transposes around the first).

Their backward: the data gradient is K5 on the flipped, io-swapped weights,
in the input's dtype; the weight gradient is K5w (fp32, cast to the
weights' dtype), run only when the weights need a gradient; bias and alpha
gradients are fp32 sums cast to the cotangent's dtype; the residual's is
the cotangent. :func:`conv2d_hwnc` and :func:`conv2d_wgrad` are the two
kernels' wrappers, :func:`conv2d_hwnc_plain` and :func:`conv2d_wgrad_plain`
their plain versions.

:func:`wc_conv2d_supported` is JAX's envelope, copied as arithmetic: it
decides which convs take this route, so both packages route the same convs
(batch enters through the TPU tiling's ``bb`` rule). The Hopper kernels
pick their own tiles and need only C % 32 == 0 and co % 128 == 0 (K5) or
C % 128 == 0 (K5w).
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as F

from rendernet_tpu_torch.ops import _native
from rendernet_tpu_torch.ops.conv_grad import flip_io

__all__ = [
    "PRELU_SAVE_PRE",
    "conv2d_hwnc",
    "conv2d_hwnc_plain",
    "conv2d_wgrad",
    "conv2d_wgrad_plain",
    "hwnc_to_nhwc",
    "nhwc_to_hwnc",
    "wc_conv2d",
    "wc_conv2d_hwnc",
    "wc_conv2d_prelu_hwnc",
    "wc_conv2d_relu_hwnc",
    "wc_conv2d_res_hwnc",
    "wc_conv2d_supported",
]

# The PReLU op's backward residual, as ``pallas_conv2d.PRELU_SAVE_PRE``
# (:118): True, the forward also emits the pre-activation z and the
# backward reads it; False, the backward recomputes z with one bias-only K5
# call.
PRELU_SAVE_PRE = True

# Launches since the last reset, in all and by key: K5 (``launches``;
# forward convs, data gradients and z recomputes alike) by (input shape,
# output channels, epilogue); K5w (``wgrad_launches``) by (input shape,
# output channels). Shapes are HWNC. The CPU path launches none.
launches = 0
launches_by_shape: Counter = Counter()
wgrad_launches = 0
wgrad_launches_by_shape: Counter = Counter()

_ACTS = {"none": 0, "prelu": 1, "relu": 2}

# ---------------------------------------------------------------------------
# the envelope (pallas_conv2d.py:93-229, with TILE_OVERRIDE at None)
# ---------------------------------------------------------------------------
_VMEM_BUDGET = 13 * 1024 * 1024


def _divisors_desc(n: int):
    return sorted((d for d in range(1, n + 1) if n % d == 0), reverse=True)


def _vmem_bytes(bh, bb, bn, wd, cch, xbytes, obufs=1):
    xrows = 2 * (bh + 2) * (wd + 2) * bb * cch * xbytes
    wtile = 9 * cch * bn * xbytes
    out = obufs * 2 * bh * wd * bb * bn * xbytes
    acc = wd * bb * bn * 4
    return xrows + wtile + out + acc


def _vmem_bytes_wgrad(bh, bb, bn, wd, cch, xbytes):
    xrows = 2 * (bh + 2) * (wd + 2) * bb * cch * xbytes
    gy = 2 * bh * wd * bb * bn * xbytes
    out = 9 * cch * bn * 4
    acc = cch * bn * 4
    return xrows + gy + out + acc


def _bb_ok(bb: int, b: int) -> bool:
    return bb % 8 == 0 or bb == b


def _tiles_wgrad(h, wd, b, cch, co, xbytes):
    best = None
    for bn in (256, 128):
        if co % bn:
            continue
        for bb in _divisors_desc(b):
            if not _bb_ok(bb, b):
                continue
            m = wd * bb
            if m > 512 or m % 8:
                continue
            for bh in (8, 4, 2, 1):
                if h % bh:
                    continue
                if _vmem_bytes_wgrad(bh, bb, bn, wd, cch, xbytes) > _VMEM_BUDGET:
                    continue
                cost = (bh + 2) / bh * (co // bn)
                key = (cost, -m, -bh)
                if best is None or key < best[0]:
                    best = (key, (bn, bh, bb))
                break
    return None if best is None else best[1]


def _tiles(h, wd, b, cch, co, xbytes, obufs=1):
    best = None
    for bn in (256, 128):
        if co % bn:
            continue
        for bb in _divisors_desc(b):
            if not _bb_ok(bb, b):
                continue
            m = wd * bb
            if m > 512 or m % 8:
                continue
            for bh in (8, 4, 2, 1):
                if h % bh:
                    continue
                if _vmem_bytes(bh, bb, bn, wd, cch, xbytes, obufs) > _VMEM_BUDGET:
                    continue
                cost = (bh + 2) / bh * (co // bn)
                key = (cost, -m, -bh)
                if best is None or key < best[0]:
                    best = (key, (bn, bh, bb))
                break
    return None if best is None else best[1]


def wc_conv2d_supported(x_shape, w_shape, stride, obufs=1) -> bool:
    """True when (NHWC x, HWIO w, stride) is in ``pallas_conv2d``'s
    envelope (:212-229): 3x3, stride 1, ci == C >= 256, ci and co multiples
    of 128, and a TPU tiling for the forward (with ``obufs`` output-sized
    streams; 2 gates a fused stack) and the weight gradient at 2-byte
    activations. Only dispatch reads it."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    kh, kw, ci, co = w_shape
    if (kh, kw) != (3, 3) or any(s != 1 for s in stride):
        return False
    b, h, wd, c = x_shape
    if c != ci or ci % 128 or co % 128 or ci < 256:
        return False
    return (_tiles(h, wd, b, ci, co, 2, obufs) is not None
            and _tiles_wgrad(h, wd, b, ci, co, 2) is not None)


# ---------------------------------------------------------------------------
# layouts and plain versions
# ---------------------------------------------------------------------------
def nhwc_to_hwnc(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [H, W, B, C] (the kernels' layout), contiguous."""
    return x.permute(1, 2, 0, 3).contiguous()


def hwnc_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(2, 0, 1, 3).contiguous()


def _taps(xh: torch.Tensor):
    """The nine shifted views ``xpad[ky:ky+H, kx:kx+W]`` of the zero-padded
    input, fp32, in (ky, kx) order."""
    h, wd = xh.shape[:2]
    xp = F.pad(xh, (0, 0, 0, 0, 1, 1, 1, 1)).to(torch.float32)
    return [xp[ky:ky + h, kx:kx + wd] for ky in range(3) for kx in range(3)]


def conv2d_hwnc_plain(xh, w, bias=None, alpha=None, res=None, act="none", emit_pre=False):
    """Plain PyTorch version of K5 (``_fwd_kernel``, :252-301): nine tap
    matmuls of the stored values with fp32 accumulation; then, on the fp32
    sum, + bias, the pre-activation z (when ``emit_pre``), PReLU/ReLU,
    + res; one rounding to ``xh.dtype``. Returns y, or (y, z)."""
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    wf = w.to(torch.float32).reshape(9, w.shape[2], w.shape[3])
    acc = None
    for t, tap in enumerate(_taps(xh)):
        p = torch.matmul(tap, wf[t])
        acc = p if acc is None else acc + p
    if bias is not None:
        acc = acc + bias.to(torch.float32)
    z = acc.to(xh.dtype) if emit_pre else None
    if act == "prelu":
        acc = torch.clamp_min(acc, 0.0) + alpha.to(torch.float32) * torch.clamp_max(acc, 0.0)
    elif act == "relu":
        acc = torch.clamp_min(acc, 0.0)
    if res is not None:
        acc = acc + res.to(torch.float32)
    y = acc.to(xh.dtype)
    return (y, z) if emit_pre else y


def conv2d_wgrad_plain(xh: torch.Tensor, gz: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5w (``_wgrad_kernel``, :304-324):
    ``gw[ky, kx] = xpad_tap^T @ gz`` over all pixels, fp32 products of the
    stored values summed in fp32; fp32 ``[3, 3, C, co]``."""
    c, co = xh.shape[-1], gz.shape[-1]
    g = gz.to(torch.float32).reshape(-1, co)
    gw = torch.empty((9, c, co), dtype=torch.float32, device=xh.device)
    for t, tap in enumerate(_taps(xh)):
        gw[t] = tap.reshape(-1, c).t() @ g
    return gw.reshape(3, 3, c, co)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _check_cuda(x: torch.Tensor, others, what: str) -> None:
    if x.device.type != "cuda" or any(o.device != x.device for o in others):
        raise ValueError(f"{what}: every operand must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: float32 or bfloat16 storage, got {x.dtype}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _epilogue_name(bias, act, res, emit_pre) -> str:
    parts = (["bias"] if bias is not None else []) + ([act] if act != "none" else []) \
        + (["pre"] if emit_pre else []) + (["res"] if res is not None else [])
    return "+".join(parts) or "none"


def conv2d_hwnc(xh, w, bias=None, alpha=None, res=None, act="none", emit_pre=False):
    """The K5 wrapper: SAME stride-1 3x3 conv ``[H,W,B,C] @ [3,3,C,co]`` with
    the fused epilogue of :func:`conv2d_hwnc_plain` (bias and alpha are read
    as fp32; ``res`` is ``[H,W,B,co]``). Returns y, or (y, z) with
    ``emit_pre``, in ``xh``'s dtype. A CUDA tensor runs the K5 kernel,
    raising on what it cannot take (C % 32, co % 128, the dtypes); a CPU
    tensor runs the plain version."""
    if xh.device.type == "cpu":
        return conv2d_hwnc_plain(xh, w, bias, alpha, res, act, emit_pre)
    if act not in _ACTS or (act == "prelu") != (alpha is not None):
        raise ValueError(f"conv2d_hwnc: act {act!r} with alpha {alpha is not None}")
    opnds = [t for t in (w, bias, alpha, res) if t is not None]
    _check_cuda(xh, opnds, "conv2d_hwnc")
    if (xh.dim() != 4 or tuple(w.shape[:3]) != (3, 3, xh.shape[-1]) or w.dim() != 4
            or xh.shape[-1] % 32 or w.shape[-1] % 128):
        raise ValueError(f"conv2d_hwnc: {tuple(xh.shape)} @ {tuple(w.shape)} is outside the "
                         "kernel's envelope (3x3, C % 32 == 0, co % 128 == 0)")
    h, wd, b, c = xh.shape
    co = w.shape[-1]
    if res is not None and tuple(res.shape) != (h, wd, b, co):
        raise ValueError(f"conv2d_hwnc: residual {tuple(res.shape)} for output "
                         f"{(h, wd, b, co)}")
    x = _native.aligned(xh)
    w9 = _native.aligned(w.to(x.dtype))
    vec = [None if v is None else v.to(torch.float32).contiguous() for v in (bias, alpha)]
    if any(v is not None and v.numel() != co for v in vec):
        raise ValueError(f"conv2d_hwnc: bias / alpha must have {co} values")
    r = None if res is None else _native.aligned(res.to(x.dtype))
    y = torch.empty((h, wd, b, co), dtype=x.dtype, device=x.device)
    z = torch.empty_like(y) if emit_pre else None
    lib = _native.load("conv2d")
    lib.rn_conv2d.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    rc = lib.rn_conv2d(x.data_ptr(), w9.data_ptr(), _ptr(vec[0]), _ptr(vec[1]), _ptr(r),
                       y.data_ptr(), _ptr(z), _native.dtype_code(x.dtype), _ACTS[act],
                       h, wd, b, c, co, _native.stream_ptr(x))
    _native.check(lib, rc, "K5 conv2d")
    global launches
    launches += 1
    launches_by_shape[(h, wd, b, c), co, _epilogue_name(bias, act, res, emit_pre)] += 1
    return (y, z) if emit_pre else y


def conv2d_wgrad(xh: torch.Tensor, gz: torch.Tensor) -> torch.Tensor:
    """The K5w wrapper: the weight gradient ``[3, 3, C, co]`` (fp32) of the
    SAME stride-1 3x3 conv of ``xh`` ``[H,W,B,C]`` with output cotangent
    ``gz`` ``[H,W,B,co]``. A CUDA tensor runs the K5w kernel (raising on
    C % 128, co % 128 or mismatched operands); a CPU tensor runs
    :func:`conv2d_wgrad_plain`."""
    if xh.device.type == "cpu":
        return conv2d_wgrad_plain(xh, gz)
    _check_cuda(xh, [gz], "conv2d_wgrad")
    if (xh.dim() != 4 or gz.dim() != 4 or gz.dtype != xh.dtype
            or tuple(gz.shape[:3]) != tuple(xh.shape[:3])
            or xh.shape[-1] % 128 or gz.shape[-1] % 128):
        raise ValueError(f"conv2d_wgrad: x {tuple(xh.shape)} {xh.dtype}, gz {tuple(gz.shape)} "
                         f"{gz.dtype} is outside the kernel's envelope (C, co % 128 == 0)")
    h, wd, b, c = xh.shape
    co = gz.shape[-1]
    x, g = _native.aligned(xh), _native.aligned(gz)
    lib = _native.load("conv2d_wgrad")
    lib.rn_conv2d_wgrad_chunks.argtypes = [ctypes.c_int] * 5
    nchunks = lib.rn_conv2d_wgrad_chunks(h, wd, b, c, co)
    part = torch.empty(nchunks * 9 * c * co if nchunks > 1 else 0, dtype=torch.float32,
                       device=x.device)
    out = torch.empty((3, 3, c, co), dtype=torch.float32, device=x.device)
    lib.rn_conv2d_wgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = lib.rn_conv2d_wgrad(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(),
                             _native.dtype_code(x.dtype), h, wd, b, c, co,
                             _native.stream_ptr(x))
    _native.check(lib, rc, "K5w conv2d weight gradient")
    global wgrad_launches
    wgrad_launches += 1
    wgrad_launches_by_shape[(h, wd, b, c), co] += 1
    return out


# ---------------------------------------------------------------------------
# the differentiable ops (pallas_conv2d.py:476-614)
# ---------------------------------------------------------------------------
def _dgrad(gz: torch.Tensor, w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Data gradient: K5 on the cotangent with the flipped, io-swapped
    kernel (``_dgrad``, :427-432)."""
    return conv2d_hwnc(gz, flip_io(w)).to(dtype)


def _sum_hwn(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).sum(dim=(0, 1, 2))


def _grads(ctx, xh, w, gz):
    """(gx, gw) of the conv for cotangent ``gz``, each only where needed."""
    gx = _dgrad(gz, w, xh.dtype) if ctx.needs_input_grad[0] else None
    gw = conv2d_wgrad(xh, gz).to(w.dtype) if ctx.needs_input_grad[1] else None
    return gx, gw


class _Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, w):
        ctx.save_for_backward(xh, w)
        return conv2d_hwnc(xh, w)

    @staticmethod
    def backward(ctx, gy):
        xh, w = ctx.saved_tensors
        return _grads(ctx, xh, w, gy.to(xh.dtype))


class _ConvPrelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, w, b, alpha, save_pre):
        if save_pre:
            y, z = conv2d_hwnc(xh, w, bias=b, alpha=alpha, act="prelu", emit_pre=True)
            ctx.save_for_backward(xh, w, b, alpha, z)
        else:
            y = conv2d_hwnc(xh, w, bias=b, alpha=alpha, act="prelu")
            ctx.save_for_backward(xh, w, b, alpha)
        return y

    @staticmethod
    def backward(ctx, gy):
        xh, w, b, alpha, *saved = ctx.saved_tensors
        gy = gy.to(xh.dtype)
        # the pre-activation: saved, or recomputed with one bias-only call
        z = saved[0] if saved else conv2d_hwnc(xh, w, bias=b)
        gz = torch.where(z > 0, gy, alpha.to(gy.dtype) * gy)
        galpha = (gy.to(torch.float32) * torch.clamp_max(z.to(torch.float32), 0.0)).sum(
            dim=(0, 1, 2)).to(gy.dtype) if ctx.needs_input_grad[3] else None
        gb = _sum_hwn(gz).to(gy.dtype) if ctx.needs_input_grad[2] else None
        gx, gw = _grads(ctx, xh, w, gz)
        return gx, gw, gb, galpha, None


class _ConvRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, w, b):
        y = conv2d_hwnc(xh, w, bias=b, act="relu")
        ctx.save_for_backward(xh, w, y)
        return y

    @staticmethod
    def backward(ctx, gy):
        xh, w, y = ctx.saved_tensors
        gy = gy.to(xh.dtype)
        # y > 0 iff z > 0: a pre-activation of exactly 0 passes no gradient
        gz = torch.where(y > 0, gy, torch.zeros_like(gy))
        gb = _sum_hwn(gz).to(gy.dtype) if ctx.needs_input_grad[2] else None
        gx, gw = _grads(ctx, xh, w, gz)
        return gx, gw, gb


class _ConvRes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, w, b, res):
        ctx.save_for_backward(xh, w)
        return conv2d_hwnc(xh, w, bias=b, res=res)

    @staticmethod
    def backward(ctx, gy):
        xh, w = ctx.saved_tensors
        gy = gy.to(xh.dtype)
        gb = _sum_hwn(gy).to(gy.dtype) if ctx.needs_input_grad[2] else None
        gx, gw = _grads(ctx, xh, w, gy)
        return gx, gw, gb, gy


def wc_conv2d_hwnc(xh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3 conv, ``[H,W,B,C] @ [3,3,C,co] -> [H,W,B,co]``."""
    return _Conv.apply(xh, w)


def _grad_wanted(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def wc_conv2d_prelu_hwnc(xh, w, b, alpha):
    """Fused ``prelu(conv(xh, w) + b, alpha)``. The forward emits the
    pre-activation for the backward only when a gradient is wanted and
    :data:`PRELU_SAVE_PRE` is set."""
    save_pre = PRELU_SAVE_PRE and _grad_wanted(xh, w, b, alpha)
    return _ConvPrelu.apply(xh, w, b, alpha, save_pre)


def wc_conv2d_relu_hwnc(xh, w, b):
    """Fused ``relu(conv(xh, w) + b)``."""
    return _ConvRelu.apply(xh, w, b)


def wc_conv2d_res_hwnc(xh, w, b, res):
    """Fused ``conv(xh, w) + b + res``: a res block's second conv with the
    skip-add in the epilogue."""
    return _ConvRes.apply(xh, w, b, res)


def wc_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """NHWC ``[B,H,W,C] @ [3,3,C,co] -> [B,H,W,co]`` through
    :func:`wc_conv2d_hwnc`, a transpose on each side. A CUDA tensor outside
    :func:`wc_conv2d_supported` raises; CPU tensors take the plain
    versions."""
    if x.device.type != "cpu" and not wc_conv2d_supported(x.shape, w.shape, (1, 1)):
        raise ValueError(f"wc_conv2d: {tuple(x.shape)} @ {tuple(w.shape)} is outside the "
                         "envelope; gate calls with wc_conv2d_supported")
    return hwnc_to_nhwc(wc_conv2d_hwnc(nhwc_to_hwnc(x), w))
