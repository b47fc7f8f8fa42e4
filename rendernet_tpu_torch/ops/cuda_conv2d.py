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

Both kernels are persistent wgmma GEMMs fed by TMA (one CTA per SM, in
clusters of two that share one operand's loads), in bf16 and in fp32, where
every product runs on the TF32 tensor cores as three passes (hi.hi + hi.lo
+ lo.hi of each operand's split hi = tf32(a), lo = tf32(a - hi), written by
a pre-pass into scratch planes: :func:`split_floats`). Their schedules are
planned here and tested on the CPU (``tests/test_torch_conv2d_layout.py``,
the fp32 forms' arithmetic in ``tests/test_torch_tf32_split.py``):
:func:`conv2d_plan`, :func:`conv2d_tile` and :func:`conv2d_chains` for K5's
output tiles (128 pixels of one image row by 128 or 256 output channels)
and fp32 accumulator chains, :func:`wgrad_plan`, :func:`wgrad_item`,
:func:`wgrad_row_block` and :func:`wgrad_chains` for K5w's work items, its
pixel parts and accumulator chains.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch
import torch.nn.functional as F

from rendernet_tpu_torch.ops import _native
from rendernet_tpu_torch.ops.conv_grad import flip_io

__all__ = [
    "PRELU_SAVE_PRE",
    "conv2d_hwnc",
    "conv2d_chains",
    "conv2d_plan",
    "conv2d_tile",
    "conv2d_hwnc_plain",
    "conv2d_wgrad",
    "conv2d_wgrad_plain",
    "hwnc_to_nhwc",
    "kernel_weights",
    "nhwc_to_hwnc",
    "split_floats",
    "tile_n",
    "wc_conv2d",
    "wc_conv2d_hwnc",
    "wc_conv2d_prelu_hwnc",
    "wc_conv2d_relu_hwnc",
    "wc_conv2d_res_hwnc",
    "wc_conv2d_supported",
    "wgrad_batch_pitch",
    "wgrad_chains",
    "wgrad_item",
    "wgrad_plan",
    "wgrad_row_block",
    "wgrad_row_pitch",
    "wgrad_steps",
]

# The PReLU op's backward residual, as ``pallas_conv2d.PRELU_SAVE_PRE``
# (:118): True, the forward also emits the pre-activation z and the
# backward reads it; False, the backward recomputes z with one bias-only K5
# call.
PRELU_SAVE_PRE = True

# Launches since the last reset: K5 in all (``launches``) and by (input
# shape, output channels, epilogue) (forward convs, data gradients and z
# recomputes alike), K5w by (input shape, output channels)
# (``wgrad_launches_by_shape``). Shapes are HWNC. The CPU path launches
# none.
launches = 0
launches_by_shape: Counter = Counter()
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
# the kernels' persistent schedules (csrc/conv2d.cu, csrc/conv2d_wgrad.cu)
# ---------------------------------------------------------------------------
TILE_M = 128  # K5: pixels per output tile, along one image row's W * B axis
TILE_N_F32 = 128  # K5 fp32: output channels per tile (accumulators and their chains' total)
STEP_PIXELS = 64  # K5w bf16: pixels per K step, along one image row
STEP_PIXELS_F32 = 32  # K5w fp32: one 128-byte row of fp32 pixels
MAX_CHAIN_STEPS = 8192 // STEP_PIXELS  # K5w bf16: steps per fp32 accumulator chain
# The fp32 forms' accumulator chains on the TF32 tensor cores, whose fp32
# sums lose precision along a chain: K5's restart every CHAIN_STAGES_F32
# stages of 32 channels of one tap (the chains summed in fp32 beside the
# accumulators), K5w's every MAX_CHAIN_STEPS_F32 steps of 32 pixels (added
# into the partial in memory). Lengths from chip_smoke.py's ``chains``
# sweep of error and time against chain length.
CHAIN_STAGES_F32 = 1
MAX_CHAIN_STEPS_F32 = 1024 // STEP_PIXELS_F32
MAX_PART_BYTES = 512 << 20  # K5w's workspace of partial sums, at most
# One CTA's K step on a 132-SM H100 at the bf16 peak (989 TFLOP/s), and at
# three TF32 passes (495 TFLOP/s) in fp32: the cost model that sizes K5w's
# parts, in microseconds per output column.
_STEP_US_PER_COLUMN = 2 * 128 * 64 / (989e6 / 132)
_STEP_US_PER_COLUMN_F32 = 3 * 2 * 128 * STEP_PIXELS_F32 / (495e6 / 132)
_HBM_BYTES_PER_US = 3.35e6


def _f32(dtype) -> bool:
    return dtype == torch.float32


def tile_n(co: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The output channels of a K5 tile: bf16 256 where co allows it, else
    128; fp32 TILE_N_F32. K5w's: the bf16 rule in either dtype."""
    if _f32(dtype):
        return TILE_N_F32
    return 256 if co % 256 == 0 else 128


def conv2d_plan(x_shape, co: int, n_sm: int, dtype: torch.dtype = torch.bfloat16):
    """K5's schedule for HWNC ``x_shape``: ``(grid, bn, tiles_per_row,
    pairs)``. A tile is TILE_M pixels of one image row h by ``bn`` output
    channels (:func:`tile_n`); a row's W * B pixels take ``tiles_per_row``
    tiles, the last one masked on store. CTAs come in clusters of two that
    take tile pairs (two pixel tiles, one output tile: they share the weight
    boxes), one CTA per SM, never more pairs than there are: cluster k takes
    pairs k, k + grid / 2, ... (the kernel cuts the grid further to the
    clusters the card can hold at once)."""
    h, w, b, _ = x_shape
    bn = tile_n(co, dtype)
    tiles_per_row = -(-(w * b) // TILE_M)
    pairs = -(-(h * tiles_per_row) // 2) * (co // bn)
    return 2 * min(pairs, max(n_sm // 2, 1)), bn, tiles_per_row, pairs


def conv2d_tile(q: int, rank: int, x_shape, co: int, dtype: torch.dtype = torch.bfloat16):
    """Tile pair q of :func:`conv2d_plan` as CTA ``rank`` (0 or 1) of a
    cluster takes it, as the kernel decodes it (``tile_of``): ``(h, m0,
    n0)``, the image row, its first pixel along W * B and the first output
    channel. The pair's pixel tiles are 2 (q // (co / bn)) + rank; the co /
    bn pairs of one pixel-tile pair are adjacent. Past the last pixel tile
    (an odd count) h is H: a tile of nothing."""
    _, bn, tiles_per_row, _ = conv2d_plan(x_shape, co, 2, dtype)
    mp, nt = divmod(q, co // bn)
    h, mt = divmod(2 * mp + rank, tiles_per_row)
    return h, mt * TILE_M, nt * bn


def conv2d_chains(c: int, chain: int | None = None):
    """K5 fp32's accumulator chains over one tile's stages (tap, 32-channel
    chunk), ``9 * C / 32`` of them: ``[(first stage, end stage), ...]`` of
    ``chain`` (CHAIN_STAGES_F32) stages each, the last one shorter where
    they do not divide. The chains' sums are added in this order."""
    chain = CHAIN_STAGES_F32 if chain is None else chain
    nk = 9 * (c // 32)
    return [(k0, min(k0 + chain, nk)) for k0 in range(0, nk, chain)]


def kernel_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The weights as K5 reads them, from ``[3, 3, C, co]`` (JAX's HWIO),
    contiguous, 16-byte aligned, taps in (ky, kx) order: bf16 ``[9, C,
    co]``, the MN-major operand (the kernel's tensor map cuts it into boxes
    of 64 output x 64 input channels of one tap); fp32 K-major ``[9, co,
    C]`` (C contiguous; TF32 wgmma has no transpose mode), which the kernel
    splits into TF32 hi and lo planes and cuts into boxes of 32 input x 128
    output channels. A copy only where ``w`` is a strided view or of another
    dtype (the data gradient's flipped, io-swapped weights: in fp32 the
    K-major form of those is the flip itself)."""
    w9 = w.to(dtype).flatten(0, 1)
    if _f32(dtype):
        w9 = w9.transpose(1, 2)
    return _native.aligned(w9)


def wgrad_batch_pitch(b: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The batch as K5w lays out a row's pixels (w * pitch + b): bf16 B;
    fp32 B rounded up to 4, so that a tap's shift along the pixels, (kx -
    1) * pitch fp32 values, falls on 16 bytes, as a TMA box's inner
    coordinate must (the padded pixels are zeros)."""
    return -(-b // 4) * 4 if _f32(dtype) else b


def wgrad_steps(x_shape, dtype: torch.dtype = torch.bfloat16) -> int:
    """K5w's K steps over the whole image: STEP_PIXELS (bf16) or
    STEP_PIXELS_F32 pixels of one row (``W * wgrad_batch_pitch(B)``
    pixels) each, a row's last step masked."""
    h, w, b, _ = x_shape
    step = STEP_PIXELS_F32 if _f32(dtype) else STEP_PIXELS
    return h * -(-(w * wgrad_batch_pitch(b, dtype)) // step)


@functools.lru_cache(maxsize=256)
def wgrad_plan(dtype: torch.dtype, x_shape, co: int, n_sm: int):
    """K5w's ``(parts, grid)``: the pixel parts whose fp32 partial sums are
    added in part order (a workspace of ``parts * 9 * C * co`` floats when
    ``parts > 1``), and the persistent CTAs.

    A work item is (part, pair of row pairs, output tile), parts outermost,
    taken by a cluster of two CTAs (one row pair each, sharing the
    cotangent boxes); there are ``pairs = ceil(9 C / 256) * co / bn`` of
    them per part, and part p takes steps ``[S p / parts, S (p + 1) /
    parts)`` of the S = :func:`wgrad_steps`. ``parts`` minimises a cost
    model on ``n_sm / 2`` clusters: waves of items x steps per item (a bf16
    step at the bf16 peak, an fp32 one as three TF32 passes), plus the
    partials' bytes: read once and the result written once (bf16, the
    model its plans, and so its summation order, were set with), and in
    fp32 also the partials' writes, which keep a tiny image in one part."""
    c = x_shape[3]
    bn = tile_n(co)
    pairs = -(-(9 * c // 128) // 2) * (co // bn)
    clusters = max(n_sm // 2, 1)
    steps = wgrad_steps(x_shape, dtype)
    step_us = _STEP_US_PER_COLUMN_F32 if _f32(dtype) else _STEP_US_PER_COLUMN
    ws = 9 * c * co * 4
    best = None
    for parts in range(1, min(steps, 64) + 1):
        if parts > 1 and parts * ws > MAX_PART_BYTES:
            break
        cost = -(-pairs * parts // clusters) * -(-steps // parts) * step_us * bn
        if parts > 1:
            cost += ((2 if _f32(dtype) else 1) * parts + 1) * ws / _HBM_BYTES_PER_US
        if best is None or cost < best[0]:
            best = (cost, parts)
    parts = best[1]
    return parts, 2 * min(pairs * parts, clusters)


def wgrad_item(q: int, rank: int, x_shape, co: int, parts: int,
               dtype: torch.dtype = torch.bfloat16):
    """K5w's work item q as CTA ``rank`` (0 or 1) of a cluster takes it, as
    the kernel decodes it (``item_of``): ``(part, row pair, n0, first step,
    end step)``. The row pair is 2 (pair index) + rank; past the last row
    pair (an odd count, 9 C / 128) it is a pair of nothing, whose channels
    lie past C."""
    c = x_shape[3]
    bn = tile_n(co)
    per_part = -(-(9 * c // 128) // 2) * (co // bn)
    p, r = divmod(q, per_part)
    rpp, nt = divmod(r, co // bn)
    steps = wgrad_steps(x_shape, dtype)
    return p, 2 * rpp + rank, nt * bn, steps * p // parts, steps * (p + 1) // parts


def wgrad_row_block(rb: int):
    """Row block rb (64 channels of one tap) of K5w's 9 C rows: ``(tap, c0)``.
    Taken in (channel block, tap) order, so row pair rp = (2 rp, 2 rp + 1)
    is mostly two taps of one channel block."""
    return rb % 9, rb // 9 * 64


def wgrad_chains(s_begin: int, s_end: int, dtype: torch.dtype = torch.bfloat16):
    """The accumulator chains of one K5w work item: ``[(begin, end), ...]``,
    as equal as can be and at most MAX_CHAIN_STEPS (bf16, 8,192 pixels) or
    MAX_CHAIN_STEPS_F32 steps each. The first chain's sums are stored, each
    later chain's added to them in order."""
    n = s_end - s_begin
    k = -(-n // (MAX_CHAIN_STEPS_F32 if _f32(dtype) else MAX_CHAIN_STEPS))
    return [(s_begin + n * i // k, s_begin + n * (i + 1) // k) for i in range(k)]


def split_floats(x_shape, co: int, op: str) -> int:
    """The fp32 forms' scratch of TF32 hi / lo planes, in floats: K5
    (``op`` "conv2d") x's [2][H W B][C] and the weights' [2][9][co][C]; K5w
    ("wgrad") x's and gz's channel-major [2][C + co][H][Rp]
    (:func:`wgrad_row_pitch`)."""
    h, w, b, c = x_shape
    if op == "conv2d":
        return 2 * (h * w * b * c + 9 * co * c)
    return 2 * (c + co) * h * wgrad_row_pitch(x_shape)


def wgrad_row_pitch(x_shape) -> int:
    """K5w fp32's channel-major planes' row length: ``W * Bp``
    (:func:`wgrad_batch_pitch`) rounded up to a whole 32-pixel step (the
    pre-pass writes zeros past W * Bp, read as the SAME halo)."""
    return -(-(x_shape[1] * wgrad_batch_pitch(x_shape[2], torch.float32)) // 32) * 32


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
    w9 = kernel_weights(w, x.dtype)
    vec = [None if v is None else v.to(torch.float32).contiguous() for v in (bias, alpha)]
    if any(v is not None and v.numel() != co for v in vec):
        raise ValueError(f"conv2d_hwnc: bias / alpha must have {co} values")
    r = None if res is None else _native.aligned(res.to(x.dtype))
    y = torch.empty((h, wd, b, co), dtype=x.dtype, device=x.device)
    z = torch.empty_like(y) if emit_pre else None
    f32 = _f32(x.dtype)
    split = torch.empty(split_floats(x.shape, co, "conv2d") if f32 else 0, dtype=torch.float32,
                        device=x.device)
    grid = conv2d_plan(x.shape, co, _native.sm_count(x.device.index), x.dtype)[0]
    lib = _native.load("conv2d")
    lib.rn_conv2d.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    rc = lib.rn_conv2d(x.data_ptr(), w9.data_ptr(), _ptr(vec[0]), _ptr(vec[1]), _ptr(r),
                       y.data_ptr(), _ptr(z), split.data_ptr() if f32 else None,
                       _native.dtype_code(x.dtype), _ACTS[act], h, wd, b, c, co, grid,
                       CHAIN_STAGES_F32, _native.stream_ptr(x))
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
    parts, grid = wgrad_plan(x.dtype, x.shape, co, _native.sm_count(x.device.index))
    part = torch.empty(parts * 9 * c * co if parts > 1 else 0, dtype=torch.float32,
                       device=x.device)
    f32 = _f32(x.dtype)
    split = torch.empty(split_floats(x.shape, co, "wgrad") if f32 else 0, dtype=torch.float32,
                        device=x.device)
    out = torch.empty((3, 3, c, co), dtype=torch.float32, device=x.device)
    lib = _native.load("conv2d_wgrad")
    lib.rn_conv2d_wgrad.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    rc = lib.rn_conv2d_wgrad(x.data_ptr(), g.data_ptr(), part.data_ptr(), out.data_ptr(),
                             split.data_ptr() if f32 else None, _native.dtype_code(x.dtype), h,
                             wd, b, c, co, parts, grid, MAX_CHAIN_STEPS_F32,
                             _native.stream_ptr(x))
    _native.check(lib, rc, "K5w conv2d weight gradient")
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
