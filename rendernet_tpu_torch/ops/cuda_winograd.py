"""Fused Winograd F(2x2,3x3) conv for the wide 2D res stacks on the K3 CUDA
kernel (``csrc/winograd.cu``), with its gradient: the data gradient on K3
itself and, when :data:`WGRAD` is set, the transform-domain weight gradient
on the K6 kernels (``csrc/winograd_wgrad.cu``).

Counterpart of ``rendernet_tpu/ops/pallas_winograd.py``. :func:`wino_conv2d`
is the differentiable op (``_fwd`` / ``_bwd``, :455-500);
:func:`wino_conv2d_forward` and :func:`wino_wgrad` are the two kernels'
wrappers. The plain versions are ``ops.winograd.winograd3x3`` and
``ops.winograd.wino_wgrad_plain``.

K6's GEMM is persistent (one CTA per SM, in clusters of two that share the
cotangent operand's loads). Its schedule is planned here and handed to the
kernel as a table (:func:`wino_wgrad_table`, built from
:func:`wino_wgrad_plan`, :func:`wino_wgrad_item` and
:func:`wino_wgrad_chains`), so the CPU tests
(``tests/test_torch_wino_wgrad_layout.py``) hold the schedule the kernel runs.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from rendernet_tpu_torch.ops import _native
from rendernet_tpu_torch.ops.conv_grad import flip_io, plain_conv_wgrad
from rendernet_tpu_torch.ops.cuda_conv2d import tile_n
from rendernet_tpu_torch.ops.winograd import winograd3x3, wino_wgrad_plain

__all__ = [
    "WGRAD",
    "wino_conv2d",
    "wino_conv2d_forward",
    "wino_conv2d_plain",
    "wino_conv2d_supported",
    "v_scratch_bytes",
    "wgrad_scratch_bytes",
    "wgrad_split",
    "wino_wgrad",
    "wino_wgrad_chains",
    "wino_wgrad_item",
    "wino_wgrad_plain",
    "wino_wgrad_plan",
    "wino_wgrad_steps",
    "wino_wgrad_table",
]

# The backward's weight gradient, as ``pallas_winograd.WGRAD`` (:316):
#   False  - the direct conv weight gradient (torch.nn.grad.conv2d_weight,
#            cuDNN on the card; JAX leaves it to XLA the same way);
#   True   - K6 with GEMM operands in the activations' dtype;
#   "fp32" - K6 with fp32 GEMM operands (on the card each operand is two bf16
#            planes, hi and lo, and the GEMM adds three bf16 products).
WGRAD = False

# Launches since the last reset: K3 in all (``launches``) and by (input
# shape, output channels) (forward convs and data gradients alike), K6 by
# (input shape, output channels) (``wgrad_launches_by_shape``). The CPU
# path launches none.
launches = 0
launches_by_shape: Counter = Counter()
wgrad_launches_by_shape: Counter = Counter()

wino_conv2d_plain = winograd3x3


# The TPU kernel's tiling fit, copied from ``pallas_winograd.py:12,23-116``
# (without its benchmark hook ``TILE_OVERRIDE``) so that the port routes
# exactly the convs JAX routes to its kernel.
_VMEM_LIMIT = 100 * 1024 * 1024


def _vmem_bytes(nw, bb, cch, bn, th, xbytes):
    """``pallas_winograd._vmem_bytes``: the TPU kernel's working set."""
    u = 16 * cch * bn * xbytes
    xrows = 2 * (2 * th + 2) * (2 * nw + 2) * bb * cch * xbytes
    v = 16 * nw * bb * cch * 4
    m = 16 * nw * bb * bn * 4
    y = 2 * (2 * th) * (2 * nw) * bb * bn * xbytes
    return u + xrows + v + m + y


def _tiles(h, w, b, cch, co, xbytes):
    """``pallas_winograd._tiles``: the first (bn, bb, th) whose working set
    fits half the TPU kernel's scoped VMEM, or None."""
    nw = w // 2
    nh = h // 2
    for bn in (512, 256, 128):
        if co % bn:
            continue
        for bb in (8, 16, b):
            if b % bb or (bb % 8 and bb != b):
                continue
            for th in (1, 2):
                if nh % th:
                    continue
                if _vmem_bytes(nw, bb, cch, bn, th, xbytes) <= _VMEM_LIMIT // 2:
                    return (bn, bb, th)
    return None


def wino_conv2d_supported(x_shape, w_shape, stride, dtype: torch.dtype) -> bool:
    """The envelope of ``pallas_winograd.wino_conv2d_supported`` (:118-144),
    clause for clause, so that both packages send the same convs to their
    Winograd kernels: SAME 3x3 stride 1, even H and W, ci >= 256, ci and co
    multiples of 128, batch >= 8 (at batch 1 the JAX kernel was measured
    slower than the plain conv, so single frames keep the conv path), and
    the TPU kernel's tiling fit (``_tiles``) in both orientations, since the
    data gradient runs the kernel with ci and co swapped. ``dtype`` is the
    activations' dtype: the fit depends on its itemsize. The CUDA kernels'
    own tiles are fixed and fit every shape inside this envelope
    (:func:`_kernel_fits`); the TPU's clause is kept for routing alone."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    kh, kw, ci, co = w_shape
    if (kh, kw) != (3, 3) or tuple(stride) != (1, 1):
        return False
    b, h, w, c = x_shape
    if c != ci or ci % 128 or co % 128 or ci < 256:
        return False
    if h % 2 or w % 2 or b < 8:
        return False
    xbytes = torch.tensor([], dtype=dtype).element_size()
    return (_tiles(h, w, b, ci, co, xbytes) is not None
            and _tiles(h, w, b, co, ci, xbytes) is not None)


def _check(x: torch.Tensor, other: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda" or other.device != x.device:
        raise ValueError(f"{what}: both operands must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: float32 or bfloat16 storage, got {x.dtype}")


def _kernel_fits(x_shape, k: int, dtype: torch.dtype) -> bool:
    """What K3 itself needs: NHWC, even H and W; in bf16 C % 64 (one
    64-channel stage of the wgmma GEMMs) and K % 128 (pairs of 64-channel
    blocks, one per CTA of a cluster), in fp32 C % 16 and K % 64 (the GEMM
    reads zeros past C in its 32-channel stages, and a cluster's second
    block past K writes nothing). The data gradient runs K3 on the
    io-swapped weights, whose channel counts the envelope's multiples of
    128 keep in range."""
    cstep, kstep = (64, 128) if dtype == torch.bfloat16 else (16, 64)
    return (len(x_shape) == 4 and x_shape[1] % 2 == 0 and x_shape[2] % 2 == 0
            and x_shape[3] % cstep == 0 and k % kstep == 0)


def v_scratch_bytes(x_shape, dtype: torch.dtype) -> int:
    """Bytes of the V scratch ``[16, B * H/2 * W/2, C]`` that one K3 call
    allocates (its input transform's output), in the storage dtype."""
    b, h, w, c = x_shape
    return 16 * b * (h // 2) * (w // 2) * c * torch.tensor([], dtype=dtype).element_size()


def wino_conv2d_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The K3 wrapper: SAME stride-1 3x3 conv ``[B,H,W,C] @ [3,3,C,K]`` via
    Winograd. A CUDA tensor runs the K3 kernel (raising on a shape the
    kernel cannot take); a CPU tensor runs the plain version. The C entry
    forms U = G w G^T in fp32 into a scratch buffer (cast to bf16
    ``[16, K, C]``, or in fp32 its TF32 split, hi and lo planes ``[2, 16,
    K, C]``), writes V = B^T d B into a second scratch ``[16, tiles, C]``
    in ``x.dtype``, and runs the 16 GEMMs (fp32 products as three TF32
    passes) and the output transform. One launch is counted per call."""
    if x.device.type == "cpu":
        return wino_conv2d_plain(x, w)
    _check(x, w, "wino_conv2d")
    if tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[-1] or not _kernel_fits(
            x.shape, w.shape[-1], x.dtype):
        raise ValueError(f"wino_conv2d: {tuple(x.shape)} @ {tuple(w.shape)} is outside "
                         "the kernel's envelope; gate calls with wino_conv2d_supported")
    b, h, wd, c = x.shape
    k = w.shape[-1]
    x = _native.aligned(x)
    w = w.to(x.dtype).contiguous()
    bf16 = x.dtype == torch.bfloat16
    u = torch.empty((16, k, c) if bf16 else (2, 16, k, c), dtype=x.dtype, device=x.device)
    v = torch.empty(v_scratch_bytes(x.shape, x.dtype) // x.element_size(), dtype=x.dtype,
                    device=x.device)
    out = torch.empty((b, h, wd, k), dtype=x.dtype, device=x.device)
    lib = _native.load("winograd")
    lib.rn_winograd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = lib.rn_winograd(x.data_ptr(), w.data_ptr(), u.data_ptr(), v.data_ptr(),
                         out.data_ptr(), _native.dtype_code(x.dtype), b, h, wd, c, k,
                         _native.stream_ptr(x))
    _native.check(lib, rc, "K3 winograd")
    global launches
    launches += 1
    launches_by_shape[(b, h, wd, c), k] += 1
    return out


# ---------------------------------------------------------------------------
# K6's schedule (csrc/winograd_wgrad.cu, k6_gemm)
# ---------------------------------------------------------------------------
WGRAD_C_BLOCK = 128  # input channels (GEMM rows) per CTA: two warpgroups x 64
MAX_CHAIN_TILES = 8192  # tiles per fp32 accumulator chain
MAX_PART_BYTES = 512 << 20  # the workspace of partial sums, at most (beyond one part)
# One CTA's step on a 132-SM H100 at the bf16 peak (989 TFLOP/s), in
# microseconds per tile per output column per bf16 pass: the cost model
# that sizes the parts.
_TILE_US_PER_COLUMN = 2 * WGRAD_C_BLOCK / (989e6 / 132)
_HBM_BYTES_PER_US = 3.35e6


def wgrad_split(dtype: torch.dtype, fp32_operands) -> bool:
    """Whether K6 takes each operand as two bf16 planes (hi, lo) for fp32
    products: with fp32 operands, and always with fp32 storage."""
    return dtype == torch.float32 or bool(fp32_operands)


def _step_tiles(split: bool) -> int:
    """Tiles per GEMM step: 64, or 32 in the split form (whose stage holds
    both planes in the same 48 or 32 KB)."""
    return 32 if split else 64


def _items_per_part(c: int, k: int) -> int:
    """Cluster work items per part: 16 frequencies x pairs of 128-channel C
    blocks x output tiles."""
    return 16 * -(-(c // WGRAD_C_BLOCK) // 2) * (k // tile_n(k))


def wino_wgrad_steps(x_shape, split: bool) -> int:
    """K6's GEMM steps over all T = B * H/2 * W/2 tiles, the last one
    zero-filled past T."""
    b, h, w, _ = x_shape
    return -(-(b * (h // 2) * (w // 2)) // _step_tiles(split))


@functools.lru_cache(maxsize=256)
def wino_wgrad_plan(x_shape, k: int, split: bool, n_sm: int):
    """K6's ``(parts, grid)``: the parts of T whose fp32 partial sums are
    added in part order (a workspace of ``parts * 16 * C * K`` floats), and
    the GEMM's persistent CTAs (two per cluster). Part p takes steps ``[S p
    / parts, S (p + 1) / parts)`` of the S = :func:`wino_wgrad_steps`.
    ``parts`` minimises a cost model on ``n_sm / 2`` clusters: waves of
    items x steps per item, plus the bytes of partials the fold reads."""
    c = x_shape[-1]
    items = _items_per_part(c, k)
    clusters = max(n_sm // 2, 1)
    steps = wino_wgrad_steps(x_shape, split)
    ws = 16 * c * k * 4
    step_us = (3 if split else 1) * _step_tiles(split) * tile_n(k) * _TILE_US_PER_COLUMN
    best = None
    for parts in range(1, min(steps, 64) + 1):
        if parts > 1 and parts * ws > MAX_PART_BYTES:
            break
        cost = -(-items * parts // clusters) * -(-steps // parts) * step_us
        cost += parts * ws / _HBM_BYTES_PER_US
        if best is None or cost < best[0]:
            best = (cost, parts)
    parts = best[1]
    return parts, 2 * min(items * parts, clusters)


def wino_wgrad_item(q: int, x_shape, k: int, split: bool, parts: int):
    """K6's work item q: ``(part, frequency, C-block pair, n0, first step,
    end step)``. Items run parts outermost, then frequency, then pairs of C
    blocks, then output tiles, so the clusters at work at once hold the
    (C, K) tiles of a few frequencies and walk T together. CTA ``rank`` (0
    or 1) of the cluster that takes the item sums C block 2 (pair) + rank;
    past the last one (an odd count, C / 128) that is a block of nothing,
    whose channels lie past C."""
    c = x_shape[-1]
    bn = tile_n(k)
    per_f = _items_per_part(c, k) // 16
    p, r = divmod(q, 16 * per_f)
    f, r = divmod(r, per_f)
    cp, nt = divmod(r, k // bn)
    steps = wino_wgrad_steps(x_shape, split)
    return p, f, cp, nt * bn, steps * p // parts, steps * (p + 1) // parts


def wino_wgrad_chains(s_begin: int, s_end: int, split: bool):
    """The accumulator chains of one K6 work item: ``[(begin, end), ...]``
    in steps, as equal as can be and at most MAX_CHAIN_TILES tiles each.
    The first chain's sums are stored, each later chain's added to them in
    order."""
    n = s_end - s_begin
    kk = -(-n // (MAX_CHAIN_TILES // _step_tiles(split)))
    return [(s_begin + n * i // kk, s_begin + n * (i + 1) // kk) for i in range(kk)]


WGRAD_ITEM_INTS = 6  # ints per item row of wino_wgrad_table


@functools.lru_cache(maxsize=256)
def wino_wgrad_table(x_shape, k: int, split: bool, parts: int) -> tuple:
    """K6's schedule as ``k6_gemm`` reads it, int32: first a row per work
    item q, ``(part, frequency, C-block pair, n0, first chain, end chain)``
    (:func:`wino_wgrad_item`), then a ``(first step, end step)`` pair per
    chain (:func:`wino_wgrad_chains`), item q's chains being ``[first
    chain, end chain)``. The kernel only adds the CTA's rank to the C block
    and multiplies steps by :func:`_step_tiles` tiles."""
    n = _items_per_part(x_shape[-1], k) * parts
    rows, chains = [], []
    for q in range(n):
        p, f, cp, n0, s0, s1 = wino_wgrad_item(q, x_shape, k, split, parts)
        cq = wino_wgrad_chains(s0, s1, split)
        rows += [p, f, cp, n0, len(chains) // 2, len(chains) // 2 + len(cq)]
        chains += [s for ch in cq for s in ch]
    return tuple(rows + chains)


@functools.lru_cache(maxsize=64)
def _device_table(x_shape, k: int, split: bool, parts: int, device: torch.device):
    return torch.tensor(wino_wgrad_table(x_shape, k, split, parts), dtype=torch.int32,
                        device=device)


def wgrad_scratch_bytes(x_shape, k: int, dtype: torch.dtype, fp32_operands, n_sm: int) -> int:
    """Bytes of scratch one K6 call allocates: V ``[P, 16, T, C]`` and dM
    ``[P, 16, T, K]`` in bf16 (P = 2 in the split form) and the parts'
    fp32 workspace."""
    b, h, w, c = x_shape
    split = wgrad_split(dtype, fp32_operands)
    t = b * (h // 2) * (w // 2)
    parts, _ = wino_wgrad_plan(tuple(x_shape), k, split, n_sm)
    return (2 if split else 1) * 16 * t * (c + k) * 2 + parts * 16 * c * k * 4


def wino_wgrad(x: torch.Tensor, gy: torch.Tensor, fp32_operands: bool | None = None
               ) -> torch.Tensor:
    """The K6 wrapper: the weight gradient ``[3, 3, C, K]`` (fp32) of the
    SAME stride-1 3x3 conv of ``x`` ``[B,H,W,C]`` with output cotangent
    ``gy`` ``[B,H,W,K]``, contracted in the Winograd domain. ``fp32_operands``
    defaults to ``WGRAD == "fp32"``; with fp32 activations the operands are
    fp32 either way. A CUDA tensor inside :func:`wino_conv2d_supported` runs
    K6 (any other CUDA input raises): the input transform into a V scratch,
    the cotangent spread into a dM scratch (both bf16, as hi / lo planes
    for fp32 operands), the 16 GEMMs into fp32 parts on the schedule of
    :func:`wino_wgrad_table`, and the parts' sum and fold; one launch is
    counted per call. A CPU tensor runs
    ``wino_wgrad_plain``."""
    if fp32_operands is None:
        fp32_operands = WGRAD == "fp32"
    if x.device.type == "cpu":
        return wino_wgrad_plain(x, gy, fp32_operands)
    _check(x, gy, "wino_wgrad")
    b, h, wd, c = x.shape
    k = gy.shape[-1]
    if (gy.dtype != x.dtype or tuple(gy.shape[:-1]) != (b, h, wd)
            or not wino_conv2d_supported(x.shape, (3, 3, c, k), (1, 1), x.dtype)):
        raise ValueError(f"wino_wgrad: x {tuple(x.shape)}, gy {tuple(gy.shape)} is outside "
                         "the kernel's envelope; gate calls with wino_conv2d_supported")
    x, gy = _native.aligned(x), _native.aligned(gy)
    split = wgrad_split(x.dtype, fp32_operands)
    shape = tuple(x.shape)
    parts, grid = wino_wgrad_plan(shape, k, split, _native.sm_count(x.device.index))
    table = _device_table(shape, k, split, parts, x.device)
    planes, t = 1 + split, b * (h // 2) * (wd // 2)
    v = torch.empty((planes, 16, t, c), dtype=torch.bfloat16, device=x.device)
    dm = torch.empty((planes, 16, t, k), dtype=torch.bfloat16, device=x.device)
    part = torch.empty(parts * 16 * c * k, dtype=torch.float32, device=x.device)
    out = torch.empty((3, 3, c, k), dtype=torch.float32, device=x.device)
    lib = _native.load("winograd_wgrad")
    lib.rn_wino_wgrad.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    rc = lib.rn_wino_wgrad(x.data_ptr(), gy.data_ptr(), v.data_ptr(), dm.data_ptr(),
                           part.data_ptr(), out.data_ptr(), table.data_ptr(),
                           _native.dtype_code(x.dtype), int(split), _step_tiles(split), b, h, wd,
                           c, k, parts, _items_per_part(c, k) * parts, grid,
                           _native.stream_ptr(x))
    _native.check(lib, rc, "K6 winograd weight gradient")
    wgrad_launches_by_shape[(b, h, wd, c), k] += 1
    return out


def weight_grad(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """The backward's weight gradient ``[3, 3, C, K]`` as :data:`WGRAD`
    selects it: K6 (fp32), or the direct one in ``x.dtype``."""
    if WGRAD:
        return wino_wgrad(x, gy)
    return plain_conv_wgrad(x, gy, (3, 3, x.shape[-1], gy.shape[-1]))


class _WinoConv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return wino_conv2d_forward(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(x.dtype)
        gx = wino_conv2d_forward(gy, flip_io(w)) if ctx.needs_input_grad[0] else None
        gw = weight_grad(x, gy).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def wino_conv2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3 conv ``[B,H,W,C] @ [3,3,C,K]`` via Winograd,
    differentiable in both arguments: forward and data gradient on K3 (the
    latter on the flipped, io-swapped weights), weight gradient as
    :data:`WGRAD` selects. A CUDA tensor outside
    :func:`wino_conv2d_supported` raises; CPU tensors take the plain
    versions."""
    if x.device.type != "cpu" and not wino_conv2d_supported(x.shape, w.shape, (1, 1), x.dtype):
        raise ValueError(f"wino_conv2d: {tuple(x.shape)} @ {tuple(w.shape)} is outside "
                         "the kernel's envelope; gate calls with wino_conv2d_supported")
    return _WinoConv2d.apply(x, w)
