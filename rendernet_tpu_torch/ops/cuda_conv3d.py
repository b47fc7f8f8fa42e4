"""Narrow-channel SAME 3x3x3 stride-1 conv on the K2 CUDA kernel
(``csrc/conv3d.cu``), with its gradient: the data gradient on K2 itself and
the weight gradient on the K2w kernel (``csrc/conv3d_wgrad.cu``).

Counterpart of ``rendernet_tpu/ops/pallas_conv3d.py``: ``[B,H,W,D,C] @
[3,3,3,C,co] -> [B,H,W,D,co]`` with fp32 accumulation, for co in {16, 32,
64}. :func:`nc_conv3d` is the differentiable op (``_nc_fwd`` /
``_nc_bwd``, :283-345); :func:`nc_conv3d_forward` and
:func:`nc_conv3d_wgrad` are the two kernels' wrappers.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as F

from rendernet_tpu_torch.ops import _native
from rendernet_tpu_torch.ops.conv_grad import flip_io

__all__ = [
    "nc_conv3d",
    "nc_conv3d_forward",
    "nc_conv3d_plain",
    "nc_conv3d_supported",
    "nc_conv3d_wgrad",
    "nc_conv3d_wgrad_plain",
]

# Launches since the last reset: K2 in all (``launches``) and by (input
# shape, output channels) (forward convs and data gradients alike), K2w by
# (input shape, output channels) (``wgrad_launches_by_shape``). The CPU
# path launches none.
launches = 0
launches_by_shape: Counter = Counter()
wgrad_launches_by_shape: Counter = Counter()


def nc_conv3d_supported(x_shape, w_shape, stride) -> bool:
    """The envelope of ``pallas_conv3d.nc_conv3d_supported`` (:66-83), kept
    as it is so that the two packages route the same convs to their
    kernels. The depth clauses come from the TPU kernel's 128-lane depth
    packing; the CUDA kernels mask their own edges and need none of them."""
    if len(x_shape) != 5 or len(w_shape) != 5:
        return False
    kh, kw, kd, ci, co = w_shape
    if (kh, kw, kd) != (3, 3, 3) or any(s != 1 for s in stride):
        return False
    if co not in (16, 32, 64):
        return False
    f = 128 // co
    b, h, wdim, d, c = x_shape
    if c != ci:
        return False
    return d % f == 0 and d // f >= 1 and (wdim * (d // f)) % 8 == 0 and h >= 1


def nc_conv3d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: the 27 taps as fp32 products of the
    stored values, summed in fp32, rounded once to ``x.dtype``."""
    b, h, wd, d, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)).to(torch.float32)
    wf = w.to(torch.float32)
    y = None
    for kh in range(3):
        for kw in range(3):
            for kd in range(3):
                tap = torch.matmul(xp[:, kh:kh + h, kw:kw + wd, kd:kd + d, :], wf[kh, kw, kd])
                y = tap if y is None else y + tap
    return y.to(x.dtype)


def nc_conv3d_wgrad_plain(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2w: ``gw[kh,kw,kd] = xpad_tap^T @ gy`` over
    all positions, fp32 products of the stored values summed in fp32;
    returns fp32 ``[3, 3, 3, C, co]``."""
    b, h, wd, d, c = x.shape
    co = gy.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)).to(torch.float32)
    g = gy.to(torch.float32).reshape(-1, co)
    gw = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=x.device)
    for kh in range(3):
        for kw in range(3):
            for kd in range(3):
                tap = xp[:, kh:kh + h, kw:kw + wd, kd:kd + d, :].reshape(-1, c)
                gw[kh, kw, kd] = tap.t() @ g
    return gw


# The bf16 tensor-core kernels' column of positions (csrc/conv3d_tile.cuh:
# TW x TD): a row is TILE_W x TILE_D positions of one (b, h).
TILE_W, TILE_D = 8, 32
# K2's fp32 tensor-core kernel (csrc/conv3d.cu: F_TW, F_RING, F_CO): rows of
# TILE_W_F32 x TILE_D positions, a ring of RING_F32 halo planes, at most
# CO_F32 output channels' weights per CTA (co = 64 runs two slices). K2w's
# fp32 kernel (csrc/conv3d_wgrad.cu) walks the same rows.
TILE_W_F32, RING_F32, CO_F32 = 4, 4, 32
SMEM_PER_SM = 233472  # an H100 SM's shared memory; 1 KB of it is reserved per CTA


def conv3d_rows(x_shape, dtype: torch.dtype = torch.bfloat16) -> int:
    """Rows of the tensor-core kernels' walk: one per (b, W tile, D tile,
    h), with the dtype's W tile."""
    b, h, w, d, _ = x_shape
    tw = TILE_W_F32 if dtype == torch.float32 else TILE_W
    return b * -(-w // tw) * -(-d // TILE_D) * h


def tf32_smem_bytes(c: int, co: int) -> int:
    """Shared memory of one CTA of K2's fp32 kernel (``tf32_smem_bytes``):
    the resident weights of C rounded up to 16 or 32 channels and the CTA's
    slice of co, and the ring of halo planes."""
    cp, cs = (16 if c <= 16 else 32), min(co, CO_F32)
    return 128 + 27 * cp * cs * 4 + RING_F32 * (TILE_W_F32 + 2) * (TILE_D + 2) * cp * 4


def conv3d_plan(x_shape, n_sm: int, dtype: torch.dtype = torch.bfloat16, co: int = 32) -> int:
    """K2's persistent grid (CTAs per slice of output channels) on its
    tensor-core paths, never more CTAs than rows; CTA i of a slice walks
    rows ``[rows * i // grid, rows * (i + 1) // grid)``. bf16: one CTA per
    SM (its weights and ring take most of an SM's shared memory). fp32: as
    many CTAs as the SMs hold by shared memory (two at 16 input channels),
    shared among the slices of co (two at co = 64). C > 32 runs the
    CUDA-core kernel, which ignores the grid."""
    c = x_shape[-1]
    if dtype != torch.float32 or c > 32:
        return min(conv3d_rows(x_shape), n_sm)
    per_sm = SMEM_PER_SM // (tf32_smem_bytes(c, co) + 1024)
    slices = max(co // CO_F32, 1)
    return min(conv3d_rows(x_shape, dtype), max(n_sm * per_sm // slices, 1))


def wgrad_plan(dtype: torch.dtype, x_shape, co: int, n_sm: int):
    """K2w's partial sums: ``(parts, cpad)``, the workspace being ``parts *
    27 * cpad * co`` fp32 values and ``parts`` the CTAs over positions.

    A CTA owns a slice of up to 32 input x 32 output channels (16 x 16
    where C or co is 16); ``cpad`` is C rounded up to the slice width, and
    the ``n_sm`` CTAs, one per SM, are shared among the slices, never more
    than the rows of the dtype's walk (bf16 8 W x 32 D, fp32 4 W x 32 D)."""
    c = x_shape[-1]
    cs, os_ = (16 if c <= 16 else 32), (16 if co == 16 else 32)
    slices = -(-c // cs) * (co // os_)
    return max(1, min(conv3d_rows(x_shape, dtype), n_sm // slices)), -(-c // cs) * cs


# fp32 K2w's accumulator chains: a CTA's rows are cut into chains of at most
# this many rows (128 positions each), each summed from zero and added into
# the CTA's partial. ``chip_smoke.py``'s ``chains`` line gives the error and
# ms per length at res1, batches 8 and 24; one chain per CTA misses the 1e-4
# gate at batch 24.
WGRAD_CHAIN_ROWS_F32 = 4


def wgrad_chains(r0: int, r1: int):
    """fp32 K2w's chains of a CTA's rows ``[r0, r1)``: ``[r0 + k L, min(r0 +
    (k + 1) L, r1))`` in order, L = :data:`WGRAD_CHAIN_ROWS_F32`. The first
    is stored into the CTA's partial, each later one added to it."""
    return [(a, min(a + WGRAD_CHAIN_ROWS_F32, r1))
            for a in range(r0, r1, WGRAD_CHAIN_ROWS_F32)]


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """The weights as K2 reads them: ``[3, 3, 3, C, co]`` (JAX's layout) as a
    contiguous, 16-byte aligned ``[27, C, co]``; a copy only where ``w`` is
    a strided view, such as the data gradient's flipped, io-swapped
    weights. Each CTA pads them to its channel step in shared memory."""
    return _native.aligned(w.reshape(27, w.shape[3], w.shape[4]))


def _check_cuda(x: torch.Tensor, other: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda" or other.device != x.device or other.dtype != x.dtype:
        raise ValueError(f"{what}: both operands must be on one CUDA device, in one dtype")


def nc_conv3d_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The K2 wrapper: SAME stride-1 3x3x3 conv, ``[B,H,W,D,C] @ [3,3,3,C,co]``.

    A CUDA tensor inside :func:`nc_conv3d_supported` runs the K2 kernel (any
    other CUDA input raises); a CPU tensor runs :func:`nc_conv3d_plain`. The
    kernel reads the weights as ``[27, C, co]``, copied only where ``w`` is
    a strided view (the data gradient's flipped weights).
    """
    if x.device.type == "cpu":
        return nc_conv3d_plain(x, w)
    _check_cuda(x, w, "nc_conv3d")
    if not nc_conv3d_supported(x.shape, w.shape, (1, 1, 1)):
        raise ValueError(f"nc_conv3d: {tuple(x.shape)} @ {tuple(w.shape)} is outside "
                         "the kernel's envelope; gate calls with nc_conv3d_supported")
    b, h, wd, d, c = x.shape
    co = w.shape[-1]
    x, wk = _native.aligned(x), kernel_weights(w)
    out = torch.empty((b, h, wd, d, co), dtype=x.dtype, device=x.device)
    lib = _native.load("conv3d")
    lib.rn_conv3d.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    grid = conv3d_plan(x.shape, _native.sm_count(x.device.index), x.dtype, co)
    rc = lib.rn_conv3d(x.data_ptr(), wk.data_ptr(), out.data_ptr(), _native.dtype_code(x.dtype),
                       b, h, wd, d, c, co, grid, _native.stream_ptr(x))
    _native.check(lib, rc, "K2 conv3d")
    global launches
    launches += 1
    launches_by_shape[(b, h, wd, d, c), co] += 1
    return out


def nc_conv3d_wgrad(x: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """The K2w wrapper: the weight gradient ``[3, 3, 3, C, co]`` (fp32) of
    the SAME stride-1 3x3x3 conv of ``x`` ``[B,H,W,D,C]`` with output
    cotangent ``gy`` ``[B,H,W,D,co]``.

    A CUDA tensor inside :func:`nc_conv3d_supported` runs the K2w kernel
    (any other CUDA input raises); a CPU tensor runs
    :func:`nc_conv3d_wgrad_plain`. The partial-sum workspace is sized by
    :func:`wgrad_plan`.
    """
    if x.device.type == "cpu":
        return nc_conv3d_wgrad_plain(x, gy)
    _check_cuda(x, gy, "nc_conv3d_wgrad")
    b, h, wd, d, c = x.shape
    co = gy.shape[-1]
    if (tuple(gy.shape[:-1]) != (b, h, wd, d)
            or not nc_conv3d_supported(x.shape, (3, 3, 3, c, co), (1, 1, 1))):
        raise ValueError(f"nc_conv3d_wgrad: x {tuple(x.shape)}, gy {tuple(gy.shape)} is "
                         "outside the kernel's envelope; gate calls with nc_conv3d_supported")
    x, gy = _native.aligned(x), _native.aligned(gy)
    parts, cpad = wgrad_plan(x.dtype, x.shape, co, _native.sm_count(x.device.index))
    part = torch.empty(parts * 27 * cpad * co, dtype=torch.float32, device=x.device)
    out = torch.empty((3, 3, 3, c, co), dtype=torch.float32, device=x.device)
    lib = _native.load("conv3d_wgrad")
    lib.rn_conv3d_wgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    rc = lib.rn_conv3d_wgrad(x.data_ptr(), gy.data_ptr(), part.data_ptr(), out.data_ptr(),
                             _native.dtype_code(x.dtype), b, h, wd, d, c, co, parts, cpad,
                             WGRAD_CHAIN_ROWS_F32, _native.stream_ptr(x))
    _native.check(lib, rc, "K2w conv3d weight gradient")
    wgrad_launches_by_shape[(b, h, wd, d, c), co] += 1
    return out


def conv3d_dgrad(gy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Data gradient of the SAME stride-1 3x3x3 conv: the same conv of the
    cotangent with the flipped, io-swapped kernel, on K2 inside its
    envelope and as a plain conv outside it (``_nc_bwd``, :307-314)."""
    wf = flip_io(w)
    if nc_conv3d_supported(gy.shape, wf.shape, (1, 1, 1)):
        return nc_conv3d_forward(gy, wf)
    y = F.conv3d(gy.movedim(-1, 1), wf.permute(4, 3, 0, 1, 2), padding=1)
    return y.movedim(1, -1)


class _NcConv3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return nc_conv3d_forward(x, w)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gy = gy.to(x.dtype)
        gx = conv3d_dgrad(gy, w) if ctx.needs_input_grad[0] else None
        gw = nc_conv3d_wgrad(x, gy).to(w.dtype) if ctx.needs_input_grad[1] else None
        return gx, gw


def nc_conv3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3x3 conv, ``[B,H,W,D,C] @ [3,3,3,C,co]``,
    differentiable in both arguments: forward on K2, data gradient on K2
    (:func:`conv3d_dgrad`), weight gradient on K2w rounded once to the
    weights' dtype, as ``_nc_bwd`` does. Gate calls with
    :func:`nc_conv3d_supported`; CPU tensors take the plain versions."""
    return _NcConv3d.apply(x, w)
