"""Fused Winograd F(2x2,3x3) conv for the wide 2D res stacks on the K3 CUDA
kernel (``csrc/winograd.cu``), with its gradient: the data gradient on K3
itself and, when :data:`WGRAD` is set, the transform-domain weight gradient
on the K6 kernel (``csrc/winograd_wgrad.cu``).

Counterpart of ``rendernet_tpu/ops/pallas_winograd.py``. :func:`wino_conv2d`
is the differentiable op (``_fwd`` / ``_bwd``, :455-500);
:func:`wino_conv2d_forward` and :func:`wino_wgrad` are the two kernels'
wrappers. The plain versions are ``ops.winograd.winograd3x3`` and
``ops.winograd.wino_wgrad_plain``.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from rendernet_tpu_torch.ops import _native
from rendernet_tpu_torch.ops.conv_grad import flip_io, plain_conv_wgrad
from rendernet_tpu_torch.ops.winograd import fold_weight_grad, winograd3x3, wino_wgrad_plain

__all__ = [
    "WGRAD",
    "wino_conv2d",
    "wino_conv2d_forward",
    "wino_conv2d_plain",
    "wino_conv2d_supported",
    "v_scratch_bytes",
    "wino_wgrad",
    "wino_wgrad_plain",
]

# The backward's weight gradient, as ``pallas_winograd.WGRAD`` (:316):
#   False  - the direct conv weight gradient (torch.nn.grad.conv2d_weight,
#            cuDNN on the card; JAX leaves it to XLA the same way);
#   True   - K6 with GEMM operands in the activations' dtype;
#   "fp32" - K6 with fp32 GEMM operands (CUDA-core FMAs on the card).
WGRAD = False

# Launches since the last reset, in all and by (input shape, output
# channels): K3 (``launches``; forward convs and data gradients alike) and
# K6 (``wgrad_launches``). The CPU path launches none.
launches = 0
launches_by_shape: Counter = Counter()
wgrad_launches = 0
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
    blocks, one per CTA of a cluster), in fp32 C % 16 and K % 64. The data
    gradient runs K3 on the io-swapped weights, whose channel counts the
    envelope's multiples of 128 keep in range."""
    cstep, kstep = (64, 128) if dtype == torch.bfloat16 else (16, 64)
    return (len(x_shape) == 4 and x_shape[1] % 2 == 0 and x_shape[2] % 2 == 0
            and x_shape[3] % cstep == 0 and k % kstep == 0)


def v_scratch_bytes(x_shape, dtype: torch.dtype) -> int:
    """Bytes of the V scratch ``[16, B * H/2 * W/2, C]`` that one bf16 K3
    call allocates (its input transform's output); fp32 calls use none."""
    if dtype != torch.bfloat16:
        return 0
    b, h, w, c = x_shape
    return 16 * b * (h // 2) * (w // 2) * c * 2


def wino_conv2d_forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The K3 wrapper: SAME stride-1 3x3 conv ``[B,H,W,C] @ [3,3,C,K]`` via
    Winograd. A CUDA tensor runs the K3 kernel (raising on a shape the
    kernel cannot take); a CPU tensor runs the plain version. The C entry
    first forms U = G w G^T (fp32, cast to ``x.dtype``) into a scratch
    buffer; in bf16 it then writes V = B^T d B into a second scratch
    ``[16, tiles, C]`` and runs the 16 GEMMs and the output transform, in
    fp32 it runs the fused CUDA-core convolution. One launch is counted
    per call."""
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
    u = torch.empty((16, k, c) if bf16 else (16, c, k), dtype=x.dtype, device=x.device)
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


def wino_wgrad(x: torch.Tensor, gy: torch.Tensor, fp32_operands: bool | None = None
               ) -> torch.Tensor:
    """The K6 wrapper: the weight gradient ``[3, 3, C, K]`` (fp32) of the
    SAME stride-1 3x3 conv of ``x`` ``[B,H,W,C]`` with output cotangent
    ``gy`` ``[B,H,W,K]``, contracted in the Winograd domain (gU on the K6
    kernel, the fold through G in PyTorch). ``fp32_operands`` defaults to
    ``WGRAD == "fp32"``; with fp32 activations the operands are fp32 either
    way. A CUDA tensor inside :func:`wino_conv2d_supported` runs K6 (any
    other CUDA input raises); a CPU tensor runs ``wino_wgrad_plain``."""
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
    lib = _native.load("winograd_wgrad")
    lib.rn_wino_wgrad_slices.argtypes = [ctypes.c_int] * 5
    nslices = lib.rn_wino_wgrad_slices(b, h, wd, c, k)
    part = torch.empty(nslices * 16 * c * k if nslices > 1 else 0, dtype=torch.float32,
                       device=x.device)
    gu = torch.empty((16, c, k), dtype=torch.float32, device=x.device)
    lib.rn_wino_wgrad.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    rc = lib.rn_wino_wgrad(x.data_ptr(), gy.data_ptr(), part.data_ptr(), gu.data_ptr(),
                           _native.dtype_code(x.dtype), int(bool(fp32_operands)),
                           b, h, wd, c, k, _native.stream_ptr(x))
    _native.check(lib, rc, "K6 winograd weight gradient")
    global wgrad_launches
    wgrad_launches += 1
    wgrad_launches_by_shape[(b, h, wd, c), k] += 1
    return fold_weight_grad(gu)


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
