"""Phase-space (space-to-depth) rewrite of strided 3D convolutions.

Counterpart of ``rendernet_tpu/ops/phase_conv.py``. The encoders open with
large, narrow-channel strided convs on the 128^3 camera grid (e_conv1
5x5x5 stride 2 on 1 or 5 channels, e_conv2 3x3x3 stride (1, 1, 2)). The
rewrite is exact:

    y[o] = sum_t w[t] x[s*o + t - pad_lo]          (SAME, stride s)

Write the input index as i = s*u + p (phase p in [0, s)): tap t reads
phase p(t) = (t - pad_lo) mod s at offset q(t) = floor((t - pad_lo) / s).
Split x into its prod(s) phase grids, fold the phases into channels (C ->
S*C), scatter w into a phase kernel ``wp[q, (p, c), co]`` and run one
dense stride-1 conv at the decimated resolution with explicit pads
(-qmin, qmax) per dim. The same products, summed in the conv's own order.

The dense conv is :func:`conv_grad.plain_conv`, never a kernel of the
port, as JAX's is ``lax.conv_general_dilated``: the shader's folded
e_conv1 is a 3x3x3 stride-1 conv that K2's envelope must not capture.
:func:`phase_dgrad_conv3d` keeps the plain strided forward and weight
gradient and takes only the data gradient through the phase adjoint (a
stride-1 conv at the decimated resolution instead of the input-dilated
one at full resolution). The layers route to these as
``layers.PHASE_CONV3D`` says.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from rendernet_tpu_torch.ops.conv_grad import (conv_wgrad, flip_io, gather_taps, plain_conv,
                                               same_pads)

__all__ = ["phase_conv3d", "phase_conv3d_supported", "phase_dgrad_conv3d"]


def phase_conv3d_supported(x_shape, w_shape, stride) -> bool:
    """Strided 3D SAME conv whose every strided dim divides evenly
    (``phase_conv.py:67-77``)."""
    if len(x_shape) != 5 or len(w_shape) != 5:
        return False
    if all(s == 1 for s in stride):
        return False  # nothing to rewrite
    if any(s < 1 or s > 4 for s in stride):
        return False
    if x_shape[4] != w_shape[3]:
        return False
    return all(n % s == 0 for n, s in zip(x_shape[1:4], stride))


def _dim_map(n: int, k: int, s: int):
    """Per tap t: (q, p); and (qmin, qmax)."""
    pad_lo = same_pads(n, k, s)[0]
    qp = [((t - pad_lo) // s, (t - pad_lo) % s) for t in range(k)]
    return qp, min(q for q, _ in qp), max(q for q, _ in qp)


@functools.lru_cache(maxsize=None)
def _phase_plan(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...], stride: Tuple[int, ...]):
    """(tap index of each (q, phase) slot of the phase kernel, -1 where no
    tap lands, as ``[nq_h * nq_w * nq_d * S]``; the slots' kernel dims
    (nq_h, nq_w, nq_d); the dense conv's pads)."""
    maps = [_dim_map(n, k, s) for n, k, s in zip(x_shape[1:4], w_shape[:3], stride)]
    nq = tuple(qmax - qmin + 1 for _, qmin, qmax in maps)
    sh, sw, sd = stride
    kh, kw, kd = w_shape[:3]
    slot = np.full(nq + (sh * sw * sd,), -1, np.int64)
    for th in range(kh):
        (qh, ph), qhmin = maps[0][0][th], maps[0][1]
        for tw in range(kw):
            (qw, pw), qwmin = maps[1][0][tw], maps[1][1]
            for td in range(kd):
                (qd, pd), qdmin = maps[2][0][td], maps[2][1]
                slot[qh - qhmin, qw - qwmin, qd - qdmin, (ph * sw + pw) * sd + pd] = \
                    (th * kw + tw) * kd + td
    pads = tuple((-qmin, qmax) for _, qmin, qmax in maps)
    return slot.reshape(-1), nq, pads


def _split_phases(x: torch.Tensor, stride) -> torch.Tensor:
    """``[B,H,W,D,C] -> [B,H/sh,W/sw,D/sd,sh*sw*sd*C]``, phase-major channels."""
    b, h, wd, d, c = x.shape
    sh, sw, sd = stride
    xp = x.reshape(b, h // sh, sh, wd // sw, sw, d // sd, sd, c)
    return xp.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, h // sh, wd // sw, d // sd,
                                                      sh * sw * sd * c)


def _merge_phases(xp: torch.Tensor, stride, c: int) -> torch.Tensor:
    """Inverse of :func:`_split_phases`."""
    b, hs, ws, ds, _ = xp.shape
    sh, sw, sd = stride
    x = xp.reshape(b, hs, ws, ds, sh, sw, sd, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, hs * sh, ws * sw, ds * sd, c)


def phase_kernel(w: torch.Tensor, x_shape, stride):
    """(the phase kernel ``[nq_h, nq_w, nq_d, S*C, co]``, the dense conv's
    pads): each tap of ``w`` ``[kh,kw,kd,C,co]`` in its (q, phase) slot,
    zeros elsewhere; linear in ``w``."""
    key = (tuple(x_shape), tuple(w.shape), tuple(stride))
    slot, nq, pads = _phase_plan(*key)
    kh, kw, kd, c, co = w.shape
    taps = gather_taps(w.reshape(kh * kw * kd, c, co), slot)
    return taps.reshape(nq + (-1, co)), pads


def phase_conv3d(x: torch.Tensor, w: torch.Tensor, stride) -> torch.Tensor:
    """The SAME strided conv ``[B,H,W,D,C] @ [kh,kw,kd,C,K] ->
    [B,H/sh,W/sw,D/sd,K]`` as one dense stride-1 conv over the phase-split
    input (``phase_conv.py:80-130``); differentiable by autograd, as JAX's
    is."""
    stride = tuple(stride)
    if not phase_conv3d_supported(x.shape, w.shape, stride):
        raise ValueError(f"phase_conv3d: {tuple(x.shape)} @ {tuple(w.shape)} stride {stride} "
                         "is outside phase_conv3d_supported")
    wp, pads = phase_kernel(w, x.shape, stride)
    return plain_conv(_split_phases(x, stride), wp, (1, 1, 1), pads)


def _strided_pads(x_shape, w_shape, stride):
    return [same_pads(n, k, s) for n, k, s in zip(x_shape[1:4], w_shape[:3], stride)]


def phase_adjoint(gy: torch.Tensor, w: torch.Tensor, x_shape, stride) -> torch.Tensor:
    """The data gradient of the strided conv through the phase expression:
    the stride-1 adjoint of the dense conv (flipped, io-swapped phase
    kernel, pads (qmax, -qmin)), then the phases merged back."""
    wp, pads = phase_kernel(w, x_shape, stride)
    gxp = plain_conv(gy, flip_io(wp), (1, 1, 1), [(hi, lo) for lo, hi in pads])
    return _merge_phases(gxp, stride, x_shape[-1])


class _PhaseDgrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, w)
        return plain_conv(x, w, stride, _strided_pads(x.shape, w.shape, stride))

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride = ctx.stride
        gy = gy.to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = phase_adjoint(gy, w, x.shape, stride).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = conv_wgrad(x, gy, w.shape, stride,
                            _strided_pads(x.shape, w.shape, stride)).to(w.dtype)
        return gx, gw, None


def phase_dgrad_conv3d(x: torch.Tensor, w: torch.Tensor, stride) -> torch.Tensor:
    """The plain SAME strided conv, whose backward takes the data gradient
    through the phase adjoint (:func:`phase_adjoint`) and keeps the plain
    conv's weight gradient (``phase_conv.py:147-180``)."""
    stride = tuple(stride)
    if not phase_conv3d_supported(x.shape, w.shape, stride):
        raise ValueError(f"phase_dgrad_conv3d: {tuple(x.shape)} @ {tuple(w.shape)} stride "
                         f"{stride} is outside phase_conv3d_supported")
    return _PhaseDgrad.apply(x, w, stride)
