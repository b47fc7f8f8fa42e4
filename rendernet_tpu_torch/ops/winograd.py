"""Winograd F(2x2, 3x3) convolution in plain PyTorch: the transform matrices
and the plain version of the K3 kernel (``ops/cuda_winograd.py``), which is
also the route of ``layers.WINOGRAD_2D = True / "xla"`` inside
:func:`winograd3x3_supported`, differentiated by autograd.

Counterpart of ``rendernet_tpu/ops/winograd.py:48-77``. A SAME stride-1
3x3 conv computes each 2x2 output tile from a 4x4 input tile ``d`` as

    V = B^T d B  (fp32, then cast to the compute dtype)    [16, tiles, C]
    U = G w G^T  (fp32, then cast)                          [16, C, K]
    M = V @ U    (16 GEMMs, fp32 accumulation)              [16, tiles, K]
    Y = A^T M A  (fp32, rounded once)                       [2, 2, tiles, K]

with 16 multiplies per channel pair instead of 36. These are the rounding
points of the JAX kernel, which the CUDA kernel keeps.

The weight gradient in the transform domain (``pallas_winograd.py:284-453``,
the plain version of the K6 kernel) contracts the same V with the output
cotangent spread over the 16 frequencies through A,

    dM = A gy-tile A^T  (fp32, then cast to the operand type)  [16, tiles, K]
    gU = V^T @ dM        (16 GEMMs, fp32 accumulation)         [16, C, K]
    gw = G^T gU G        (fp32)                                 [3, 3, C, K]

with 16 multiplies per channel pair and tile instead of the direct weight
gradient's 36.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["input_transform", "transform_weights", "winograd3x3", "winograd3x3_supported",
           "cotangent_spread", "wino_wgrad_plain", "fold_weight_grad"]

# F(2x2, 3x3) transform matrices (Lavin & Gray, arXiv:1509.09308).
_BT = np.array([
    [1, 0, -1, 0],
    [0, 1, 1, 0],
    [0, -1, 1, 0],
    [0, 1, 0, -1],
], np.float32)
_G = np.array([
    [1, 0, 0],
    [0.5, 0.5, 0.5],
    [0.5, -0.5, 0.5],
    [0, 0, 1],
], np.float32)
_AT = np.array([
    [1, 1, 1, 0],
    [0, 1, -1, -1],
], np.float32)


def winograd3x3_supported(x_shape, w_shape, stride) -> bool:
    """The plain expression's envelope (``winograd.py:66-75``): a SAME 3x3
    stride-1 2D conv with cin and cout >= 256, any batch."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    if tuple(stride) != (1, 1) or tuple(w_shape[:2]) != (3, 3):
        return False
    return w_shape[2] >= 256 and w_shape[3] >= 256


def _lincomb(terms, coefs):
    """sum_i coefs[i] * terms[i] over the non-zero coefficients, left to right
    (the reference's accumulation order)."""
    out = None
    for t, a in zip(terms, coefs):
        if a != 0:
            out = t * float(a) if out is None else out + t * float(a)
    return out


def transform_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """U = G w G^T: ``[3, 3, C, K] -> [16, C, K]``, in fp32 then cast. The
    products are exact (G holds 0, +-1/2, 1); the sums run left to right,
    as in the K3 kernel's weight transform."""
    wf = w.to(torch.float32)
    t = [[_lincomb([wf[r, s] for r in range(3)], _G[a]) for s in range(3)] for a in range(4)]
    return torch.stack([_lincomb(t[a], _G[b]) for a in range(4) for b in range(4)]).to(dtype)


def input_transform(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """V = B^T d B of every 4x4 input tile of the SAME-padded ``x`` (an odd
    H or W padded up by one), in fp32 then cast to ``dtype``: ``[B,H,W,C]
    -> [16, B * nh * nw, C]``, tile ``(b * nh + th) * nw + tw``, frequency
    ``4 * k1 + k2``. In bf16 this is the scratch that the K3 kernel's input
    transform writes, bit for bit."""
    b, h, ww, c = x.shape
    ph, pw = -h % 2, -ww % 2
    nh, nw = (h + ph) // 2, (ww + pw) // 2
    xp = F.pad(x, (0, 0, 1, 1 + pw, 1, 1 + ph)).to(torch.float32)
    d = [[xp[:, r:r + 2 * nh:2, s:s + 2 * nw:2, :] for s in range(4)] for r in range(4)]
    rowt = [[_lincomb([d[r][s] for r in range(4)], _BT[k1]) for s in range(4)]
            for k1 in range(4)]
    v = [[_lincomb(rowt[k1], _BT[k2]) for k2 in range(4)] for k1 in range(4)]
    return torch.stack([v[k1][k2].reshape(b * nh * nw, c)
                        for k1 in range(4) for k2 in range(4)]).to(dtype)


def winograd3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3 conv ``[B,H,W,C] @ [3,3,C,K] -> [B,H,W,K]`` via
    F(2x2,3x3); GEMM operands in ``x.dtype``, everything else fp32."""
    b, h, ww, _ = x.shape
    k = w.shape[-1]
    nh, nw = -(-h // 2), -(-ww // 2)
    vmat = input_transform(x, x.dtype)
    umat = transform_weights(w, x.dtype)
    m = torch.bmm(vmat.to(torch.float32), umat.to(torch.float32))
    m = m.reshape(4, 4, b, nh, nw, k)
    rowo = [[_lincomb([m[k1, k2] for k1 in range(4)], _AT[p1]) for k2 in range(4)]
            for p1 in range(2)]
    y = [[_lincomb(rowo[p1], _AT[p2]) for p2 in range(2)] for p1 in range(2)]
    yt = torch.stack([torch.stack(rw, 0) for rw in y], 0)  # [2,2,B,nh,nw,K]
    out = yt.permute(2, 3, 0, 4, 1, 5).reshape(b, 2 * nh, 2 * nw, k)
    return out[:, :h, :ww, :].to(x.dtype)


def cotangent_spread(gy: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """dM = A gy-tile A^T of every 2x2 block of the output cotangent ``gy``
    ``[B,H,W,K]`` (H, W even), in fp32 then cast to ``dtype``: ``[16, B *
    H/2 * W/2, K]``, tiles and frequencies in :func:`input_transform`'s
    order. The products are exact (A holds 0 and +-1); the sums run over
    (p1, p2), p1 outer, left to right, as in the K6 kernel's spread."""
    k = gy.shape[-1]
    g = gy.to(torch.float32)
    gp = [g[:, p1::2, p2::2, :].reshape(-1, k) for p1 in range(2) for p2 in range(2)]
    return torch.stack([
        _lincomb(gp, [_AT[p1, k1] * _AT[p2, k2] for p1 in range(2) for p2 in range(2)])
        for k1 in range(4) for k2 in range(4)]).to(dtype)


def wino_wgrad_plain(x: torch.Tensor, gy: torch.Tensor, fp32_operands: bool = False) -> torch.Tensor:
    """Plain version of K6: the weight gradient ``[3, 3, C, K]`` (fp32) of the
    SAME stride-1 3x3 conv of ``x`` ``[B,H,W,C]`` (H, W even) with output
    cotangent ``gy`` ``[B,H,W,K]``, through the transform domain. GEMM
    operands in ``x.dtype``, or fp32 with ``fp32_operands``; everything else
    fp32 (``pallas_winograd._wgrad_kernel``'s rounding points)."""
    opdt = torch.float32 if fp32_operands else x.dtype
    vmat = input_transform(x, opdt)
    dm = cotangent_spread(gy, opdt)
    gu = torch.bmm(vmat.to(torch.float32).transpose(1, 2), dm.to(torch.float32))
    return fold_weight_grad(gu)


def fold_weight_grad(gu: torch.Tensor) -> torch.Tensor:
    """gw[r, s] = sum_ab G[a, r] G[b, s] gU[4a + b]: the adjoint of
    U = G w G^T, ``[16, C, K] -> [3, 3, C, K]`` in fp32."""
    g = torch.from_numpy(_G).to(gu.device)
    return torch.einsum("ar,abck,bs->rsck", g, gu.reshape(4, 4, *gu.shape[1:]), g)
