"""Winograd F(2x2, 3x3) convolution in plain PyTorch: the transform matrices
and the plain version of the K3 kernel (``ops/cuda_winograd.py``).

Counterpart of ``rendernet_tpu/ops/winograd.py:48-63,77``. A SAME stride-1
3x3 conv computes each 2x2 output tile from a 4x4 input tile ``d`` as

    V = B^T d B  (fp32, then cast to the compute dtype)    [16, tiles, C]
    U = G w G^T  (fp32, then cast)                          [16, C, K]
    M = V @ U    (16 GEMMs, fp32 accumulation)              [16, tiles, K]
    Y = A^T M A  (fp32, rounded once)                       [2, 2, tiles, K]

with 16 multiplies per channel pair instead of 36. These are the rounding
points of the JAX kernel, which the CUDA kernel keeps.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["transform_weights", "winograd3x3"]

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


def winograd3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 3x3 conv ``[B,H,W,C] @ [3,3,C,K] -> [B,H,W,K]`` via
    F(2x2,3x3); GEMM operands in ``x.dtype``, everything else fp32."""
    b, h, ww, c = x.shape
    k = w.shape[-1]
    ph, pw = -h % 2, -ww % 2
    nh, nw = (h + ph) // 2, (ww + pw) // 2
    xp = F.pad(x, (0, 0, 1, 1 + pw, 1, 1 + ph)).to(torch.float32)
    d = [[xp[:, r:r + 2 * nh:2, s:s + 2 * nw:2, :] for s in range(4)] for r in range(4)]
    rowt = [[_lincomb([d[r][s] for r in range(4)], _BT[k1]) for s in range(4)]
            for k1 in range(4)]
    v = [[_lincomb(rowt[k1], _BT[k2]) for k2 in range(4)] for k1 in range(4)]
    vmat = torch.stack(
        [v[k1][k2].reshape(b * nh * nw, c) for k1 in range(4) for k2 in range(4)]
    ).to(x.dtype)
    umat = transform_weights(w, x.dtype)
    m = torch.bmm(vmat.to(torch.float32), umat.to(torch.float32))
    m = m.reshape(4, 4, b, nh, nw, k)
    rowo = [[_lincomb([m[k1, k2] for k1 in range(4)], _AT[p1]) for k2 in range(4)]
            for p1 in range(2)]
    y = [[_lincomb(rowo[p1], _AT[p2]) for p2 in range(2)] for p1 in range(2)]
    yt = torch.stack([torch.stack(rw, 0) for rw in y], 0)  # [2,2,B,nh,nw,K]
    out = yt.permute(2, 3, 0, 4, 1, 5).reshape(b, 2 * nh, 2 * nw, k)
    return out[:, :h, :ww, :].to(x.dtype)
