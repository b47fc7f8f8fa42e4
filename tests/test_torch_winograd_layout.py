"""The operand layouts of K3's GEMMs against the JAX package, on the CPU.

K3 writes V = B^T d B into a scratch ``[16, tiles, C]`` and U = G w G^T as
``[16, K, C]`` (both GEMM operands K-major) before its wgmma GEMMs. The
plain versions of those two layouts (``ops.winograd.input_transform`` and
``transform_weights`` transposed) are held here against the transforms of
``rendernet_tpu/ops/winograd.py`` and ``pallas_winograd._transform_weights``
on the same numpy inputs.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.ops import pallas_winograd
from rendernet_tpu.ops import winograd as jwinograd
from rendernet_tpu_torch.ops import cuda_winograd
from rendernet_tpu_torch.ops.winograd import input_transform, transform_weights

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _jax_v(x: jnp.ndarray) -> jnp.ndarray:
    """V as ``rendernet_tpu/ops/winograd.py:winograd3x3`` forms it (its
    tap views, its fp32 row and column sums, its cast): [16, B*nh*nw, C]."""
    b, h, ww, c = x.shape
    nh, nw = h // 2, ww // 2
    xp = jnp.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    d = [[xp[:, r:r + 2 * nh:2, s:s + 2 * nw:2, :] for s in range(4)] for r in range(4)]
    bt = jwinograd._BT
    rowt = [[sum(d[r][s].astype(jnp.float32) * float(bt[k1, r]) for r in range(4)
                 if bt[k1, r] != 0) for s in range(4)] for k1 in range(4)]
    v = [[sum(rowt[k1][s] * float(bt[k2, s]) for s in range(4) if bt[k2, s] != 0)
          for k2 in range(4)] for k1 in range(4)]
    return jnp.stack([v[k1][k2].reshape(b * nh * nw, c)
                      for k1 in range(4) for k2 in range(4)]).astype(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_input_transform_matches_jax(dtype):
    """V in K3's scratch layout at (3, 6, 10, 64), a ragged tile count (45
    tiles, 5 per row) over three images. Both sides sum at most two terms
    with coefficients +-1 in fp32, in the same order, then cast once, so
    they agree exactly."""
    jdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(11).standard_normal((3, 6, 10, 64)).astype(np.float32)
    want = np.asarray(_jax_v(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = input_transform(torch.from_numpy(x).to(tdt), tdt).float().numpy()
    assert got.shape == (16, 45, 64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_transform_kmajor_matches_jax(dtype):
    """U in K3's bf16 layout [16, K, C] against the transpose of
    ``pallas_winograd._transform_weights`` at C = 64, K = 128. JAX sums G w
    G^T in an einsum's order, the port left to right, both in fp32: 1e-6 of
    max|U| in fp32; in bf16 a sum that lands within an fp32 ulp of a
    rounding tie may round one bf16 ulp apart: 2^-8 of max|U|."""
    jdt, tdt = DTYPES[dtype]
    w = (np.random.default_rng(12).standard_normal((3, 3, 64, 128)) * 0.1).astype(np.float32)
    want = np.asarray(pallas_winograd._transform_weights(jnp.asarray(w).astype(jdt), jdt)
                      .astype(jnp.float32)).transpose(0, 2, 1)
    got = transform_weights(torch.from_numpy(w).to(tdt), tdt).transpose(1, 2).float().numpy()
    assert got.shape == (16, 128, 64)
    tol = (1e-6 if dtype == "float32" else 2.0 ** -8) * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("b,h,w,c", [(8, 64, 64, 1024), (24, 32, 32, 512), (8, 6, 70, 256)])
def test_v_scratch_bytes(b, h, w, c):
    """The V scratch is 16 values per tile and input channel in the storage
    dtype: bf16, and fp32 (kept one fp32 plane, split in registers)."""
    assert cuda_winograd.v_scratch_bytes((b, h, w, c), torch.bfloat16) == (
        16 * b * (h // 2) * (w // 2) * c * 2)
    assert cuda_winograd.v_scratch_bytes((b, h, w, c), torch.float32) == (
        16 * b * (h // 2) * (w // 2) * c * 4)


def test_envelope_fits_the_kernel_both_ways():
    """Every shape inside ``wino_conv2d_supported`` fits K3 in both dtypes
    for the forward and for the data gradient (K3 on the io-swapped
    weights), so no main-path call raises on the card."""
    for b in (8, 24):
        for hw in (2, 6, 32, 64):
            for c in (256, 384, 512, 1024):
                for k in (128, 256, 640, 1024):
                    for dt in (torch.float32, torch.bfloat16):
                        if not cuda_winograd.wino_conv2d_supported((b, hw, hw, c),
                                                                   (3, 3, c, k), (1, 1), dt):
                            continue
                        assert cuda_winograd._kernel_fits((b, hw, hw, c), k, dt)
                        assert cuda_winograd._kernel_fits((b, hw, hw, k), c, dt)
