"""The port's layers against the JAX layer library on the CPU.

JAX initialises the parameters; they are carried into the port's modules
through ``compat/jax_params.py`` (the same path real weights take), and the
same numpy inputs go through both. All fp32; tolerances are stated per test.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.nn import layers as jl
from rendernet_tpu_torch.compat.jax_params import load_jax_params
from rendernet_tpu_torch.nn import layers as tl

torch.set_num_threads(2)


def _strip(params, scope):
    return {k[len(scope) + 1:]: np.asarray(v) for k, v in params.items()}


def _randomize_alphas(params, rng):
    """PReLU alphas initialise to 0; give them values so the negative slope
    is exercised."""
    return {k: (rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
                if k.endswith("alpha") else v) for k, v in params.items()}


def _jax_apply(fn, params, x):
    return np.asarray(fn(jl.Module(params={k: jnp.asarray(v) for k, v in params.items()}),
                         jnp.asarray(x)))


@pytest.mark.parametrize("xs,k,s", [
    ((2, 9, 10, 12), (4, 4), (1, 1)),           # e_conv5/e_conv6: even kernel, pads (1, 2)
    ((2, 9, 10, 5, 3), (5, 5, 5), (2, 2, 2)),   # e_conv1: strided, odd sizes
    ((2, 8, 8, 8, 4), (3, 3, 3), (1, 1, 2)),    # e_conv2: depth-only stride
    ((2, 8, 8, 6), (1, 1), (1, 1)),             # the projection's 1x1
])
def test_same_conv_matches_jax(xs, k, s):
    """TF SAME padding (odd extra pad on the high side): fp32 convs of at
    most 125*4 terms in other orders; 1e-5."""
    rng = np.random.default_rng(0)
    ndim = len(k)
    co = 5
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(k + (xs[-1], co)) * 0.2).astype(np.float32)
    want = np.asarray(jl._conv_op(jnp.asarray(x), jnp.asarray(w), s, ndim))
    got = tl.conv_op(torch.from_numpy(x), torch.from_numpy(w), s, ndim).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_transpose_matches_jax(stride):
    """TF conv-transpose, k4 at stride 1 (the (2, 1) padded adjoint,
    ``_deconv_s1_k4``) and stride 2 (``_deconv_s2_k4``); output = input *
    stride. fp32, 1e-5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 6, 8)).astype(np.float32)
    w = (rng.standard_normal((4, 4, 5, 8)) * 0.2).astype(np.float32)  # spatial + (out, in)
    s = (stride, stride)
    want = np.asarray(jl._conv_transpose_op(jnp.asarray(x), jnp.asarray(w), s, 2))
    got = tl.conv_transpose_op(torch.from_numpy(x), torch.from_numpy(w), s, 2).numpy()
    assert got.shape == want.shape == (2, 7 * stride, 6 * stride, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_conv_unit_module_matches_jax():
    """A ConvUnit holding a stride-2 ConvTranspose (the e_conv7 scope):
    weights carried across in TF conv-transpose layout; fp32, 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 6, 8)).astype(np.float32)

    def fn(m, x):
        with m.scope("e_conv7"):
            return jl.prelu(m, jl.conv2d_transpose(m, x, 4, (4, 4), (2, 2), scope="e_conv7"))

    params = jax.tree.map(np.asarray, _init(fn, x))
    params = _randomize_alphas(params, rng)
    want = _jax_apply(fn, params, x)
    g = torch.Generator().manual_seed(0)
    unit = tl.ConvUnit("e_conv7", tl.ConvTranspose(8, 4, (4, 4), (2, 2), g), 4)
    load_jax_params(unit, _strip(params, "e_conv7"))
    got = unit(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _init(fn, x):
    m = jl.Module(rng=jax.random.PRNGKey(0))
    fn(m, jnp.asarray(x))
    return m.params


def test_projection_unit_matches_jax():
    """[B,H,W,D,C] -> [B,H,W,D*C], 1x1 conv + PReLU; fp32 sums of 32 terms, 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 4, 8)).astype(np.float32)
    fn = lambda m, x: jl.projection_unit(m, x)  # noqa: E731
    params = _randomize_alphas(jax.tree.map(np.asarray, _init(fn, x)), rng)
    want = _jax_apply(fn, params, x)
    unit = tl.ProjectionUnit(32, torch.Generator().manual_seed(0))
    load_jax_params(unit, _strip(params, "projection_unit"))
    got = unit(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ndim,xs", [(2, (8, 6, 6, 256)), (3, (2, 4, 8, 8, 32))])
def test_res_block_matches_jax(monkeypatch, ndim, xs):
    """conv -> PReLU -> conv + skip, with the kernels' dispatch on both
    sides (JAX: Pallas in interpret mode; port: the wrappers' plain
    versions): 2D at 256 channels and batch 8 reaches Winograd, 3D at
    32 channels reaches the narrow conv3d. fp32; the Winograd transforms
    add roundoff on top of 9*256-term sums: 1e-4."""
    _res_block_case(monkeypatch, ndim, xs, "pallas")


@pytest.mark.parametrize("wino", [True, "xla"])
def test_res_block_matches_jax_xla_winograd(monkeypatch, wino):
    """As above with WINOGRAD_2D True / "xla" on both sides: the plain
    Winograd expression, at batch 2, which K3's envelope leaves out and
    winograd3x3_supported takes; 1e-4."""
    _res_block_case(monkeypatch, 2, (2, 6, 6, 256), wino)


def _res_block_case(monkeypatch, ndim, xs, wino):
    monkeypatch.setattr(jl, "PALLAS_CONV3D", True)
    monkeypatch.setattr(jl, "WINOGRAD_2D", wino)
    monkeypatch.setattr(tl, "CUDA_CONV3D", True)
    monkeypatch.setattr(tl, "WINOGRAD_2D", wino)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(xs) * 0.5).astype(np.float32)
    ch = xs[-1]
    block = jl.res_block_2d if ndim == 2 else jl.res_block_3d
    fn = lambda m, x: block(m, x, ch, scope="res")  # noqa: E731
    params = _randomize_alphas(jax.tree.map(np.asarray, _init(fn, x)), rng)
    want = _jax_apply(fn, params, x)
    blk = tl.ResBlock(ch, ndim, torch.Generator().manual_seed(0))
    load_jax_params(blk, _strip(params, "res"))
    got = blk(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_dispatch_routes_to_kernel_wrappers(monkeypatch):
    """CUDA_CONV3D "auto" keeps CPU tensors off the K2 wrapper (as JAX's
    "auto" keeps the CPU off Pallas); True and WINOGRAD_2D route the
    envelope's shapes to the wrappers; shapes outside stay on the plain conv."""
    from rendernet_tpu_torch.ops import cuda_conv3d, cuda_winograd

    calls = []
    monkeypatch.setattr(cuda_conv3d, "nc_conv3d",
                        lambda x, w: calls.append("k2") or cuda_conv3d.nc_conv3d_plain(x, w))
    monkeypatch.setattr(cuda_winograd, "wino_conv2d",
                        lambda x, w: calls.append("k3") or cuda_winograd.wino_conv2d_plain(x, w))
    x3 = torch.zeros(1, 4, 8, 8, 16)
    w3 = torch.zeros(3, 3, 3, 16, 32)
    x2 = torch.zeros(8, 4, 4, 256)
    w2 = torch.zeros(3, 3, 256, 256)
    tl.conv_op(x3, w3, (1, 1, 1), 3)
    tl.conv_op(x2, w2, (1, 1), 2)
    assert calls == []
    monkeypatch.setattr(tl, "CUDA_CONV3D", True)
    monkeypatch.setattr(tl, "WINOGRAD_2D", "pallas")
    tl.conv_op(x3, w3, (1, 1, 1), 3)
    tl.conv_op(x2, w2, (1, 1), 2)
    tl.conv_op(x2[:1], w2, (1, 1), 2)            # batch 1: outside K3's envelope
    tl.conv_op(x3, w3[:, :, :, :, :8], (1, 1, 1), 3)  # co = 8: outside K2's
    assert calls == ["k2", "k3"]
