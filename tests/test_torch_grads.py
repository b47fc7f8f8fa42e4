"""The port's differentiable kernel ops against the JAX package's custom VJPs
on the CPU: K2's gradients (the data gradient on K2, the weight gradient on
K2w), K3's with each ``WGRAD`` mode (K6), and the save-pre-activation res
blocks (``_act_conv``).

JAX runs its Pallas kernels in interpret mode, as ``tests/test_pallas_*.py``
do; the port's wrappers take their plain versions on CPU tensors. The same
numpy inputs and cotangents go to both sides; module switches are set with
``monkeypatch`` and restored after each test. All fp32 unless a test says
otherwise.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.nn import layers as jl
from rendernet_tpu.ops import pallas_conv3d, pallas_winograd
from rendernet_tpu_torch.compat.jax_params import load_jax_params, torch_name_to_tf
from rendernet_tpu_torch.nn import layers as tl
from rendernet_tpu_torch.ops import cuda_conv3d, cuda_winograd

torch.set_num_threads(2)


def _rel_close(got, want, tol):
    """max |got - want| <= tol * max |want| (a fraction of the array's scale)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


def _torch_vjp(fn, args, cot):
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_vjp(fn, args, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


# ---------------------------------------------------------------------------
# K2 / K2w
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,co,adjoint_in_envelope", [
    ((1, 4, 8, 8, 16), 32, True),    # e_conv3's 16 -> 32: the adjoint runs K2 at co = 16
    ((1, 2, 8, 8, 32), 16, True),    # 32 -> 16: the adjoint at co = 32
    ((2, 3, 4, 8, 8), 32, False),    # 8 -> 32: the adjoint's co = 8 leaves the envelope
])
def test_conv3d_grads_match_pallas_vjp(monkeypatch, shape, co, adjoint_in_envelope):
    """gx and gw of the port's nc_conv3d against jax.vjp through
    pallas_conv3d.nc_conv3d (its Pallas fwd, dgrad and wgrad kernels): fp32
    sums of 27*C (gx) or B*H*W*D (gw) products in other orders; 1e-4 of
    max|grad|, as the forward's test. The port's data gradient runs the K2
    wrapper on the flipped, io-swapped weights inside the envelope and the
    plain conv outside it, as JAX dispatches."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, shape[-1], co)) * 0.1).astype(np.float32)
    cot = rng.standard_normal(shape[:-1] + (co,)).astype(np.float32)
    assert cuda_conv3d.nc_conv3d_supported(shape, w.shape, (1, 1, 1))
    assert pallas_conv3d.nc_conv3d_supported(
        shape[:-1] + (co,), (3, 3, 3, co, shape[-1]), (1, 1, 1)) == adjoint_in_envelope
    calls = []
    fwd = cuda_conv3d.nc_conv3d_forward
    monkeypatch.setattr(cuda_conv3d, "nc_conv3d_forward",
                        lambda a, b: calls.append(b.shape[-1]) or fwd(a, b))
    want_y, (want_gx, want_gw) = _jax_vjp(pallas_conv3d.nc_conv3d, (x, w), cot)
    got_y, (got_gx, got_gw) = _torch_vjp(cuda_conv3d.nc_conv3d, (x, w), cot)
    assert calls == ([co, shape[-1]] if adjoint_in_envelope else [co])
    _rel_close(got_y, want_y, 1e-4)
    _rel_close(got_gx, want_gx, 1e-4)
    _rel_close(got_gw, want_gw, 1e-4)


def test_conv3d_wgrad_plain_matches_nc_bwd():
    """K2w's plain version against the gw of pallas_conv3d._nc_bwd (the
    packed wgrad kernel and its unpacking), fp32, 1e-4 of max|gw|; and the
    wrapper returns fp32 [3,3,3,C,co]."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 3, 8, 8, 16)).astype(np.float32)
    w = np.zeros((3, 3, 3, 16, 32), np.float32)
    gy = rng.standard_normal((2, 3, 8, 8, 32)).astype(np.float32)
    xp = pallas_conv3d._pad_spatial(jnp.asarray(x), 128 // 32)
    _, want = pallas_conv3d._nc_bwd((xp, jnp.asarray(w)), jnp.asarray(gy))
    got = cuda_conv3d.nc_conv3d_wgrad(torch.from_numpy(x), torch.from_numpy(gy))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, 3, 16, 32)
    _rel_close(got.numpy(), np.asarray(want), 1e-4)


# ---------------------------------------------------------------------------
# K3 / K6
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("wgrad", [False, True, "fp32"])
def test_winograd_grads_match_pallas_vjp(monkeypatch, wgrad):
    """gx and gw of the port's wino_conv2d against jax.vjp through
    pallas_winograd.wino_conv2d with the same WGRAD: the data gradient is
    K3 on the flipped, io-swapped weights on both sides; the weight
    gradient is the direct conv's (False) or the transform-domain one (True,
    "fp32"; fp32 activations make both fp32-operand GEMMs). fp32 sums in
    other orders plus the transforms' roundoff: 1e-4 of max|grad|."""
    monkeypatch.setattr(pallas_winograd, "WGRAD", wgrad)
    monkeypatch.setattr(cuda_winograd, "WGRAD", wgrad)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((8, 8, 6, 256)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 256, 256)) * 0.05).astype(np.float32)
    cot = rng.standard_normal((8, 8, 6, 256)).astype(np.float32)
    calls = {"k3": 0, "k6": 0}
    k3, k6 = cuda_winograd.wino_conv2d_forward, cuda_winograd.wino_wgrad
    monkeypatch.setattr(cuda_winograd, "wino_conv2d_forward",
                        lambda *a: calls.__setitem__("k3", calls["k3"] + 1) or k3(*a))
    monkeypatch.setattr(cuda_winograd, "wino_wgrad",
                        lambda *a: calls.__setitem__("k6", calls["k6"] + 1) or k6(*a))
    want_y, (want_gx, want_gw) = _jax_vjp(pallas_winograd.wino_conv2d, (x, w), cot)
    got_y, (got_gx, got_gw) = _torch_vjp(cuda_winograd.wino_conv2d, (x, w), cot)
    assert calls == {"k3": 2, "k6": 1 if wgrad else 0}
    _rel_close(got_y, want_y, 1e-4)
    _rel_close(got_gx, want_gx, 1e-4)
    _rel_close(got_gw, want_gw, 1e-4)


@pytest.mark.parametrize("dtype,mode", [("float32", True), ("bfloat16", True),
                                        ("bfloat16", "fp32")])
def test_wino_wgrad_plain_matches_pallas(monkeypatch, dtype, mode):
    """K6's plain version against pallas_winograd._wino_wgrad: the same
    rounding points (V and dM cast to the operand type: bf16 with WGRAD=True
    on bf16 activations, fp32 otherwise), fp32 products summed in other
    orders; 1e-4 of max|gw|."""
    monkeypatch.setattr(pallas_winograd, "WGRAD", mode)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((8, 6, 10, 256)).astype(np.float32)
    gy = rng.standard_normal((8, 6, 10, 128)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = pallas_winograd._wino_wgrad(jnp.asarray(x).astype(jdt), jnp.asarray(gy).astype(jdt))
    got = cuda_winograd.wino_wgrad(torch.from_numpy(x).to(tdt), torch.from_numpy(gy).to(tdt),
                                   fp32_operands=mode == "fp32")
    assert got.dtype == torch.float32
    _rel_close(got.numpy(), np.asarray(want, np.float32), 1e-4)


# ---------------------------------------------------------------------------
# _act_conv: the save-pre-activation res block
# ---------------------------------------------------------------------------
def _init(fn, x):
    m = jl.Module(rng=jax.random.PRNGKey(0))
    fn(m, jnp.asarray(x))
    return m.params


@pytest.mark.parametrize("ndim,xs", [(2, (8, 4, 6, 256)), (3, (1, 3, 8, 8, 32))])
def test_preact_res_block_grads_match_jax(monkeypatch, ndim, xs):
    """The gradients of a res block with ``preact`` (act_conv) w.r.t. its
    input and every parameter against jax.grad through res_block_*d with
    preact=True (JAX's _act_conv custom VJP), with the kernels' dispatch on
    both sides: 2D at 256 channels and batch 8 reaches K3 (and its data
    gradient), 3D at 32 channels K2 and K2w. fp32; the gradients sum
    products of the two convs in other orders: 1e-4 of max|grad|."""
    _preact_grads_case(monkeypatch, ndim, xs, "pallas")


@pytest.mark.parametrize("wino", [True, "xla"])
def test_preact_res_block_grads_match_jax_xla_winograd(monkeypatch, wino):
    """As above with WINOGRAD_2D True / "xla" on both sides: the plain
    Winograd expression and its autograd VJP (act_conv's weight gradient
    through conv_weight_grad's "wino_xla" route) against JAX's VJP of
    winograd3x3, at batch 2, outside K3's envelope; 1e-4 of max|grad|."""
    _preact_grads_case(monkeypatch, 2, (2, 4, 6, 256), wino)


def _preact_grads_case(monkeypatch, ndim, xs, wino):
    monkeypatch.setattr(jl, "PALLAS_CONV3D", True)
    monkeypatch.setattr(jl, "WINOGRAD_2D", wino)
    monkeypatch.setattr(tl, "CUDA_CONV3D", True)
    monkeypatch.setattr(tl, "WINOGRAD_2D", wino)
    rng = np.random.default_rng(14)
    x = (rng.standard_normal(xs) * 0.5).astype(np.float32)
    cot = rng.standard_normal(xs).astype(np.float32)
    ch = xs[-1]
    block = jl.res_block_2d if ndim == 2 else jl.res_block_3d
    fn = lambda m, x: block(m, x, ch, scope="res", preact=True)  # noqa: E731
    params = {k: np.asarray(v) for k, v in _init(fn, x).items()}
    params = {k: (rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
                  if k.endswith("alpha") else v) for k, v in params.items()}

    def jloss(p, x):
        out = fn(jl.Module(params=p), x)
        return jnp.sum(out * jnp.asarray(cot))

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in params.items()},
                                               jnp.asarray(x))
    blk = tl.ResBlock(ch, ndim, torch.Generator().manual_seed(0))
    load_jax_params(blk, {k[len("res/"):]: v for k, v in params.items()})
    tx = torch.from_numpy(x).requires_grad_()
    out = blk(tx, preact=True)
    names = [n for n, _ in blk.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [tx] + [p for _, p in blk.named_parameters()])
    _rel_close(grads[0].numpy(), np.asarray(jgx), 1e-4)
    for name, g in zip(names, grads[1:]):
        want = np.asarray(jgp["res/" + torch_name_to_tf(name)])
        got = tl.to_jax_layout(g).numpy() if g.dim() >= 3 else g.numpy()
        _rel_close(got, want, 1e-4)


@pytest.mark.parametrize("ndim,xs", [(2, (8, 4, 6, 256)), (3, (1, 3, 8, 8, 32))])
def test_remat_and_preact_keep_the_gradients(monkeypatch, ndim, xs):
    """res_block_stack over two blocks: remat (torch.utils.checkpoint),
    preact (act_conv) and neither give the same output and gradients, with
    the kernels' dispatch on (their plain versions here). remat recomputes
    the same ops, so it matches exactly; preact regroups the PReLU's
    gradient: 1e-5 of max|grad|."""
    monkeypatch.setattr(tl, "CUDA_CONV3D", True)
    monkeypatch.setattr(tl, "WINOGRAD_2D", "pallas")
    rng = np.random.default_rng(15)
    x = (rng.standard_normal(xs) * 0.5).astype(np.float32)
    gen = torch.Generator().manual_seed(3)
    blocks = [tl.ResBlock(xs[-1], ndim, gen) for _ in range(2)]
    with torch.no_grad():
        for b in blocks:
            b.alpha.uniform_(0.05, 0.3, generator=gen)
    params = [p for b in blocks for p in b.parameters()]

    def run(remat, preact):
        tx = torch.from_numpy(x).requires_grad_()
        out = tl.res_block_stack(blocks, tx, remat=remat, preact=preact)
        grads = torch.autograd.grad((out * out).sum(), [tx] + params)
        return [out.detach().numpy()] + [g.numpy() for g in grads]

    plain = run(False, False)
    for got, want in zip(run(True, False), plain):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(run(True, True), plain):  # remat subsumes preact
        np.testing.assert_array_equal(got, want)
    for got, want in zip(run(False, True), plain):
        _rel_close(got, want, 1e-5)
