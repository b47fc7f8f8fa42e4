"""The fused wide-conv route (``layers.CUDA_CONV2D``) against JAX with
``layers.PALLAS_CONV2D = True`` on the CPU: the HWNC-resident res stack and
the inverse renderer's forward and latent gradients (the shader's are in
``tests/test_torch_conv2d_slice.py``).

JAX runs ``pallas_conv2d`` in interpret mode; the port's K5 / K5w wrappers
take their plain versions on CPU tensors. Weights are JAX's (or numpy
draws under JAX's key set) carried across with ``load_jax_params``; inputs
are numpy draws from a seed. Flags are set with ``monkeypatch`` and
restored after each test. Tolerances are stated per test.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.nn import layers as jl
from rendernet_tpu.recon import inverse as jinv
from rendernet_tpu_torch.compat.jax_params import load_jax_params, torch_name_to_tf
from rendernet_tpu_torch.nn import layers as tl
from rendernet_tpu_torch.ops import cuda_conv2d
from rendernet_tpu_torch.recon import inverse as tinv
from test_torch_recon import CFG_J, CFG_T, recon_models, target_image, torch_latents

torch.set_num_threads(2)

def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture
def flags_on(monkeypatch):
    """PALLAS_CONV2D / CUDA_CONV2D on; a count of K5 and K5w wrapper calls
    (the plain versions run underneath on the CPU)."""
    monkeypatch.setattr(jl, "PALLAS_CONV2D", True)
    monkeypatch.setattr(tl, "CUDA_CONV2D", True)
    calls = {"k5": 0, "k5w": 0}
    for name, key in (("conv2d_hwnc", "k5"), ("conv2d_wgrad", "k5w")):
        fn = getattr(cuda_conv2d, name)

        def counted(*a, fn=fn, key=key, **kw):
            calls[key] += 1
            return fn(*a, **kw)

        monkeypatch.setattr(cuda_conv2d, name, counted)
    return calls


def _alphas_away_from_zero(params, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
                if k.endswith("alpha") else np.asarray(v)) for k, v in params.items()}


# ---------------------------------------------------------------------------
# the HWNC-resident res stack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("activation", ["prelu", "relu"])
@pytest.mark.parametrize("remat", [False, True])
def test_res_stack_hwnc_matches_jax(flags_on, activation, remat):
    """Two 256-wide blocks through res_block_stack, port vs JAX, both on the
    HWNC route (JAX's _res_stack_hwnc): the output and the gradients w.r.t.
    the input and every parameter, fp32, 2e-4 of each max (the fused ops'
    own tolerance). preact is passed and, as in JAX, ignored."""
    rng = np.random.default_rng(20)
    xs = (3, 4, 8, 256)
    x = (rng.standard_normal(xs) * 0.5).astype(np.float32)
    cot = rng.standard_normal(xs).astype(np.float32)
    fn = lambda m, x: jl.res_block_stack(m, x, 2, 256, "res_{}", ndim=2,  # noqa: E731
                                         activation=activation, remat=remat, preact=True)
    mi = jl.Module(rng=jax.random.PRNGKey(0))
    fn(mi, jnp.asarray(x))
    params = _alphas_away_from_zero(mi.params, 21)

    def jloss(p, x):
        return jnp.sum(fn(jl.Module(params=p), x) * jnp.asarray(cot))

    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    want = jax.jit(lambda p, x: fn(jl.Module(params=p), x))(jp, jnp.asarray(x))
    gen = torch.Generator().manual_seed(0)
    blocks = [tl.ResBlock(256, 2, gen, activation=activation) for _ in range(2)]
    for i, blk in enumerate(blocks, 1):
        load_jax_params(blk, {k[len(f"res_{i}/"):]: v for k, v in params.items()
                              if k.startswith(f"res_{i}/")})
    tx = torch.from_numpy(x).requires_grad_()
    out = tl.res_block_stack(blocks, tx, remat=remat, preact=True)
    assert flags_on["k5"] == 4  # 2 fused ops per block
    tparams = [(i, n, p) for i, b in enumerate(blocks, 1) for n, p in b.named_parameters()]
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(),
                                [tx] + [p for _, _, p in tparams])
    # each op's data gradient, and under remat each block's forward again
    assert flags_on == {"k5": 8 + (4 if remat else 0), "k5w": 4}
    assert _rel_err(out.detach().numpy(), want) <= 2e-4
    assert _rel_err(grads[0].numpy(), jgx) <= 2e-4
    for (i, name, _), g in zip(tparams, grads[1:]):
        w = np.asarray(jgp[f"res_{i}/" + torch_name_to_tf(name)])
        got = tl.to_jax_layout(g).numpy() if g.dim() >= 3 else g.numpy()
        assert _rel_err(got, w) <= 2e-4, name


# ---------------------------------------------------------------------------
# the whole slice: inverse rendering
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """test_torch_recon.py's models, the port's frozen as make_recon_step
    leaves them."""
    jm, tm = recon_models(32)
    for net in tm:
        net.requires_grad_(False)
    return jm, tm


def test_recon_forward_matches_jax(flags_on, models):
    """recon_forward from the initial latents with the flag on (at
    new_size 32 the renderer's res3 stack, [5, 16, 16, 256] relu, runs
    HWNC-resident and its skip conv on K5; res2 at 128 channels stays
    outside the envelope), port vs JAX, fp32: albedo, normal and shape to
    2e-5 of each max, the composite to 2.5e-4, as test_torch_recon.py's
    flag-off test."""
    jm, tm = models
    lat = jinv.initial_latents(CFG_J)
    want = jax.jit(lambda m, l: jinv.recon_forward(m, l, CFG_J))(jm, lat)
    with torch.no_grad():
        got = tinv.recon_forward(tm, torch_latents(lat), CFG_T)
    assert flags_on == {"k5": 5 * 2 + 1, "k5w": 0}
    for name, g, w in zip(("compos", "albedo", "normal", "shape"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        tol = (2.5e-4 if name == "compos" else 2e-5) * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0, err_msg=name)


def test_recon_gradients_match_jax(flags_on, models):
    """d(sum of the per-sample losses)/d(latents) with the flag on against
    jax.grad, per group, fp32: 5e-3 of each group's largest entry. The
    random renderer's relu stacks make these gradients sensitive to the
    convs' summation order (their masks flip): JAX's own flag-on gradients
    sit 1.9e-3 (vector), 1.2e-3 (pose), 1.2e-3 (texture) from its flag-off
    ones, and the same stack run HWNC-resident on XLA's conv with plain
    autodiff 1.6e-3 / 0.7e-3 / 1.4e-3 (CPU readings); the port's read
    1.9e-3 / 1.3e-3 / 1.2e-3 against the flag-on JAX (1.3e-4 against the
    flag-off). The frozen renderer runs each fused op's data gradient and
    no K5w."""
    jm, tm = models
    target = target_image(128)
    lat0 = jinv.initial_latents(CFG_J)
    jgrad = jax.jit(jax.grad(lambda lat: jnp.sum(jinv.recon_per_sample_loss(
        jm, lat, jnp.asarray(target), CFG_J))))(lat0)
    leaves = [t.requires_grad_() for t in torch_latents(lat0)]
    loss = tinv.recon_per_sample_loss(tm, tinv.Latents(*leaves), torch.from_numpy(target), CFG_T)
    tgrad = torch.autograd.grad(loss.sum(), leaves)
    assert flags_on == {"k5": 2 * 11, "k5w": 0}
    for name, gt, gj in zip(tinv.Latents._fields, tgrad, jgrad):
        gj = np.asarray(gj)
        assert gt.shape == gj.shape and np.abs(gj).max() > 0, name
        np.testing.assert_allclose(gt.numpy(), gj, atol=5e-3 * np.abs(gj).max(), rtol=0,
                                   err_msg=name)
