"""The port's shader training slice against the JAX package on the CPU: the
network's gradients and the train and eval steps (the other pieces are in
``tests/test_torch_train_pieces.py``).

JAX initialises the parameters and they are carried into the port
(``compat/jax_params.py``); inputs are made with numpy from a seed and fed
to both. The model is cut to ``new_size=32`` with 2/2/1 res blocks and
``base=16``, so the 2D stacks are 256 channels wide (K3's envelope at batch
8) and the 3D stack is [B, 16, 16, 8, 32] (K2's). Module switches are set
with ``monkeypatch`` and restored after each test.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.models import shader as jshader
from rendernet_tpu.ops import crops as jcrops
from rendernet_tpu.train import config as jconfig
from rendernet_tpu.train import steps as jsteps
from rendernet_tpu_torch.compat.jax_params import (
    jax_params_from_module,
    load_jax_params,
    torch_name_to_tf,
)
from rendernet_tpu_torch.models import shader as tshader
from rendernet_tpu_torch.nn import layers as tl
from rendernet_tpu_torch.ops import crops as tcrops
from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd
from rendernet_tpu_torch.train import config as tconfig
from rendernet_tpu_torch.train import steps as tsteps

torch.set_num_threads(2)

ARCH = dict(new_size=32, res1_blocks=2, res2_blocks=2, res3_blocks=1, base=16,
            preact_policy=True)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _batch(b, seed=0, vox_size=16, img=128):
    """Random voxels and poses; the target images are discs (1 inside, 0.1
    outside), so the loss gradient is not a cancelling sum of noise."""
    rng = np.random.default_rng(seed)
    vox = (rng.random((b, vox_size, vox_size, vox_size, 1)) > 0.6).astype(np.float32)
    yy, xx = np.mgrid[:img, :img] / img
    cy, cx, r = rng.uniform(0.3, 0.7, (3, b, 1, 1)) * np.array([1, 1, 0.6])[:, None, None, None]
    images = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2, 1.0, 0.1)
    images = images[..., None].astype(np.float32)
    poses = np.stack([rng.uniform(0, 2 * math.pi, b), rng.uniform(-1.2, 1.2, b),
                      rng.uniform(0.9, 1.1, b)], axis=1).astype(np.float32)
    return vox, images, poses


def _jax_params(cfg_kw, seed=0):
    """JAX-initialised params with the PReLU alphas drawn away from 0 so the
    negative slope is exercised."""
    p = jax.tree.map(np.asarray, jax.jit(jshader.init_shader_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jshader.ShaderConfig(**cfg_kw)))
    rng = np.random.default_rng(seed + 100)
    return {k: (rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
                if k.endswith("alpha") else v) for k, v in p.items()}


def _port_net(jparams, cfg_kw):
    net = tshader.init_shader_params(1, tshader.ShaderConfig(**cfg_kw), device="cpu")
    return load_jax_params(net, jparams)


def _port_grads(net, loss):
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in net.named_parameters()])
    return {torch_name_to_tf(n): (tl.to_jax_layout(g) if g.dim() >= 3 else g).numpy()
            for n, g in zip(names, grads)}


# ---------------------------------------------------------------------------
# gradients of the whole network
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("resample", ["exact", "multipass"])
def test_shader_gradients_match_jax(monkeypatch, resample):
    """Per-parameter gradients of the BCE shader loss at batch 8, port vs
    jax.grad, fp32. The port routes its convs to the kernels' wrappers
    (plain versions here) through their autograd Functions and act_conv:
    K2 forward and data gradient, K2w, K3 forward and data gradient; JAX
    computes the reference with its plain XLA convs (its Pallas VJPs are
    held against the port's op by op in test_torch_grads.py; compiling the
    whole network's gradient through them in interpret mode takes a
    minute). "exact" resamples with the exact path on both sides;
    "multipass" compares multipass with multipass (JAX's K1 in interpret
    mode; the two resamples differ by design). Every gradient is nonzero
    and agrees to 5e-3 of its own max: in fp32 each package's gradients
    deviate from the port's own float64 gradients by up to 1.3e-3 of their
    max at these inputs (the residual stacks carry fp32 roundoff of ~60
    convs and their adjoints, summed in other orders, Winograd's transforms
    on the port's side), so 5e-3 is about 4x that."""
    monkeypatch.setattr(tl, "CUDA_CONV3D", True)
    monkeypatch.setattr(tl, "WINOGRAD_2D", True)
    jparams = _jax_params(ARCH)
    vox, images, poses = _batch(8)
    jcfg = jshader.ShaderConfig(**ARCH)

    def jloss(p):
        pred = jshader.shader_forward(p, jnp.asarray(vox), jnp.asarray(poses), jcfg,
                                      resample=resample)
        return jsteps.shader_loss_from_images(pred, jnp.asarray(images), True)

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(v) for k, v in jparams.items()})
    calls = {"k1": 0, "k2": 0, "k2w": 0, "k3": 0}

    def counted(mod, name, key):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a: calls.__setitem__(key, calls[key] + 1)
                            or fn(*a))

    counted(cuda_resample, "interp_pass_fwd", "k1")
    counted(cuda_conv3d, "nc_conv3d_forward", "k2")
    counted(cuda_conv3d, "nc_conv3d_wgrad", "k2w")
    counted(cuda_winograd, "wino_conv2d_forward", "k3")
    net = _port_net(jparams, ARCH)
    pred = tshader.shader_forward(net, torch.from_numpy(vox), torch.from_numpy(poses),
                                  resample=resample)
    loss = tsteps.shader_loss_from_images(pred, torch.from_numpy(images), True)
    got = _port_grads(net, loss)
    # forward: e_conv3 + 2 blocks x 2 + skip on K2, 3 x 2 + ... on K3; each
    # again for its data gradient; K2w once per K2 conv
    assert calls == {"k1": 8 if resample == "multipass" else 0, "k2": 12, "k2w": 6, "k3": 16}
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert set(got) == set(want)
    for k in want:
        assert np.abs(np.asarray(want[k])).max() > 0, k
        assert _rel_err(got[k], want[k]) <= 5e-3, k


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
def _train_cfgs(**kw):
    base = dict(batch_size=4, img_res=128, new_size=32, compute_dtype="float32",
                e_eta=1e-4, decay_steps=2, is_greyscale=True)
    base.update(kw)
    return jconfig.TrainConfig(**base), tconfig.TrainConfig(**base)


def _run_both(patch, steps=3, **kw):
    jcfg, tcfg = _train_cfgs(**kw)
    arch = dict(ARCH)
    jstate, jtx = jsteps.create_shader_state(jax.random.PRNGKey(0),
                                             jshader.ShaderConfig(**arch), jcfg)
    jstate = jstate._replace(params={k: jnp.asarray(v) for k, v in _jax_params(arch).items()})
    jstate = jstate._replace(opt_state=jtx.init(jstate.params))
    jstep = jsteps.make_shader_train_step(jshader.ShaderConfig(**arch), jcfg, jtx, patch)
    tstate, ttx = tsteps.create_shader_state(1, tshader.ShaderConfig(**arch), tcfg,
                                             device="cpu")
    load_jax_params(tstate.params, {k: np.asarray(v) for k, v in jstate.params.items()})
    tstep = tsteps.make_shader_train_step(tshader.ShaderConfig(**arch), tcfg, ttx, patch)
    vox, images, poses = _batch(4, seed=1)
    key = jax.random.PRNGKey(7)
    jl_, tl_ = [], []
    for i in range(steps):
        offsets = None
        if patch != tcfg.new_size:
            # the JAX step's own crop key: fold_in(rng, step), split, randint
            crop_key = jax.random.split(jax.random.fold_in(key, i))[0]
            offsets = [int(o) for o in jcrops.random_crop_offsets(crop_key, 32, patch)]
        jstate, jloss = jstep(jstate, jnp.asarray(vox), jnp.asarray(images),
                              jnp.asarray(poses), key)
        tstate, tloss = tstep(tstate, torch.from_numpy(vox), torch.from_numpy(images),
                              torch.from_numpy(poses), 7, offsets)
        jl_.append(float(jloss))
        tl_.append(float(tloss))
    return jl_, tl_, jstate.params, jax_params_from_module(tstate.params), tcfg


@pytest.mark.parametrize("moment_dtype,accum", [("float32", 1), ("bfloat16", 2)])
def test_train_step_matches_jax_full_grid(moment_dtype, accum):
    """Three steps of make_shader_train_step at patch = new_size (the full
    512-equivalent grid), port vs JAX, fp32, exact resample, plain convs on
    both sides (the kernels' gradients are held against JAX in
    test_torch_grads.py and above). The loss of each step agrees to 1e-5
    relative. An Adam step with b1 = 0.5 moves a value by at most ~1.05 lr
    whatever its gradient's size, so the params of any two runs agree
    within 7 lr after three steps; a value whose gradient is near zero
    moves by the gradient's sign, which fp32 roundoff (~1e-3 of the
    gradients' max here, see test_shader_gradients_match_jax) can flip, so
    the check that bites is that 97% of all values agree to 0.1 lr (0.3%
    lie beyond it here and 1.4% in the patch-16 test, in runs on the
    CPU)."""
    jls, tls, jp, tp, cfg = _run_both(32, moment_dtype=moment_dtype, grad_accum_steps=accum)
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    assert jls[2] != jls[0]  # the steps did move the params
    _assert_params_close(tp, jp, cfg.e_eta)


def _assert_params_close(tp, jp, lr):
    assert set(tp) == set(jp)
    n_far = n = 0
    for k in jp:
        d = np.abs(np.asarray(tp[k], np.float64) - np.asarray(jp[k], np.float64))
        assert d.max() <= 7 * lr, (k, d.max())
        n_far += int((d > 0.1 * lr).sum())
        n += d.size
    assert n_far <= 3e-2 * n, (n_far, n)


def test_train_step_matches_jax_patch():
    """Three steps at patch 16 < new_size, the crop fused into the exact
    resample, with JAX's crop offsets (from its step's own key derivation)
    handed to the port's step; tolerances as the full-grid test."""
    jls, tls, jp, tp, cfg = _run_both(16)
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    _assert_params_close(tp, jp, cfg.e_eta)


def test_train_step_draws_its_own_crops():
    """Without offsets the port's step draws them from the step's crop
    seed: the same (rng, step) crops at the same place, another step
    elsewhere; a distributed request raises."""
    _, tcfg = _train_cfgs()
    mcfg = tshader.ShaderConfig(**ARCH)
    state, tx = tsteps.create_shader_state(0, mcfg, tcfg, device="cpu")
    seeds = {tsteps.step_seeds(7, s) for s in range(4)}
    assert len(seeds) == 4
    offs = [tcrops.random_crop_offsets(torch.Generator().manual_seed(tsteps.step_seeds(7, s)[0]),
                                       32, 16) for s in range(8)]
    assert all(0 <= o <= 16 for off in offs for o in off) and len(set(offs)) > 1
    with pytest.raises(NotImplementedError):
        tsteps.make_shader_train_step(mcfg, tcfg, tx, 16, mesh=object())
    step = tsteps.make_shader_train_step(mcfg, tcfg, tx, 16)
    vox, images, poses = _batch(4, seed=2)
    state, loss = step(state, torch.from_numpy(vox), torch.from_numpy(images),
                       torch.from_numpy(poses), 7)
    assert state.step == 1 and np.isfinite(float(loss))


def test_eval_step_matches_jax():
    """make_shader_eval_step (full resolution, exact resample on the CPU) vs
    JAX's, fp32: 2e-4 as the forward's test."""
    jcfg, tcfg = _train_cfgs()
    jparams = _jax_params(ARCH)
    vox, _, poses = _batch(2, seed=3)
    want = jsteps.make_shader_eval_step(jshader.ShaderConfig(**ARCH), jcfg)(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(vox), jnp.asarray(poses))
    got = tsteps.make_shader_eval_step(tshader.ShaderConfig(**ARCH), tcfg)(
        _port_net(jparams, ARCH), torch.from_numpy(vox), torch.from_numpy(poses))
    assert got.shape == want.shape == (2, 128, 128, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_shader_loss_matches_jax():
    """BCE (with the 1e-6 guards) summed per image, mean over the batch, and
    MSE for RGB; fp32, 1e-6 relative."""
    rng = np.random.default_rng(4)
    pred = rng.random((3, 8, 8, 1)).astype(np.float32)
    target = rng.random((3, 8, 8, 1)).astype(np.float32)
    for grey in (True, False):
        want = float(jsteps.shader_loss_from_images(jnp.asarray(pred), jnp.asarray(target), grey))
        got = float(tsteps.shader_loss_from_images(torch.from_numpy(pred),
                                                   torch.from_numpy(target), grey))
        assert abs(got - want) <= 1e-6 * abs(want)
