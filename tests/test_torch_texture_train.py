"""The port's texture/face train step against the JAX package on the CPU.

JAX initialises the parameters and they are carried into the port; inputs
are numpy draws from a seed fed to both. The model is cut to new_size 32,
tex_base 8 (the 64^3 texture grid), one block per stack and base 8.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.models import texture_face as jtex
from rendernet_tpu.ops import crops as jcrops
from rendernet_tpu.train import config as jconfig
from rendernet_tpu.train import steps as jsteps
from rendernet_tpu_torch.compat.jax_params import jax_params_from_module, load_jax_params
from rendernet_tpu_torch.models import texture_face as ttex
from rendernet_tpu_torch.train import config as tconfig
from rendernet_tpu_torch.train import distributed as tdist
from rendernet_tpu_torch.train import steps as tsteps
from test_torch_texture import jax_texture_params, texture_batch

torch.set_num_threads(2)

ARCH = dict(tex_base=8, new_size=32, res1_blocks=1, res2_blocks=1, res3_blocks=1, base=8)


def cfgs(**kw):
    base = dict(batch_size=2, img_res=128, new_size=32, compute_dtype="float32",
                e_eta=1e-4, decay_steps=2, is_greyscale=False)
    base.update(kw)
    return jconfig.TrainConfig(**base), tconfig.TrainConfig(**base)


def _run_both(patch, steps=3, fuse_port=False, **kw):
    jcfg, tcfg = cfgs(**kw)
    jm, tm = jtex.TextureFaceConfig(**ARCH), ttex.TextureFaceConfig(**ARCH)
    jstate, jtx = jsteps.create_texture_state(jax.random.PRNGKey(0), jm, jcfg)
    jparams = jax_texture_params(ARCH)
    jstate = jstate._replace(params={k: jnp.asarray(v) for k, v in jparams.items()})
    jstate = jstate._replace(opt_state=jtx.init(jstate.params))
    jstep = jsteps.make_texture_train_step(jm, jcfg, jtx, patch)
    tstate, ttx = tsteps.create_texture_state(1, tm, tcfg, device="cpu")
    load_jax_params(tstate.params, {k: np.asarray(v) for k, v in jstate.params.items()})
    tstep = tsteps.make_texture_train_step(tm, tcfg, ttx, patch)
    vox, images, normals, codes, pose = texture_batch(2, seed=1)
    key = jax.random.PRNGKey(7)
    jls, tls = [], []
    saved = tsteps.FUSE_TEXTURE_RESAMPLE
    tsteps.FUSE_TEXTURE_RESAMPLE = fuse_port
    try:
        for i in range(steps):
            offsets = None
            if patch != tcfg.new_size:
                crop_key = jax.random.split(jax.random.fold_in(key, i))[0]
                offsets = [int(o) for o in jcrops.random_crop_offsets(crop_key, 32, patch)]
            jstate, jloss = jstep(jstate, *(jnp.asarray(a) for a in (vox, images, normals, codes,
                                                                     pose)), key)
            tstate, tloss = tstep(tstate, *(torch.from_numpy(a) for a in (vox, images, normals,
                                                                          codes, pose)),
                                  7, offsets)
            jls.append(float(jloss))
            tls.append(float(tloss))
    finally:
        tsteps.FUSE_TEXTURE_RESAMPLE = saved
    return jls, tls, jstate.params, jax_params_from_module(tstate.params), tcfg


def _assert_params_close(tp, jp, lr):
    """Every value within 7 lr (three Adam steps with b1 = 0.5 move a value
    by at most ~1.05 lr each, whatever its gradient), and 97% of all values
    within 0.1 lr (a value whose gradient is near zero moves by the
    gradient's sign, which fp32 roundoff can flip)."""
    assert set(tp) == set(jp)
    n_far = n = 0
    for k in jp:
        d = np.abs(np.asarray(tp[k], np.float64) - np.asarray(jp[k], np.float64))
        assert d.max() <= 7 * lr, (k, d.max())
        n_far += int((d > 0.1 * lr).sum())
        n += d.size
    assert n_far <= 3e-2 * n, (n_far, n)


@pytest.mark.parametrize("moment_dtype,accum", [("float32", 1), ("bfloat16", 2)])
def test_texture_step_matches_jax_full_grid(moment_dtype, accum):
    """Three steps of make_texture_train_step at patch = new_size, port vs
    JAX, fp32, exact warp, plain convs: the loss of each step to 1e-5
    relative, then every parameter (decoder and both heads included) as
    _assert_params_close says."""
    jls, tls, jp, tp, cfg = _run_both(32, moment_dtype=moment_dtype, grad_accum_steps=accum)
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    assert jls[2] != jls[0]
    _assert_params_close(tp, jp, cfg.e_eta)


def test_texture_step_matches_jax_patch():
    """Three steps at patch 16 with JAX's crop offsets (from its step's own
    key derivation) handed to the port: images and normals cropped, both
    warps crop-fused; tolerances as above."""
    jls, tls, jp, tp, cfg = _run_both(16)
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    _assert_params_close(tp, jp, cfg.e_eta)


def test_fused_resample_matches_two_pass():
    """FUSE_TEXTURE_RESAMPLE on the port's side (one warp of the 5-channel
    concatenation) against JAX's default two-pass step: the warp is linear
    and per channel, so the same tolerances hold."""
    jls, tls, jp, tp, cfg = _run_both(16, steps=2, fuse_port=True)
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    _assert_params_close(tp, jp, cfg.e_eta)


def test_texture_step_refuses_distribution(monkeypatch):
    """A one-process mesh is accepted, and so is the bf16 all-reduce (fp32
    without a data axis above 1, as JAX's): one step each, equal to the
    plain step's. In a process group of two ranks a step without a mesh
    raises, as for the shader step."""
    _, tcfg = cfgs()
    tm = ttex.TextureFaceConfig(**ARCH)
    vox, images, normals, codes, pose = (torch.from_numpy(a) for a in texture_batch(2, seed=1))
    _, bcfg = cfgs(allreduce_dtype="bfloat16")
    losses = []
    for cfg, mesh in ((tcfg, None), (tcfg, tdist.make_mesh(device="cpu")), (bcfg, None)):
        state, tx = tsteps.create_texture_state(0, tm, cfg, device="cpu")
        step = tsteps.make_texture_train_step(tm, cfg, tx, 32, mesh=mesh)
        state, loss = step(state, vox, images, normals, codes, pose, 7)
        losses.append(float(loss))
    assert losses[0] == losses[1] == losses[2] and np.isfinite(losses[0])
    monkeypatch.setattr(tdist, "world", lambda: (0, 2))
    with pytest.raises(RuntimeError, match="without a mesh"):
        tsteps.make_texture_train_step(tm, tcfg, tx, 32)
