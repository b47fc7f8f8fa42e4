"""The fused wide-conv route (``layers.CUDA_CONV2D``) through the whole
shader against JAX with ``layers.PALLAS_CONV2D = True`` on the CPU: a tiny
shader's forward in fp32 and bf16 and one train step.

JAX runs ``pallas_conv2d`` in interpret mode; the port's K5 / K5w wrappers
take their plain versions on CPU tensors. JAX initialises the weights and
they are carried across with ``load_jax_params``; inputs are numpy draws
from a seed. Flags are set with ``monkeypatch`` (the ``flags_on`` fixture)
and restored after each test. Tolerances are stated per test.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.models import shader as jshader
from rendernet_tpu.train import config as jconfig
from rendernet_tpu.train import steps as jsteps
from rendernet_tpu_torch.compat.jax_params import jax_params_from_module, load_jax_params
from rendernet_tpu_torch.models import shader as tshader
from rendernet_tpu_torch.train import config as tconfig
from rendernet_tpu_torch.train import steps as tsteps
from test_torch_conv2d_stack import _alphas_away_from_zero, flags_on  # noqa: F401
from test_torch_train import _assert_params_close

torch.set_num_threads(2)

# new_size 32 and base 16 put both 2D stacks at [B, 16, 16, 256]: inside
# the envelope at any batch (W * B is a multiple of 8), with obufs 2.
ARCH = dict(new_size=32, res1_blocks=1, res2_blocks=2, res3_blocks=1, base=16)


def _batch(b, seed, vox_size=16, img=128):
    rng = np.random.default_rng(seed)
    vox = (rng.random((b, vox_size, vox_size, vox_size, 1)) > 0.6).astype(np.float32)
    yy, xx = np.mgrid[:img, :img] / img
    cy, cx, r = rng.uniform(0.3, 0.7, (3, b, 1, 1)) * np.array([1, 1, 0.6])[:, None, None, None]
    images = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2, 1.0, 0.1)[..., None]
    poses = np.stack([rng.uniform(0, 2 * math.pi, b), rng.uniform(-1.2, 1.2, b),
                      rng.uniform(0.9, 1.1, b)], axis=1)
    return vox, images.astype(np.float32), poses.astype(np.float32)


def _shader_params(arch, seed=0):
    p = jax.jit(jshader.init_shader_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jshader.ShaderConfig(**arch))
    return _alphas_away_from_zero(p, seed + 100)


# Output max |port - JAX| as a fraction of JAX's output spread (max - min).
# fp32: sums in other orders; reading on the CPU 2.5e-6 (the flag-off
# forward reads 3.1e-6). bf16: each side rounds every fused conv's output
# once, but the packages' plain convs (the 3D stack, the 4x4 convs, the
# deconvs) sum in other orders, so a bf16 activation may land one ulp apart
# and the stacks carry that on: 6.8e-3 (JAX's own flag-on and flag-off
# forwards are 7.1e-3 apart).
SHADER_FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_shader_forward_matches_jax(flags_on, dname):
    """shader_forward at batch 2 (exact resample) with the flag on, port vs
    JAX, in fp32 and bf16; the bf16 port is held to JAX's flag-on bf16
    forward (the flag moves bf16's roundings). The head's weights are
    scaled by 50, so the sigmoid output spreads ~0.18 instead of ~0.004
    around 0.5. Tolerances: SHADER_FWD_TOL. The port runs both stacks
    HWNC-resident: 2 fused K5 ops per block and one K5 skip conv per
    stack."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dname]
    jcfg, tcfg = jshader.ShaderConfig(**ARCH), tshader.ShaderConfig(**ARCH)
    params = _shader_params(ARCH)
    params["encoder/e_conv11/weights"] = params["encoder/e_conv11/weights"] * 50
    vox, _, poses = _batch(2, seed=1)
    fwd = jax.jit(lambda p, v, q: jshader.shader_forward(p, v, q, jcfg, compute_dtype=jdt))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(fwd(jp, jnp.asarray(vox), jnp.asarray(poses)).astype(jnp.float32))
    net = load_jax_params(tshader.init_shader_params(1, tcfg, device="cpu"), params)
    with torch.no_grad():
        got = tshader.shader_forward(net, torch.from_numpy(vox), torch.from_numpy(poses),
                                     compute_dtype=tdt).float().numpy()
    assert flags_on == {"k5": 2 * 3 + 2, "k5w": 0}
    assert got.shape == want.shape == (2, 128, 128, 1)
    spread = want.max() - want.min()
    assert spread > 0.1
    assert np.abs(got - want).max() <= SHADER_FWD_TOL[dname] * spread


def test_shader_train_step_matches_jax(flags_on):
    """One make_shader_train_step (batch 4, full grid, fp32, exact
    resample, preact_policy, which the HWNC stacks ignore) with the flag
    on, port vs JAX: the loss to 1e-5 relative and the updated params as
    test_torch_train.py's _assert_params_close holds them (every value
    within 7 lr; 97% within 0.1 lr). The port's step runs every K5 op's
    data gradient and K5w once per fused conv."""
    arch = dict(ARCH, res2_blocks=1, preact_policy=True)
    base = dict(batch_size=4, img_res=128, new_size=32, compute_dtype="float32",
                e_eta=1e-4, decay_steps=2, is_greyscale=True)
    jcfg, tcfg = jconfig.TrainConfig(**base), tconfig.TrainConfig(**base)
    jstate, jtx = jsteps.create_shader_state(jax.random.PRNGKey(0),
                                             jshader.ShaderConfig(**arch), jcfg)
    jstate = jstate._replace(params={k: jnp.asarray(v) for k, v in _shader_params(arch).items()})
    jstate = jstate._replace(opt_state=jtx.init(jstate.params))
    jstep = jsteps.make_shader_train_step(jshader.ShaderConfig(**arch), jcfg, jtx, 32)
    tstate, ttx = tsteps.create_shader_state(1, tshader.ShaderConfig(**arch), tcfg, device="cpu")
    load_jax_params(tstate.params, {k: np.asarray(v) for k, v in jstate.params.items()})
    tstep = tsteps.make_shader_train_step(tshader.ShaderConfig(**arch), tcfg, ttx, 32)
    vox, images, poses = _batch(4, seed=2)
    jstate, jloss = jstep(jstate, jnp.asarray(vox), jnp.asarray(images), jnp.asarray(poses),
                          jax.random.PRNGKey(7))
    tstate, tloss = tstep(tstate, torch.from_numpy(vox), torch.from_numpy(images),
                          torch.from_numpy(poses), 7)
    assert flags_on == {"k5": 2 * 6, "k5w": 6}
    assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_params_close(jax_params_from_module(tstate.params), jstate.params, tcfg.e_eta)
