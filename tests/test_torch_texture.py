"""The port's texture/face model against the JAX package on the CPU: the
forward pass with weights carried across (exact and multipass warps), the
committed trained nets, the parameter key sets, and the gradients that
reach the texture decoder through the multipass warp's adjoint (K4).
"""
from __future__ import annotations

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.models import texture_face as jtex
from rendernet_tpu.nn import layers as jl
from rendernet_tpu.train import steps as jsteps
from rendernet_tpu.train.checkpoint import load_params_npz
from rendernet_tpu_torch.compat import jax_params
from rendernet_tpu_torch.compat.jax_params import load_jax_params, torch_name_to_tf
from rendernet_tpu_torch.models import texture_face as ttex
from rendernet_tpu_torch.nn import layers as tl
from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd
from rendernet_tpu_torch.train import config as tconfig
from rendernet_tpu_torch.train import steps as tsteps

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(__file__), os.pardir, "assets")


def sphere_box(n):
    """A sphere plus a box in an n^3 grid (bool [x, y, z])."""
    g = np.arange(n, dtype=np.float32) * (64.0 / n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sphere = (x - 26) ** 2 + (y - 34) ** 2 + (z - 30) ** 2 <= 14.0 ** 2
    box = (np.abs(x - 40) <= 9) & (np.abs(y - 22) <= 12) & (np.abs(z - 38) <= 7)
    return sphere | box


def poses(b, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 2 * math.pi, b), rng.uniform(-1.2, 1.2, b),
                     rng.uniform(0.9, 1.1, b)], axis=1).astype(np.float32)


def texture_batch(b, seed=0, vox_size=64, img=128):
    """Voxels, albedo and normal targets (smooth random fields in [0, 1]),
    texture codes and poses."""
    rng = np.random.default_rng(seed)
    vox = np.repeat(sphere_box(vox_size).astype(np.float32)[None, :, :, :, None], b, axis=0)
    yy, xx = np.mgrid[:img, :img] / img
    phase = rng.uniform(0, 2 * math.pi, (2, b, 1, 1, 3))
    images = (0.5 + 0.4 * np.sin(4 * yy[None, :, :, None] + phase[0])
              * np.cos(3 * xx[None, :, :, None] + phase[1])).astype(np.float32)
    normals = np.clip(images[:, ::-1] * 0.8 + 0.1, 0, 1).astype(np.float32)
    codes = rng.standard_normal((b, 199)).astype(np.float32)
    return vox, images, normals, codes, poses(b, seed + 1)


def jax_texture_params(cfg_kw, seed=0):
    """JAX-initialised params, PReLU alphas drawn away from 0 so that the
    negative slope is exercised."""
    p = jax.tree.map(np.asarray, jax.jit(jtex.init_texture_face_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jtex.TextureFaceConfig(**cfg_kw)))
    rng = np.random.default_rng(seed + 100)
    return {k: (rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
                if k.endswith("alpha") else v) for k, v in p.items()}


def port_texture_net(jparams, cfg_kw):
    net = ttex.init_texture_face_params(1, ttex.TextureFaceConfig(**cfg_kw), device="cpu")
    return jax_params.load_jax_params(net, jparams)


def test_forward_matches_jax_exact():
    """texture_face_forward at new_size 32, tex_base 8 (the default 64^3
    texture grid, three doublings), exact warp, fp32, batch 2: both heads
    agree to 2e-4 (fp32 roundoff of ~30 convs summed in other orders)."""
    kw = dict(tex_base=8, new_size=32, res1_blocks=2, res2_blocks=2, res3_blocks=1, base=8)
    jparams = jax_texture_params(kw)
    vox = np.repeat(sphere_box(64).astype(np.float32)[None, :, :, :, None], 2, axis=0)
    code = np.random.default_rng(3).standard_normal((2, 199)).astype(np.float32)
    pose = poses(2)
    want = jax.jit(lambda p, v, z, q: jtex.texture_face_forward(
        p, v, z, q, jtex.TextureFaceConfig(**kw), resample="exact"))(
        {k: jnp.asarray(v) for k, v in jparams.items()}, vox, code, pose)
    net = port_texture_net(jparams, kw)
    with torch.no_grad():
        got = ttex.texture_face_forward(net, torch.from_numpy(vox), torch.from_numpy(code),
                                        torch.from_numpy(pose), resample="exact")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (2, 128, 128, 3) and g.dtype == torch.float32
        assert w.max() - w.min() > 0.01
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=0)


def test_forward_matches_jax_multipass(monkeypatch):
    """The multipass warp and the kernels' routes, at batch 8, 16^3 shape and
    texture grids (tex_base 8, one doubling), new_size 32, one block per
    stack, c3 32, base 32: e_conv3 / res1 are [8,16,16,8,32] and res2 /
    res3 256 wide, so JAX runs its Pallas K1, K2 and K3 (interpret mode)
    and the port the same layers through its wrappers (plain versions on
    the CPU). 2e-4 as above."""
    kw = dict(tex_base=8, tex_grid=16, enc_channels=(8, 16, 32), new_size=32, res1_blocks=1,
              res2_blocks=1, res3_blocks=1, base=32)
    jparams = jax_texture_params(kw, seed=1)
    vox = np.repeat(sphere_box(16).astype(np.float32)[None, :, :, :, None], 8, axis=0)
    code = np.random.default_rng(4).standard_normal((8, 199)).astype(np.float32)
    pose = poses(8, seed=2)
    monkeypatch.setattr(jl, "PALLAS_CONV3D", True)
    monkeypatch.setattr(jl, "WINOGRAD_2D", "pallas")
    want = jax.jit(lambda p, v, z, q: jtex.texture_face_forward(
        p, v, z, q, jtex.TextureFaceConfig(**kw), resample="multipass"))(
        {k: jnp.asarray(v) for k, v in jparams.items()}, vox, code, pose)

    monkeypatch.setattr(tl, "CUDA_CONV3D", True)
    monkeypatch.setattr(tl, "WINOGRAD_2D", "pallas")
    calls = {"k1": 0, "k2": 0, "k3": 0}

    def counted(mod, name, key):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a: calls.__setitem__(key, calls[key] + 1)
                            or fn(*a))

    counted(cuda_resample, "interp_pass_fwd", "k1")
    counted(cuda_conv3d, "nc_conv3d_forward", "k2")
    counted(cuda_winograd, "wino_conv2d_forward", "k3")
    net = port_texture_net(jparams, kw)
    with torch.no_grad():
        got = ttex.texture_face_forward(net, torch.from_numpy(vox), torch.from_numpy(code),
                                        torch.from_numpy(pose), resample="multipass")
    # two warps of 8 passes; e_conv3 + 2 res1 convs + skip; 3 res2 + 3 res3
    assert calls == {"k1": 16, "k2": 4, "k3": 6}
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (8, 128, 128, 3)
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=0)


def _arch(name):
    with open(os.path.join(ASSETS, f"texture_{name}_arch.json")) as f:
        return {k: tuple(v) if isinstance(v, list) else v for k, v in json.load(f).items()}


@pytest.mark.parametrize("name", ["tiny", "mid"])
def test_trained_nets_exact_path_match_jax(name):
    """The committed trained nets (assets/texture_{tiny,mid}_face.npz with
    their arch JSON) carried into the port render what JAX renders at one
    pose on the exact path, with the committed beta: fp32, 2e-4."""
    arch = _arch(name)
    jparams = load_params_npz(os.path.join(ASSETS, f"texture_{name}_face.npz"))
    beta = np.load(os.path.join(ASSETS, "texture_mid_beta1.npy")).astype(np.float32)
    beta = beta.reshape(1, -1)
    vox = sphere_box(64).astype(np.float32)[None, :, :, :, None]
    pose = np.array([[250 * math.pi / 180, 10 * math.pi / 180, 1.0]], np.float32)
    want = jax.jit(lambda p, v, z, q: jtex.texture_face_forward(
        p, v, z, q, jtex.TextureFaceConfig(**arch), resample="exact"))(
        {k: jnp.asarray(v) for k, v in jparams.items()}, vox, beta, pose)
    net = port_texture_net(jparams, arch)
    with torch.no_grad():
        got = ttex.texture_face_forward(net, torch.from_numpy(vox), torch.from_numpy(beta),
                                        torch.from_numpy(pose), resample="exact")
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape == (1, 4 * arch["new_size"], 4 * arch["new_size"], 3)
        assert w.max() - w.min() > 0.3  # the trained heads draw a face-shaped image
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=0)


@pytest.mark.parametrize("tex_base", [32, 8])
def test_key_sets_are_strictly_equal(tex_base):
    """The port's JAX-style keys equal JAX's init keys (and shapes) in both
    directions, at the reference tex_base 32 and at 8 (three doublings,
    scopes e_tex_conv1, e_tex_conv1_2, e_tex_conv1_3); a round trip is the
    identity, and loading is strict."""
    cfg_kw = dict(tex_base=tex_base)
    want = jax.eval_shape(lambda k: jtex.init_texture_face_params(
        k, jtex.TextureFaceConfig(**cfg_kw)), jax.random.PRNGKey(0))
    net = ttex.init_texture_face_params(0, ttex.TextureFaceConfig(**cfg_kw), device="cpu")
    got = jax_params.jax_params_from_module(net)
    assert set(got) == set(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(v.shape)
                                                            for k, v in want.items()}
    assert "encoder/Image/e_conv7_1/e_conv7_2/weights" in got
    assert "encoder/Image/e_conv9_1/conv2d_transpose/weights" in got
    assert "encoder/Normal/e_conv10_2/e_conv10_2/biases" in got
    rng = np.random.default_rng(0)
    flat = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in got.items()}
    back = jax_params.jax_params_from_module(jax_params.load_jax_params(net, flat))
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    flat.pop("texture_encoder/e_tex_conv2/alpha")
    with pytest.raises(KeyError, match="missing"):
        jax_params.load_jax_params(net, flat)


def test_texture_gradients_through_multipass_match_jax():
    """The decoder's gradients reach it only through the texture grid's
    warp: on the multipass path that is K4's voxel cotangent (the port's
    plain version here; JAX's Pallas VJP in interpret mode). One loss of
    the texture step at 16^3 grids (tex_grid 16), batch 2, against
    jax.grad of texture_face_forward + the two MSEs, fp32: every
    parameter's gradient to 5e-3 of its own max, and K4 runs 8 times, once
    per pass of the texture warp only (the shape warp is data)."""
    kw = dict(tex_base=8, tex_grid=16, new_size=32, res1_blocks=1, res2_blocks=1, res3_blocks=1,
              base=8)
    jparams = jax_texture_params(kw, seed=2)
    vox, images, normals, codes, pose = texture_batch(2, seed=3, vox_size=16)
    jcfg = jtex.TextureFaceConfig(**kw)

    def jloss(p):
        albedo, normal = jtex.texture_face_forward(p, jnp.asarray(vox), jnp.asarray(codes),
                                                   jnp.asarray(pose), jcfg, resample="multipass")
        return (jsteps.shader_loss_from_images(albedo, jnp.asarray(images), False)
                + jsteps.shader_loss_from_images(normal, jnp.asarray(normals), False))

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(
        {k: jnp.asarray(v) for k, v in jparams.items()})
    tcfg = tconfig.TrainConfig(batch_size=2, img_res=128, new_size=32, compute_dtype="float32",
                               is_greyscale=False, resample="multipass")
    net = ttex.init_texture_face_params(1, ttex.TextureFaceConfig(**kw), device="cpu")
    load_jax_params(net, jparams)
    calls = []
    bwd = cuda_resample.interp_pass_bwd

    def counted(vol, *a, **k):
        calls.append(vol.shape[0])
        return bwd(vol, *a, **k)

    cuda_resample.interp_pass_bwd = counted
    try:
        loss = tsteps.texture_loss(net, ttex.TextureFaceConfig(**kw), tcfg, 32,
                                   *(torch.from_numpy(a) for a in (vox, images, normals, codes,
                                                                   pose)))
        names = [n for n, _ in net.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in net.named_parameters()])
    finally:
        cuda_resample.interp_pass_bwd = bwd
    assert calls == [2 * 4] * 8
    assert abs(loss.item() - float(want_loss)) <= 1e-5 * float(want_loss)
    for n, g in zip(names, grads):
        k = torch_name_to_tf(n)
        w = np.asarray(want[k])
        g = (tl.to_jax_layout(g) if g.dim() >= 2 else g).numpy()
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(g, w, atol=5e-3 * np.abs(w).max(), rtol=0, err_msg=k)
