"""The port's inverse renderer against the JAX package's, on the CPU.

At ``tests/test_recon.py``'s configuration (z_dim 16, 5 hypotheses, a
32^3 camera grid, the exact warp, fp32): the three decoders' forwards, the
whole ``recon_forward``, one ``make_recon_step`` and a 3-step scan. The
weights are drawn with numpy from a seed, under the key set and shapes of
the JAX package's own init functions (``jax.eval_shape``), handed to JAX as
they are and to the port through ``compat.jax_params.load_jax_params``.
Tolerances are stated per test.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.models import decoders as jdec
from rendernet_tpu.nn.layers import Module
from rendernet_tpu.recon import inverse as jinv
from rendernet_tpu_torch.compat.jax_params import load_jax_params
from rendernet_tpu_torch.models import decoders as tdec
from rendernet_tpu_torch.recon import inverse as tinv

torch.set_num_threads(2)

Z = 16
RECON_KW = dict(z_dim=Z, batch_size=5, inner_steps=3, max_epochs=2, new_size=32,
                light_elevation=(90 - 105) * math.pi / 180.0, shape_eta=0.1, pose_eta=0.001,
                tex_eta=0.1, light_eta=0.05)


def jax_param_shapes(new_size: int):
    """{network: {path: shape}} from the JAX init functions, traced only."""
    key = jax.random.PRNGKey(0)
    trees = {
        "decoder": jax.eval_shape(lambda k: jdec.init_shape_decoder_params(k, z_dim=Z), key),
        "texture": jax.eval_shape(jdec.init_recon_texture_decoder_params, key),
        "renderer": jax.eval_shape(
            lambda k: jdec.init_recon_rendernet_params(k, new_size=new_size), key),
    }
    return {net: {p: tuple(s.shape) for p, s in tree.items()} for net, tree in trees.items()}


def numpy_params(shapes, seed: int):
    """Flat JAX-layout params from a numpy seed, with the initializers'
    scales: Glorot-uniform conv kernels (TF fans), normal(0.02) fully
    connected weights, small random biases and PReLU alphas in [0.05, 0.3]
    (so that both slopes count)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path in sorted(shapes):
        shp = shapes[path]
        leaf = path.rsplit("/", 1)[1]
        if leaf == "weights" and len(shp) >= 3:
            rf = math.prod(shp[:-2])
            limit = math.sqrt(6.0 / (rf * shp[-2] + rf * shp[-1]))
            arr = rng.uniform(-limit, limit, shp)
        elif leaf == "weights":
            arr = 0.02 * rng.standard_normal(shp)
        elif leaf == "biases":
            arr = rng.uniform(-0.01, 0.01, shp)
        else:
            arr = rng.uniform(0.05, 0.3, shp)
        out[path] = arr.astype(np.float32)
    return out


def recon_models(new_size: int):
    """(JAX ReconModel, port ReconModel) with the same numpy weights."""
    shapes = jax_param_shapes(new_size)
    flat = {net: numpy_params(s, seed) for seed, (net, s) in enumerate(sorted(shapes.items()))}
    jmodel = jinv.ReconModel(**{n: {k: jnp.asarray(v) for k, v in d.items()}
                                for n, d in flat.items()})
    tmodel = tinv.ReconModel(
        decoder=load_jax_params(tdec.init_shape_decoder_params(0, z_dim=Z, device="cpu"),
                                flat["decoder"]),
        texture=load_jax_params(tdec.init_recon_texture_decoder_params(0, device="cpu"),
                                flat["texture"]),
        renderer=load_jax_params(
            tdec.init_recon_rendernet_params(0, new_size=new_size, device="cpu"),
            flat["renderer"]),
    )
    return jmodel, tmodel


def torch_latents(lat):
    return tinv.Latents(*(torch.from_numpy(np.array(x, np.float32)) for x in lat))


def target_image(size: int, seed: int = 5):
    """A smooth target: a bright disc on a darker ground, per channel."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    disc = ((yy - 0.5) ** 2 + (xx - 0.45) ** 2 < 0.09).astype(np.float32)
    img = 0.3 + 0.5 * disc[None, :, :, None] * rng.uniform(0.6, 1.0, (1, 1, 1, 3))
    return np.repeat(img, 5, axis=0).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    return recon_models(32)


CFG_J = jinv.ReconConfig(**RECON_KW)
CFG_T = tinv.ReconConfig(**RECON_KW)


def test_config_fields_match_jax():
    """Same fields, same defaults."""
    jf = {f.name: f.default for f in dataclasses.fields(jinv.ReconConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tinv.ReconConfig)}
    assert tf == jf


def test_decoders_match_jax(models):
    """Each network's forward, fp32: shape decoder (z -> 64^3), texture
    decoder (-> [B,64,64,64,4]), renderer (32^3 camera grid -> two 128^2
    heads). The same convolutions in other summation orders (oneDNN vs
    XLA): 1e-5 of each output's max for the decoders; 2e-5 for the renderer,
    whose 56 convs and three residual stacks carry the reordering further."""
    jm, tm = models
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, Z)).astype(np.float32)
    tz = rng.standard_normal((2, 199)).astype(np.float32)
    vox = rng.random((2, 32, 32, 32, 5)).astype(np.float32)
    with torch.no_grad():
        got = {
            "shape": tm.decoder(torch.from_numpy(z)).numpy(),
            "texture": tm.texture(torch.from_numpy(tz)).numpy(),
        }
        alb, nrm = tm.renderer(torch.from_numpy(vox))
        got["albedo"], got["normal"] = alb.numpy(), nrm.numpy()
    want = {
        "shape": jdec.shape_decoder_3d(Module(params=jm.decoder), jnp.asarray(z)),
        "texture": jdec.recon_texture_decoder(Module(params=jm.texture), jnp.asarray(tz)),
    }
    want["albedo"], want["normal"] = jdec.recon_rendernet(Module(params=jm.renderer),
                                                          jnp.asarray(vox))
    shapes = {"shape": (2, 64, 64, 64, 1), "texture": (2, 64, 64, 64, 4),
              "albedo": (2, 128, 128, 3), "normal": (2, 128, 128, 3)}
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].shape == w.shape == shapes[name], name
        tol = (1e-5 if name in ("shape", "texture") else 2e-5) * np.abs(w).max()
        np.testing.assert_allclose(got[name], w, atol=tol, rtol=0, err_msg=name)
        assert w.std() > 1e-3, name  # not a flat output


def test_recon_forward_matches_jax(models):
    """The whole pipeline from the initial latents (exact warp, fp32):
    albedo, normal and shape to 2e-5 of each output's max. The composite to
    2.5e-4: Phong normalises normals = image - 0.5, and where a random
    renderer's normal output sits near 0.5 the normalisation magnifies a
    one-ulp difference of the image; the white-background mask's sigmoid
    (slope up to 255/4) magnifies it again."""
    jm, tm = models
    lat = jinv.initial_latents(CFG_J)
    want = jax.jit(lambda m, l: jinv.recon_forward(m, l, CFG_J))(jm, lat)
    with torch.no_grad():
        got = tinv.recon_forward(tm, torch_latents(lat), CFG_T)
    for name, g, w in zip(("compos", "albedo", "normal", "shape"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        tol = (2.5e-4 if name == "compos" else 2e-5) * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0, err_msg=name)


def test_recon_gradients_match_jax(models):
    """d(sum of the per-sample losses)/d(latents) against jax.grad, per group
    (vector [5,16], pose [5,3], texture [5,199], light [5,1]), fp32: the
    gradients flow back through 56 convolutions, the exact warp (pose
    through the interpolation weights) and both decoders, summed in other
    orders; 1e-3 of each group's largest entry (readings up to 1.3e-4)."""
    jm, tm = models
    target = target_image(128)
    lat0 = jinv.initial_latents(CFG_J)
    jgrad = jax.jit(jax.grad(lambda lat: jnp.sum(jinv.recon_per_sample_loss(
        jm, lat, jnp.asarray(target), CFG_J))))(lat0)
    leaves = [t.requires_grad_() for t in torch_latents(lat0)]
    loss = tinv.recon_per_sample_loss(tm, tinv.Latents(*leaves), torch.from_numpy(target), CFG_T)
    tgrad = torch.autograd.grad(loss.sum(), leaves)
    for name, gt, gj in zip(tinv.Latents._fields, tgrad, jgrad):
        gj = np.asarray(gj)
        assert gt.shape == gj.shape and np.abs(gj).max() > 0, name
        np.testing.assert_allclose(gt.numpy(), gj, atol=1e-3 * np.abs(gj).max(), rtol=0,
                                   err_msg=name)


def close_latents(new_t, new_j, old, rel=1e-3):
    """Updated latents: each group to ``rel`` of its largest update (the
    gradients' tolerance) plus two fp32 ulps of its largest value (both
    sides round old - eta * g once)."""
    for name, t, j, o in zip(tinv.Latents._fields, new_t, new_j, old):
        j, o = np.asarray(j), np.asarray(o)
        atol = rel * np.abs(j - o).max() + 2 * np.spacing(np.abs(j).max())
        np.testing.assert_allclose(t.numpy(), j, atol=atol, rtol=0, err_msg=name)


def test_recon_step_matches_jax(models):
    """One make_recon_step (with el_eta_scale 3, so the elevation's rate
    differs): per-sample losses to 1e-4 relative (a loss averages the
    composite's squared error, whose few mask-magnified pixels move it by
    up to ~3e-5 relative), latents as in
    close_latents; the networks are frozen."""
    cfg_j = dataclasses.replace(CFG_J, el_eta_scale=3.0)
    cfg_t = dataclasses.replace(CFG_T, el_eta_scale=3.0)
    jm, tm = models
    target = target_image(128)
    lat0 = jinv.initial_latents(CFG_J)
    jnew, jper = jinv.make_recon_step(jm, cfg_j)(lat0, jnp.asarray(target))
    tnew, tper = tinv.make_recon_step(tm, cfg_t)(torch_latents(lat0), torch.from_numpy(target))
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper), rtol=1e-4)
    assert not any(p.requires_grad for net in tm for p in net.parameters())
    assert not any(t.requires_grad for t in tnew)
    close_latents(tnew, jnew, lat0)


def test_recon_scan_matches_jax(models):
    """A 3-step inner loop (JAX: one lax.scan; the port: a loop): the [3, 5]
    loss history to 1e-4 relative (as in test_recon_step_matches_jax) and
    the final latents as in
    close_latents."""
    jm, tm = models
    target = target_image(128, seed=6)
    lat0 = jinv.initial_latents(CFG_J, seed=3)
    jnew, jhist = jinv.make_recon_step(jm, CFG_J, scan_steps=3)(lat0, jnp.asarray(target))
    tnew, thist = tinv.make_recon_step(tm, CFG_T, scan_steps=3)(torch_latents(lat0),
                                                               torch.from_numpy(target))
    assert thist.shape == (3, 5)
    np.testing.assert_allclose(thist.numpy(), np.asarray(jhist), rtol=1e-4)
    assert float(thist[-1].sum()) < float(thist[0].sum())
    close_latents(tnew, jnew, lat0)
