"""Inverse rendering under spatial sharding and with the pose hypotheses over
a data axis, on the CPU: two gloo ranks, spawned, against the port without
sharding and against JAX's sharded runs on a mesh of the CPU devices.

On a 1 x 2 mesh each rank runs ``make_recon_step(scan_steps=2)`` per case
of :data:`CASES` (the exact and the multipass warp) on its rows of the
target; on a 2 x 1 mesh (the same two ranks) ``reconstruct`` splits the
hypotheses over the data axis. Meanwhile the parent runs the port's
unsharded steps and ``reconstruct`` and JAX's ``make_recon_step`` with the
target placed ``P(None, "model")`` on a (1, 2) mesh of CPU devices. The
model is ``tests/test_torch_recon.py``'s (numpy weights on JAX's key set,
z_dim 16), batch 2, fp32. The ranks import no JAX.
"""
from __future__ import annotations

import concurrent.futures
import math
import os
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from rendernet_tpu_torch.compat.jax_params import load_jax_params
from rendernet_tpu_torch.models import decoders as tdec
from rendernet_tpu_torch.recon import inverse as tinv
from rendernet_tpu_torch.train import distributed

torch.set_num_threads(2)

BASE = dict(z_dim=16, batch_size=2, inner_steps=2, light_elevation=(90 - 105) * math.pi / 180.0,
            shape_eta=0.1, pose_eta=0.001, tex_eta=0.1, light_eta=0.05)
# (resample, new_size): the multipass warp embeds the 64^3 decoder grids in
# the camera grid, so its case runs at 64^3 (256^2 images), as
# tests/test_torch_recon_multipass.py does.
CASES = {"exact": ("exact", 32), "multipass": ("multipass", 64)}
# The reconstruct run on the 2 x 1 mesh: two epochs of one step (one
# subdivision between them).
RECONSTRUCT = dict(BASE, new_size=32, resample="exact", max_epochs=2, inner_steps=1)
LATENT_SEED = 3


def _cfg(case):
    resample, n = CASES[case]
    return dict(BASE, resample=resample, new_size=n)


# ---------------------------------------------------------------------------
# the ranks (torch only)
# ---------------------------------------------------------------------------
def _model(params, new_size):
    """The port's ReconModel from the flat numpy params ({net/path: array})."""
    def flat(net):
        return {k.split("/", 1)[1]: v for k, v in params.items() if k.startswith(net + "/")}

    return tinv.ReconModel(
        decoder=load_jax_params(tdec.init_shape_decoder_params(0, z_dim=BASE["z_dim"],
                                                               device="cpu"), flat("decoder")),
        texture=load_jax_params(tdec.init_recon_texture_decoder_params(0, device="cpu"),
                                flat("texture")),
        renderer=load_jax_params(tdec.init_recon_rendernet_params(0, new_size=new_size,
                                                                  device="cpu"),
                                 flat("renderer")))


def _target(inputs, case):
    return torch.from_numpy(inputs[f"target{CASES[case][1]}"])


def _port_run(case, params, inputs, shard=None, mesh=None):
    """``make_recon_step(scan_steps=2)`` from the seeded initial latents:
    {"history": [2, 2] losses, "latents" after it, "grads": step 1's latent
    gradients}; with ``shard`` on this rank's rows of the target, the
    gradients as the step's model-axis sum returns them, else as autograd
    hands them to the step (hooks on its leaves)."""
    cfg = tinv.ReconConfig(**_cfg(case))
    model = _model(params[CASES[case][1]], cfg.new_size)
    target = _target(inputs, case)
    lat = tinv.initial_latents(cfg, seed=LATENT_SEED, device="cpu")
    grads, loss_fn = [], None
    if shard is None:
        def loss_fn(m, latents, tgt, c):
            if not grads:
                got = grads.append([None] * 4) or grads[0]
                for i, t in enumerate(latents):
                    t.register_hook(lambda g, i=i: got.__setitem__(i, g.clone()))
            return tinv.recon_per_sample_loss(m, latents, tgt, c)
    else:
        target = shard.take(target)
        model_sum = distributed.model_sum

        def recording(tensors, m):  # (losses, vector, pose, texture, light), summed
            out = model_sum(tensors, m)
            grads.append(out[1:])
            return out

        distributed.model_sum = recording
    try:
        run = tinv.make_recon_step(model, cfg, scan_steps=2, loss_fn=loss_fn, mesh=mesh)
        new, hist = run(lat, target)
    finally:
        if shard is not None:
            distributed.model_sum = model_sum
    return {"history": hist.numpy(), "latents": [t.numpy() for t in new],
            "grads": [g.numpy() for g in grads[0]]}


def _reconstruct(params, inputs, mesh=None, rank=0):
    cfg = tinv.ReconConfig(**RECONSTRUCT)
    target = torch.from_numpy(inputs["target32"])
    if mesh is not None:
        target = target[rank:rank + 1]  # this rank's hypothesis's target
    lat, history, curves = tinv.reconstruct(_model(params[32], 32), target, cfg,
                                            seed=LATENT_SEED, mesh=mesh)
    return {"latents": [t.numpy() for t in lat], "history": history, "curves": curves}


def _rank(rank: int, tmp: str) -> None:
    """One of the two ranks; writes rank{rank}.pt."""
    torch.set_num_threads(1)
    distributed.initialize_multihost(f"file://{tmp}/init", 2, rank, device="cpu")
    try:
        inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
        params = {n: dict(np.load(os.path.join(tmp, f"params{n}.npz"))) for n in (32, 64)}
        mesh = distributed.make_mesh(n_data=1, n_model=2, device="cpu")
        sh = distributed.spatial_sharding(mesh, 5)
        out = {}
        for case in CASES:
            out[case] = _port_run(case, params, inputs, sh, mesh)
            out[case]["checksum"] = [zlib.crc32(t.tobytes()) for t in out[case]["latents"]]
        try:
            tinv.make_recon_step(_model(params[32], 32), tinv.ReconConfig(
                **dict(BASE, new_size=30)), mesh=mesh)
        except ValueError as e:
            out["refuse"] = str(e)
        out["reconstruct"] = _reconstruct(params, inputs,
                                          distributed.make_mesh(n_data=2, device="cpu"), rank)
        out["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "rendernet_tpu.")))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: inputs, the ranks, the references
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spatial_recon(tmp_path_factory):
    """Writes the inputs and weights, starts the two ranks in the
    background, computes the references meanwhile and returns (references,
    ``get()``); ``get()`` waits for the ranks (at most 240 s)."""
    from test_torch_recon import jax_param_shapes, numpy_params, target_image

    tmp = tmp_path_factory.mktemp("spatial_recon")
    inputs = {f"target{n}": target_image(4 * n, seed=6)[:2] for n in (32, 64)}
    inputs["target32"][1] *= 0.8  # two hypotheses' targets apart, for reconstruct
    np.savez(tmp / "inputs.npz", **inputs)
    params = {}
    for n in (32, 64):
        shapes = jax_param_shapes(n)
        params[n] = {f"{net}/{k}": v for seed, (net, s) in enumerate(sorted(shapes.items()))
                     for k, v in numpy_params(s, seed).items()}
        np.savez(tmp / f"params{n}.npz", **params[n])
    errors = []

    def run():
        try:
            distributed.launch(_rank, 2, (str(tmp),), timeout=240)
        except BaseException as e:  # re-raised by get()
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    results = []

    def get():
        if not results:
            thread.join(300)
            assert not thread.is_alive(), "the ranks did not finish"
            if errors:
                raise errors[0]
            results.extend(torch.load(tmp / f"rank{r}.pt", weights_only=False)
                           for r in range(2))
        return results

    try:
        yield _references(inputs, params), get
    finally:
        thread.join(300)


def _references(inputs, params):
    """JAX's sharded steps in a thread per case (their compiles overlap); the
    port's unsharded steps and reconstruct here."""
    with concurrent.futures.ThreadPoolExecutor(len(CASES)) as pool:
        jax_runs = {case: pool.submit(_jax_run, case, inputs, params) for case in CASES}
        ref = {case: _port_run(case, params, inputs) for case in CASES}
        ref["reconstruct"] = _reconstruct(params, inputs)
        ref["jax"] = {case: f.result() for case, f in jax_runs.items()}
    return ref


def _jax_run(case, inputs, params):
    """JAX's ``make_recon_step(scan_steps=2)`` for ``case``, the frozen nets
    replicated and the target placed ``P(None, "model")`` on a (1, 2) mesh
    of CPU devices: {"history", "latents"}."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from rendernet_tpu.recon import inverse as jinv
    from rendernet_tpu.train import distributed as jdist

    mesh = jdist.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    cfg = jinv.ReconConfig(**_cfg(case))
    flat = params[cfg.new_size]
    model = jinv.ReconModel(**{
        net: jdist.replicate(mesh, {k.split("/", 1)[1]: jnp.asarray(v)
                                    for k, v in flat.items() if k.startswith(net + "/")})
        for net in ("decoder", "texture", "renderer")})
    target = jax.device_put(inputs[f"target{cfg.new_size}"], NamedSharding(mesh, P(None, "model")))
    lat = jinv.initial_latents(cfg, seed=LATENT_SEED)
    new, hist = jinv.make_recon_step(model, cfg, scan_steps=2)(lat, target)
    return {"history": np.asarray(hist), "latents": [np.asarray(t) for t in new]}


def _grad_errors(got, want):
    """Per latent group, max |g - g_ref| / max |g_ref|."""
    return {name: float(np.abs(g - w).max() / np.abs(w).max())
            for name, g, w in zip(tinv.Latents._fields, got, want)}


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_recon_steps_match_jax_and_the_whole_step(spatial_recon, case):
    """Two recon steps on the 1 x 2 mesh (exact warp at new_size 32,
    multipass at 64), each rank on its rows of the target, the losses and
    the four latent gradients model-summed: the [2, 2] loss history within
    1e-5 relative, and each latent group after it within 1e-5 of the
    group's max, of the port's unsharded run and of JAX's scan with the
    target placed P(None, "model"); the two ranks' latents bit-equal.
    Step 1's latent gradients as the step's model sum returns them, per
    group as max |g - g_ref| / max |g_ref|, within 2e-5 of the unsharded
    step's (readings up to 5.6e-6): the pose's arrive through every warp
    pass's parameter gradient, the windowed y pass's included, and a pose
    gradient left out of the sum would be its rank's rows' part only. The
    updates themselves are too small to tell gradients apart (the
    vector's moves 0.5 by about an fp32 ulp), hence the gradients."""
    ref, get = spatial_recon
    ranks = get()
    got = ranks[0][case]
    for want in (ref[case], ref["jax"][case]):
        np.testing.assert_allclose(got["history"], want["history"], rtol=1e-5)
        for g, w in zip(got["latents"], want["latents"]):  # 1e-5 of each group's max
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    errs = _grad_errors(got["grads"], ref[case]["grads"])
    assert max(errs.values()) <= 2e-5, errs
    assert ranks[1][case]["checksum"] == got["checksum"]


def test_sharded_recon_refuses_an_unsplittable_grid(spatial_recon):
    """new_size 30 over a model axis of 2: the slabs would not stay aligned
    to e_conv1's stride, so ``make_recon_step`` raises; no JAX module in
    either rank."""
    _, get = spatial_recon
    for r in get():
        assert "divide by 2 x 2" in r["refuse"]
        assert r["jax_imported"] == []


def test_reconstruct_splits_hypotheses_over_data(spatial_recon):
    """``reconstruct`` on a 2 x 1 mesh, one hypothesis per rank (two epochs
    of one step, exact warp): every rank gathers each chunk's losses and
    the latents over the data axis, so both ranks return the unsharded
    run's whole loss history and curves (1e-5 relative), its best
    hypothesis in each epoch, and its latents after the subdivision."""
    ref, get = spatial_recon
    want = ref["reconstruct"]
    for r in get():
        got = r["reconstruct"]
        assert got["history"].shape == want["history"].shape == (2, 2)
        np.testing.assert_allclose(got["history"], want["history"], rtol=1e-5)
        np.testing.assert_allclose(got["curves"], want["curves"], rtol=1e-5)
        np.testing.assert_array_equal(got["history"].argmin(1), want["history"].argmin(1))
        for g, w in zip(got["latents"], want["latents"]):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
