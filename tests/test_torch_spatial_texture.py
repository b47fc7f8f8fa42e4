"""The texture/face model under spatial sharding (a ``model`` mesh axis over
the rows) on the CPU: two gloo ranks on a 1 x 2 mesh, spawned, against the
port without sharding and against JAX's sharded runs on a mesh of the CPU
devices.

The ranks run ``texture_face_forward`` (exact warp, the raw grid's rows
over the model axis, gathered) and one ``make_texture_train_step`` per case
of :data:`STEPS` with the voxels, images and normals sharded ``P("data",
"model")``; each records its step's gradients (summed over the model axis)
and saves them. Meanwhile the parent runs the port's unsharded forward and
steps and JAX's forward and steps on a (1, 2) mesh of CPU devices, whose
gradients a recording optimizer hands out. The model is a cut
``TextureFaceConfig(new_size=32, tex_base=4, tex_grid=16)`` (2/2/1 res
blocks, full widths), fp32, batch 2, 16^3 voxels, 128^2 images; its
weights are numpy draws on JAX's key set (``tests/test_torch_distributed.py``'s
``_draws``). The ranks import no JAX.
"""
from __future__ import annotations

import concurrent.futures
import os
import sys
import threading
import zlib

import numpy as np
import pytest
import torch

from rendernet_tpu_torch.compat.jax_params import jax_params_from_state_dict, load_jax_params
from rendernet_tpu_torch.models import texture_face as ttex
from rendernet_tpu_torch.train import config as tconfig
from rendernet_tpu_torch.train import distributed
from rendernet_tpu_torch.train import steps as tsteps
from rendernet_tpu_torch.train.optim import GradientTransformation

torch.set_num_threads(2)

ARCH = dict(new_size=32, tex_base=4, tex_grid=16, res1_blocks=2, res2_blocks=2, res3_blocks=1)
CFG = dict(batch_size=2, img_res=128, new_size=32, e_eta=1e-4, compute_dtype="float32",
           is_greyscale=False)
# The sharded steps: (patch, crop offsets given, keep_prob, the fused warp
# on the sharded side). The patch-16 step crops at JAX's offsets and warps
# the shape and texture grids as one differentiated 5-channel warp (JAX's
# step and the unsharded reference warp them apart: the warp is linear and
# per channel). Dropout draws other bits in JAX, so that case is held
# against the port's unsharded step only.
STEPS = {"p32": (32, False, 1.0, False), "p16_fused": (16, True, 1.0, True),
         "p32_dropout": (32, False, 0.5, False)}
JAX_STEPS = ("p32", "p16_fused")
STEP_RNG = 7


# ---------------------------------------------------------------------------
# the ranks (torch only)
# ---------------------------------------------------------------------------
def _recording(tx, sink):
    def update(grads, state, params):
        sink.append({k: g.detach().clone() for k, g in grads.items()})
        return tx.update(grads, state, params)

    return GradientTransformation(tx.init, update)


def _checksum(net):
    return [zlib.crc32(p.detach().numpy().tobytes()) for p in net.parameters()]


def _port_step(case, params, inputs, shard=None, mesh=None):
    """One texture step of ``case`` from ``params``: (loss, gradients in JAX's
    names and layouts, params' checksum); with ``shard`` on this rank's
    rows of the voxels, images and normals."""
    patch, _, keep, fused = STEPS[case]
    cfg = tconfig.TrainConfig(**CFG)
    mcfg = ttex.TextureFaceConfig(**ARCH, keep_prob=keep)
    state, tx = tsteps.create_texture_state(0, mcfg, cfg, device="cpu")
    load_jax_params(state.params, params)
    grads = []
    step = tsteps.make_texture_train_step(mcfg, cfg, _recording(tx, grads), patch, mesh=mesh)
    vox, img, nrm, codes, poses = (torch.from_numpy(inputs[k]) for k in
                                   ("vox", "images", "normals", "codes", "poses"))
    if shard is not None:
        vox, img, nrm = shard.take(vox), shard.take(img), shard.take(nrm)
    offsets = [int(o) for o in inputs["offsets"]] if STEPS[case][1] else None
    saved = tsteps.FUSE_TEXTURE_RESAMPLE
    tsteps.FUSE_TEXTURE_RESAMPLE = fused and shard is not None
    try:
        state, loss = step(state, vox, img, nrm, codes, poses, STEP_RNG, offsets)
    finally:
        tsteps.FUSE_TEXTURE_RESAMPLE = saved
    return float(loss), jax_params_from_state_dict(grads[0]), _checksum(state.params)


def _rank(rank: int, tmp: str) -> None:
    """One rank of the 1 x 2 mesh; writes rank{rank}.pt."""
    torch.set_num_threads(1)
    distributed.initialize_multihost(f"file://{tmp}/init", 2, rank, device="cpu")
    try:
        mesh = distributed.make_mesh(n_data=1, n_model=2, device="cpu")
        sh = distributed.spatial_sharding(mesh, 5)
        inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
        params = dict(np.load(os.path.join(tmp, "params.npz")))
        net = ttex.init_texture_face_params(0, ttex.TextureFaceConfig(**ARCH), device="cpu")
        load_jax_params(net, params)
        out = {}
        with torch.no_grad():
            vox = torch.from_numpy(inputs["vox"])
            codes, poses = torch.from_numpy(inputs["codes"]), torch.from_numpy(inputs["poses"])
            rows = ttex.texture_face_forward(net, sh.take(vox), codes, poses, mesh=mesh)
            out["forward_rows"] = [tuple(t.shape) for t in rows]
            out["forward"] = ttex.texture_face_forward(net, sh.take(vox), codes, poses,
                                                       mesh=mesh, gather=True)
        for case in STEPS:
            loss, grads, checksum = _port_step(case, params, inputs, sh, mesh)
            out[case] = {"loss": loss, "grads": grads if rank == 0 else None,
                         "checksum": checksum}
        out["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "rendernet_tpu.")))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: inputs, the ranks, the references
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spatial_texture(tmp_path_factory):
    """Writes the inputs, starts the two ranks in the background, computes
    the references meanwhile and returns (references, ``get()``); ``get()``
    waits for the ranks (at most 240 s) and returns their results."""
    import jax
    from test_torch_distributed import _draws
    from test_torch_texture import texture_batch

    from rendernet_tpu.models import texture_face as jtex
    from rendernet_tpu.ops import crops as jcrops

    tmp = tmp_path_factory.mktemp("spatial_texture")
    vox, images, normals, codes, poses = texture_batch(2, seed=2, vox_size=16, img=128)
    crop_key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(STEP_RNG), 0))[0]
    offsets = np.asarray([int(o) for o in jcrops.random_crop_offsets(crop_key, 32, 16)])
    inputs = dict(vox=vox, images=images, normals=normals, codes=codes, poses=poses,
                  offsets=offsets)
    np.savez(tmp / "inputs.npz", **inputs)
    params = _draws(lambda k: jtex.init_texture_face_params(k, jtex.TextureFaceConfig(**ARCH)))
    np.savez(tmp / "params.npz", **params)
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
    """JAX's sharded forward and steps in a thread, the port's unsharded ones
    here."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_runs = pool.submit(_jax_runs, inputs, params)
        ref = {}
        net = ttex.init_texture_face_params(0, ttex.TextureFaceConfig(**ARCH), device="cpu")
        load_jax_params(net, params)
        with torch.no_grad():
            ref["forward"] = ttex.texture_face_forward(
                net, *(torch.from_numpy(inputs[k]) for k in ("vox", "codes", "poses")))
        for case in STEPS:
            loss, grads, _ = _port_step(case, params, inputs)
            ref[case] = {"loss": loss, "grads": grads}
        ref["jax"] = jax_runs.result()
    return ref


def _jax_runs(inputs, params):
    """JAX's ``texture_face_forward`` with the raw grid's rows over the model
    axis of a (1, 2) mesh, and its ``make_texture_train_step`` with the
    voxels, images and normals placed ``P("data", "model")``: the loss and
    the gradients (a recording optimizer keeps them as its state)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from rendernet_tpu.models import texture_face as jtex
    from rendernet_tpu.train import config as jconfig
    from rendernet_tpu.train import distributed as jdist
    from rendernet_tpu.train import steps as jsteps

    mcfg = jtex.TextureFaceConfig(**ARCH)
    mesh = jdist.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    p = jdist.replicate(mesh, {k: jnp.asarray(v) for k, v in params.items()})
    sp, dp = NamedSharding(mesh, P("data", "model")), NamedSharding(mesh, P("data"))
    fwd = jax.jit(lambda q, v, z, r: jtex.texture_face_forward(q, v, z, r, mcfg,
                                                               resample="exact"))
    out = {"forward": [np.asarray(t) for t in fwd(
        p, jax.device_put(inputs["vox"], sp), jax.device_put(inputs["codes"], dp),
        jax.device_put(inputs["poses"], dp))]}
    record = optax.GradientTransformation(
        lambda q: jax.tree.map(jnp.zeros_like, q),
        lambda g, s, q: (jax.tree.map(jnp.zeros_like, g), g))
    cfg = jconfig.TrainConfig(**CFG)
    for case in JAX_STEPS:  # the step donates its state: fresh params each time
        q = jdist.replicate(mesh, {k: jnp.asarray(v) for k, v in params.items()})
        state = jdist.replicate(mesh, jsteps.TrainState(q, record.init(q),
                                                        jnp.zeros((), jnp.int32)))
        step = jsteps.make_texture_train_step(mcfg, cfg, record, STEPS[case][0])
        state, loss = step(state, *(jax.device_put(inputs[k], sp)
                                    for k in ("vox", "images", "normals")),
                           *(jax.device_put(inputs[k], dp) for k in ("codes", "poses")),
                           jax.random.PRNGKey(STEP_RNG))
        out[case] = {"loss": float(loss),
                     "grads": {k: np.array(v) for k, v in state.opt_state.items()}}
    return out


def _grad_errors(got, want):
    """{parameter: max |g - g_ref| / max |g_ref|} over the trunk's and
    heads' parameters, and the same over the texture decoder's
    (``texture_encoder/...``), as two dicts."""
    assert set(got) == set(want)
    net, dec = {}, {}
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max() / max(np.abs(w).max(), 1e-30))
        (dec if k.startswith("texture_encoder/") else net)[k] = err
    return net, dec


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_sharded_texture_forward_matches_jax_and_the_whole_forward(spatial_texture):
    """``texture_face_forward`` on the 1 x 2 mesh (exact warp): each rank
    takes its 8 rows of the raw 16^3 grid, decodes the whole texture grid,
    warps both grids to its 16 camera rows with e_conv1's halo and returns
    its 64 rows of each head; gathered, both heads equal the port's
    unsharded forward and JAX's forward jitted with the grid's rows over
    its model axis, within atol 1e-5. No JAX module in either rank."""
    ref, get = spatial_texture
    for r in get():
        assert r["forward_rows"] == [(2, 64, 128, 3)] * 2
        assert r["jax_imported"] == []
        for got, whole, jax_out in zip(r["forward"], ref["forward"], ref["jax"]["forward"]):
            assert got.shape == (2, 128, 128, 3)
            np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=1e-5)
            np.testing.assert_allclose(got.numpy(), jax_out, atol=1e-5)


@pytest.mark.parametrize("case", sorted(STEPS))
def test_sharded_texture_step_matches_jax_and_the_whole_step(spatial_texture, case):
    """One texture step on the 1 x 2 mesh per case of STEPS (patch 32;
    patch 16 at JAX's crop offsets through the fused 5-channel warp;
    patch 32 with dropout at keep_prob 0.5): the loss within 1e-5 relative
    of the port's unsharded step and, without dropout, of JAX's step with
    the voxels, images and normals placed P("data", "model"). The
    model-summed gradients, per parameter as max |g - g_ref| / max |g_ref|,
    the trunk's and heads' apart from the texture decoder's (every rank
    runs the decoder whole on its partial grid cotangent, and only the
    model-axis sum of its gradients completes them: a missing or a doubled
    sum puts them 0.5 or 1.0 off): within 1e-4 of the port's unsharded
    step (readings up to 3.3e-6), and within 3e-3 of JAX's sharded step
    (readings 8.7e-4 and 1.1e-3 at patch 32, 4.9e-6 at patch 16): the
    gradients that cancel over the grid carry fp32 roundoff of sums that
    XLA and PyTorch order differently, as its unsharded comparisons in
    tests/test_torch_texture_train.py allow for through the params. The
    two ranks' params bit-equal after the step."""
    ref, get = spatial_texture
    ranks = get()
    got = ranks[0][case]
    wants = [(ref[case], 1e-4)] + ([(ref["jax"][case], 3e-3)] if case in JAX_STEPS else [])
    for want, tol in wants:
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        net, dec = _grad_errors(got["grads"], want["grads"])
        assert len(dec) == 15 and len(net) > 50
        for part in (net, dec):
            worst = max(part.items(), key=lambda kv: kv[1])
            assert worst[1] <= tol, (case, tol, worst)
    assert ranks[1][case]["checksum"] == got["checksum"]
