"""The port's spatial sharding (a ``model`` mesh axis over the rows) on the
CPU: gloo ranks, spawned, against the port without sharding and against
JAX's sharded runs on a mesh of the CPU devices.

Two spawned sessions run in the background while the parent computes the
references: two ranks on a 1 x 2 mesh (the halo exchange at m = 2, every
conv form on slabs, the sharded shader net and ``shader_forward``, dropout,
a sharded train step with dropout, the refusals) and four ranks (the halo
exchange at m = 4 over the whole group, then one train step on a 2 x 2
mesh with the voxels and images sharded ``P("data", "model")``). Each rank
saves what it computed and the tests compare. The model is JAX's own test
config, ``ShaderConfig(new_size=32)`` at full width (the 2D stacks 256 and
512 channels wide), batch 2, 16^3 voxels, 128^2 images, fp32; its weights
are numpy draws on JAX's key set (``tests/test_torch_distributed.py``'s
``_draws``) carried into both packages. The ranks import no JAX.
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

from rendernet_tpu_torch.compat.jax_params import jax_params_from_module, load_jax_params
from rendernet_tpu_torch.models import shader as tshader
from rendernet_tpu_torch.nn import layers as tl
from rendernet_tpu_torch.ops import halo
from rendernet_tpu_torch.train import config as tconfig
from rendernet_tpu_torch.train import distributed
from rendernet_tpu_torch.train import steps as tsteps
from rendernet_tpu_torch.train.optim import GradientTransformation

torch.set_num_threads(2)

TINY_MODEL = dict(new_size=32)
TINY = dict(batch_size=2, img_res=128, new_size=32, e_eta=1e-4, compute_dtype="float32",
            is_greyscale=True)
# The dropout step: a cut model (2/2/1 res blocks, base 16), keep_prob 0.5,
# the RGB loss (MSE: each rank's share is its squared errors over the whole
# image's element count).
DROP_ARCH = dict(new_size=32, res1_blocks=2, res2_blocks=2, res3_blocks=1, base=16,
                 keep_prob=0.5)
DROP_CFG = dict(TINY, is_greyscale=False)
HALOS = ((1, 1), (1, 2), (2, 1))
# Each conv form on slabs of 8 rows at m = 2: (kind, x shape, weight shape
# (JAX layout), stride, module switches). "k2" routes the 3x3x3 conv to
# K2's wrapper (its plain version on the CPU), "wino" the 3x3 conv to the
# plain Winograd expression (its halo in whole 2-row tiles), "phase" the
# strided convs to the phase-space rewrite.
CONV_CASES = {
    "3x3x3": ("conv", (2, 8, 6, 4, 3), (3, 3, 3, 3, 5), (1, 1, 1), {}),
    "3x3x3_k2": ("conv", (2, 8, 8, 8, 4), (3, 3, 3, 4, 16), (1, 1, 1), {"CUDA_CONV3D": True}),
    "3x3": ("conv", (2, 8, 6, 4), (3, 3, 4, 5), (1, 1), {}),
    "3x3_wino": ("conv", (2, 8, 6, 256), (3, 3, 256, 256), (1, 1), {"WINOGRAD_2D": True}),
    "k4_s1": ("conv", (2, 8, 6, 4), (4, 4, 4, 5), (1, 1), {}),
    "e_conv1": ("conv", (2, 8, 8, 8, 1), (5, 5, 5, 1, 3), (2, 2, 2), {}),
    "e_conv1_phase": ("conv", (2, 8, 8, 8, 1), (5, 5, 5, 1, 3), (2, 2, 2),
                      {"PHASE_CONV3D": "all"}),
    "e_conv2": ("conv", (2, 8, 8, 8, 3), (3, 3, 3, 3, 4), (1, 1, 2), {}),
    "e_conv2_phase": ("conv", (2, 8, 8, 8, 3), (3, 3, 3, 3, 4), (1, 1, 2),
                      {"PHASE_CONV3D": True}),
    "deconv_s2": ("deconv", (2, 8, 6, 4), (4, 4, 5, 4), (2, 2), {}),
    "deconv_s1": ("deconv", (2, 8, 6, 4), (4, 4, 5, 4), (1, 1), {}),
    "act_conv_2d": ("act_conv", (2, 8, 6, 4), (3, 3, 4, 4), (1, 1), {}),
    "act_conv_3d": ("act_conv", (2, 8, 6, 4, 3), (3, 3, 3, 3, 3), (1, 1, 1), {}),
    "act_conv_wino": ("act_conv", (2, 8, 6, 256), (3, 3, 256, 256), (1, 1),
                      {"WINOGRAD_2D": True}),
}

# Residual stacks of 2 blocks on slabs of 8 rows at m = 2: (x shape,
# remat, preact, CUDA_CONV2D). "hwnc" runs the stack HWNC-resident on K5's
# wrappers (their plain versions on the CPU), exchanging along axis 0;
# remat recomputes each block, its exchanges included, in the backward.
STACK_CASES = {
    "preact_2d": ((2, 8, 6, 4), False, True, False),
    "plain_3d": ((2, 8, 6, 4, 4), False, False, False),
    "remat_2d": ((2, 8, 6, 4), True, False, False),
    "hwnc": ((2, 8, 8, 256), False, False, True),
    "hwnc_remat": ((2, 8, 8, 256), True, False, True),
}


# ---------------------------------------------------------------------------
# the ranks (torch only)
# ---------------------------------------------------------------------------
def _seeded(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def _rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _halo_case(shard, lo, hi, rows=8):
    """(forward error, backward error, bytes sent, bytes received) of the
    exchange on this rank's rows of a seeded [2, rows, 3] tensor against
    slicing the zero-padded whole tensor, and the adjoint's against
    autograd through that slicing, with a seeded linear functional per
    rank; the bytes are the exchange's and its adjoint's."""
    x = _seeded((2, rows, 3), 1)
    h = rows // shard.size
    cs = [_seeded((2, lo + h + hi, 3), 100 + r) for r in range(shard.size)]
    xs = shard.take(x).clone().requires_grad_(True)
    sent, received = halo.sent_bytes, halo.received_bytes
    y = halo.exchange(xs, lo, hi, shard, 1)
    (y * cs[shard.index]).sum().backward()
    sent, received = halo.sent_bytes - sent, halo.received_bytes - received
    xw = x.clone().requires_grad_(True)
    pad = halo.pad_rows(xw, lo, hi, 1)
    want = [pad[:, r * h:r * h + lo + h + hi] for r in range(shard.size)]
    sum((w * c).sum() for w, c in zip(want, cs)).backward()
    return (float((y.detach() - want[shard.index].detach()).abs().max()),
            float((shard.gather(xs.grad) - xw.grad).abs().max()), sent, received)


def _conv_case(name, shard):
    """A conv form on this rank's slab against the whole-tensor op: the
    output, the input gradient and the weight gradient (summed over the
    model axis; act_conv also alpha's and the bias's), each as max |err|
    / max |whole|."""
    kind, x_shape, w_shape, stride, flags = CONV_CASES[name]
    saved = {k: getattr(tl, k) for k in flags}
    for k, v in flags.items():
        setattr(tl, k, v)
    try:
        ndim = len(stride)
        seed = zlib.crc32(name.encode())
        x, w = _seeded(x_shape, seed), 0.2 * _seeded(w_shape, seed + 1)
        extra = [_seeded(w_shape[-1:], seed + 2).abs() * 0.2,
                 _seeded(w_shape[-1:], seed + 3)] if kind == "act_conv" else []

        def op(xx, ww, *ex, sh=None):
            if kind == "conv":
                return tl.conv_slab(xx, ww, stride, ndim, sh)
            if kind == "deconv":
                f = lambda xe: tl.conv_transpose_op(xe, ww, stride, ndim)  # noqa: E731
                return f(xx) if sh is None else tl.on_slab(
                    f, xx, sh, tl.deconv_halo(ww.shape[0], stride[0]), up=stride[0])
            f = lambda ze: tl.act_conv(ze, ex[0], ww, ex[1], ndim)  # noqa: E731
            return f(xx) if sh is None else tl.on_slab(
                f, xx, sh, tl._conv_slab_halo(xx, ww.shape, stride, ndim))

        leaves = [x.clone().requires_grad_(True), w.clone().requires_grad_(True)] + [
            e.clone().requires_grad_(True) for e in extra]
        y = op(*leaves)
        c = _seeded(tuple(y.shape), seed + 4)
        (y * c).sum().backward()
        mine = [shard.take(leaves[0].detach()).clone().requires_grad_(True)] + [
            t.detach().clone().requires_grad_(True) for t in leaves[1:]]
        ys = op(*mine, sh=shard)
        (ys * shard.take(c)).sum().backward()
        partial = distributed.model_sum([t.grad for t in mine[1:]], _mesh_of(shard))
        errs = {"y": _rel(shard.gather(ys.detach()), y.detach()),
                "gx": _rel(shard.gather(mine[0].grad), leaves[0].grad)}
        for label, g, t in zip(("gw", "galpha", "gb"), partial, leaves[1:]):
            errs[label] = _rel(g, t.grad)
        return errs
    finally:
        for k, v in saved.items():
            setattr(tl, k, v)


def _stack_case(name, shard):
    """A residual stack on this rank's slab against the whole stack: the
    output, the input gradient and the worst parameter gradient (summed
    over the model axis), each as max |err| / max |whole|."""
    x_shape, remat, preact, conv2d = STACK_CASES[name]
    saved = tl.CUDA_CONV2D
    tl.CUDA_CONV2D = conv2d
    try:
        seed = zlib.crc32(name.encode())
        gen = torch.Generator().manual_seed(seed)
        blocks = [tl.ResBlock(x_shape[-1], len(x_shape) - 2, gen) for _ in range(2)]
        with torch.no_grad():  # alphas away from 0, so the negative slope counts
            for blk in blocks:
                blk.alpha.uniform_(0.05, 0.3, generator=gen)
        params = [p for blk in blocks for p in blk.parameters()]
        x = _seeded(x_shape, seed + 1).requires_grad_(True)
        y = tl.res_block_stack(blocks, x, remat=remat, preact=preact)
        c = _seeded(tuple(y.shape), seed + 2)
        whole = torch.autograd.grad((y * c).sum(), [x] + params)
        xs = shard.take(x.detach()).clone().requires_grad_(True)
        ys = tl.res_block_stack(blocks, xs, remat=remat, preact=preact, shard=shard)
        mine = torch.autograd.grad((ys * shard.take(c)).sum(), [xs] + params)
        summed = distributed.model_sum(list(mine[1:]), _mesh_of(shard))
        return {"hwnc": tl._hwnc_stack(blocks, xs, 2),
                "y": _rel(shard.gather(ys.detach()), y.detach()),
                "gx": _rel(shard.gather(mine[0]), whole[0]),
                "gparams": max(_rel(g, w) for g, w in zip(summed, whole[1:]))}
    finally:
        tl.CUDA_CONV2D = saved


def _mesh_of(shard):
    return distributed.Mesh({"data": 1, "model": shard.size}, None, torch.device("cpu"),
                            model_group=shard.group, model_rank=shard.index)


def _recording(tx, sink):
    def update(grads, state, params):
        sink.append({k: g.detach().clone() for k, g in grads.items()})
        return tx.update(grads, state, params)

    return GradientTransformation(tx.init, update)


def _checksum(net):
    return [zlib.crc32(p.detach().numpy().tobytes()) for p in net.parameters()]


def _rank_1x2(rank: int, tmp: str) -> None:
    """The 1 x 2 session; writes m2_rank{rank}.pt."""
    torch.set_num_threads(1)
    distributed.initialize_multihost(f"file://{tmp}/init2", 2, rank, device="cpu")
    try:
        out = {}
        try:
            distributed.make_mesh(n_data=2, n_model=2, device="cpu")
        except ValueError as e:
            out["mesh_2x2_in_2"] = str(e)
        mesh = distributed.make_mesh(n_data=1, n_model=2, device="cpu")
        sh = distributed.spatial_sharding(mesh, 5)
        out["mesh"] = (dict(mesh.shape), mesh.model_rank, sh.rows(32),
                       sh.local_rows(torch.zeros(2, 16, 1)))
        out["halo"] = {(lo, hi): _halo_case(sh, lo, hi) for lo, hi in HALOS}
        try:
            halo.exchange(torch.zeros(1, 4, 2), 5, 0, sh, 1)
        except ValueError as e:
            out["wide_halo"] = str(e)
        out["conv"] = {name: _conv_case(name, sh) for name in CONV_CASES}
        out["stack"] = {name: _stack_case(name, sh) for name in STACK_CASES}

        inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
        params = dict(np.load(os.path.join(tmp, "params.npz")))
        net = tshader.init_shader_params(0, tshader.ShaderConfig(**TINY_MODEL), device="cpu")
        load_jax_params(net, params)
        cam = torch.from_numpy(inputs["cam"])
        with torch.no_grad():
            out["net"] = sh.gather(net(sh.take(cam), shard=sh))
            vox, poses = torch.from_numpy(inputs["vox"]), torch.from_numpy(inputs["poses"])
            img = tshader.shader_forward(net, sh.take(vox), poses, mesh=mesh)
            out["forward_rows"] = tuple(img.shape)
            out["forward"] = distributed.gather_rows(img, mesh)
        # dropout: the slab's mask is the whole mask's rows
        x = _seeded((2, 8, 4, 3), 9)
        g = torch.Generator().manual_seed(3)
        out["dropout_slab"] = sh.gather(tl.dropout(sh.take(x), 0.5, g, shard=sh))
        out["dropout_rank"] = rank

        # a train step with dropout (keep_prob 0.5), the voxels' and images' rows
        dcfg = tconfig.TrainConfig(**DROP_CFG)
        dm = tshader.ShaderConfig(**DROP_ARCH)
        state, tx = tsteps.create_shader_state(1, dm, dcfg, device="cpu")
        step = tsteps.make_shader_train_step(dm, dcfg, tx, 32, mesh=mesh)
        batch = tuple(torch.from_numpy(inputs[k]) for k in ("vox", "images", "poses"))
        _, loss = step(state, sh.take(batch[0]), sh.take(batch[1]), batch[2], 7)
        out["dropout_loss"] = float(loss)
        out["dropout_params"] = _checksum(state.params)

        for what, call in (
                ("patch", lambda: tsteps.make_shader_train_step(dm, dcfg, tx, 30, mesh=mesh)),
                ("texture", lambda: tsteps.make_texture_train_step(None, dcfg, tx, 32,
                                                                   mesh=mesh)),
                ("recon", lambda: _recon_step(mesh))):
            try:
                out[f"built_{what}"] = callable(call())
            except (ValueError, NotImplementedError) as e:
                out[f"refuse_{what}"] = (type(e).__name__, str(e))
        out["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "rendernet_tpu.")))
        torch.save(out, os.path.join(tmp, f"m2_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _recon_step(mesh):
    from rendernet_tpu_torch.recon.inverse import ReconConfig, ReconModel, make_recon_step

    return make_recon_step(ReconModel(*(torch.nn.Identity() for _ in range(3))), ReconConfig(),
                           mesh=mesh)


def _rank_2x2(rank: int, tmp: str) -> None:
    """The four-rank session; writes m4_rank{rank}.pt."""
    torch.set_num_threads(1)
    distributed.initialize_multihost(f"file://{tmp}/init4", 4, rank, device="cpu")
    try:
        out = {}
        # the whole group as one model axis of 4
        whole = halo.RowShard(rank, 4, None, pairs=halo.neighbour_groups(range(4)))
        out["halo"] = {(lo, hi): _halo_case(whole, lo, hi) for lo, hi in HALOS}
        mesh = distributed.make_mesh(n_data=2, n_model=2, device="cpu")
        out["mesh"] = (dict(mesh.shape), mesh.model_rank,
                       torch.distributed.get_rank(mesh.group))
        inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
        cfg = tconfig.TrainConfig(**TINY)
        mcfg = tshader.ShaderConfig(**TINY_MODEL)
        state, tx = tsteps.create_shader_state(0, mcfg, cfg, device="cpu")
        load_jax_params(state.params, dict(np.load(os.path.join(tmp, "params.npz"))))
        state = distributed.replicate(mesh, state)
        grads = []
        step = tsteps.make_shader_train_step(mcfg, cfg, _recording(tx, grads), 32, mesh=mesh)
        d, m = divmod(rank, 2)

        def mine(a):  # P("data", "model"): batch row d, rows half m
            a = torch.from_numpy(a[d:d + 1])
            return a if a.dim() < 3 else a[:, m * a.shape[1] // 2:(m + 1) * a.shape[1] // 2]

        state, loss = step(state, mine(inputs["vox"]), mine(inputs["images"]),
                           mine(inputs["poses"]), 7)
        out["loss"] = float(loss)
        out["grads"] = {k: g.numpy() for k, g in grads[0].items()} if rank == 0 else None
        out["params"] = jax_params_from_module(state.params) if rank == 0 else None
        out["checksum"] = _checksum(state.params)
        torch.save(out, os.path.join(tmp, f"m4_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: inputs, the sessions, the references
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def spatial(tmp_path_factory):
    """Writes the inputs, starts both sessions in the background, computes
    the references meanwhile (:func:`_references`) and returns (references,
    ``get()``); ``get()`` waits for the ranks (at most 240 s) and returns
    (the 1 x 2 ranks' results, the four ranks')."""
    from test_torch_distributed import _draws
    from test_torch_train import _batch

    from rendernet_tpu.models import shader as jshader

    tmp = tmp_path_factory.mktemp("spatial")
    vox, images, poses = _batch(2, seed=3)
    cam = np.random.default_rng(4).random((2, 32, 32, 32, 1)).astype(np.float32)
    np.savez(tmp / "inputs.npz", vox=vox, images=images, poses=poses, cam=cam)
    params = _draws(lambda k: jshader.init_shader_params(k, jshader.ShaderConfig(**TINY_MODEL)))
    np.savez(tmp / "params.npz", **params)
    errors = []

    def run(fn, n):
        try:
            distributed.launch(fn, n, (str(tmp),), timeout=240)
        except BaseException as e:  # re-raised by get()
            errors.append(e)

    threads = [threading.Thread(target=run, args=a) for a in ((_rank_1x2, 2), (_rank_2x2, 4))]
    for t in threads:
        t.start()
    results = []

    def get():
        if not results:
            for t in threads:
                t.join(300)
                assert not t.is_alive(), "the ranks did not finish"
            if errors:
                raise errors[0]
            results.append([torch.load(tmp / f"m2_rank{r}.pt", weights_only=False)
                            for r in range(2)])
            results.append([torch.load(tmp / f"m4_rank{r}.pt", weights_only=False)
                            for r in range(4)])
        return results

    try:
        yield _references(vox, images, poses, cam, params), get
    finally:
        for t in threads:
            t.join(300)


def _references(vox, images, poses, cam, params):
    """JAX's sharded runs (the net on a 1 x 2 mesh, one train step on a
    2 x 2 mesh) in a thread, and the port's unsharded runs here."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_runs = pool.submit(_jax_runs, vox, images, poses, cam, params)
        ref = {}
        net = tshader.init_shader_params(0, tshader.ShaderConfig(**TINY_MODEL), device="cpu")
        load_jax_params(net, params)
        with torch.no_grad():
            ref["net"] = net(torch.from_numpy(cam))
            ref["forward"] = tshader.shader_forward(net, torch.from_numpy(vox),
                                                    torch.from_numpy(poses))
        cfg = tconfig.TrainConfig(**TINY)
        mcfg = tshader.ShaderConfig(**TINY_MODEL)
        state, tx = tsteps.create_shader_state(0, mcfg, cfg, device="cpu")
        load_jax_params(state.params, params)
        grads = []
        step = tsteps.make_shader_train_step(mcfg, cfg, _recording(tx, grads), 32)
        batch = tuple(torch.from_numpy(a) for a in (vox, images, poses))
        state, loss = step(state, *batch, 7)
        ref["loss"] = float(loss)
        ref["grads"] = {k: g.numpy() for k, g in grads[0].items()}
        ref["params"] = jax_params_from_module(state.params)
        ref["grads64"] = _float64_grads(params, mcfg, vox, images, poses)
        dm, dcfg = tshader.ShaderConfig(**DROP_ARCH), tconfig.TrainConfig(**DROP_CFG)
        dstate, dtx = tsteps.create_shader_state(1, dm, dcfg, device="cpu")
        _, dloss = tsteps.make_shader_train_step(dm, dcfg, dtx, 32)(dstate, *batch, 7)
        ref["dropout_loss"] = float(dloss)
        ref["dropout_params"] = _checksum(dstate.params)
        ref["jax"] = jax_runs.result()
    return ref


def _float64_grads(params, mcfg, vox, images, poses):
    """The step's gradients in float64: the exact warp (fp32, as the step's),
    then the network and the loss in float64."""
    from rendernet_tpu_torch.ops.resample import rotate_resample_to_camera

    net = tshader.init_shader_params(0, mcfg, device="cpu")
    load_jax_params(net, params)
    net = net.double()
    cam = rotate_resample_to_camera(torch.from_numpy(vox), torch.from_numpy(poses),
                                    new_size=mcfg.new_size)
    pred = net(cam.double(), train=True, cfg=mcfg)
    loss = tsteps.shader_loss_from_images(pred, torch.from_numpy(images).double(), True)
    names = [k for k, _ in net.named_parameters()]
    return {k: g.numpy() for k, g in zip(names, torch.autograd.grad(loss,
                                                                    list(net.parameters())))}


def _jax_runs(vox, images, poses, cam, params):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from rendernet_tpu.models.shader import ShaderConfig, shader_rendernet
    from rendernet_tpu.nn.layers import Module
    from rendernet_tpu.train import config as jconfig
    from rendernet_tpu.train import distributed as jdist
    from rendernet_tpu.train import steps as jsteps
    from rendernet_tpu.train.optim import make_optimizer

    mcfg = ShaderConfig(**TINY_MODEL)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    mesh = jdist.make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    net = jax.jit(lambda q, v: shader_rendernet(Module(params=q), v, mcfg))
    out = {"net": np.asarray(net(jdist.replicate(mesh, p),
                                 jax.device_put(cam, jdist.spatial_sharding(mesh, 5, axis=1))))}
    cfg = jconfig.TrainConfig(**TINY)
    tx = make_optimizer(cfg.e_eta, cfg.decay_steps, cfg.decay_rate)
    mesh2 = jdist.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    state = jdist.replicate(mesh2, jsteps.TrainState(p, tx.init(p), jnp.zeros((), jnp.int32)))
    step = jsteps.make_shader_train_step(mcfg, cfg, tx, patch_size=32)
    sp = NamedSharding(mesh2, P("data", "model"))
    state, loss = step(state, jax.device_put(vox, sp), jax.device_put(images, sp),
                       jax.device_put(poses, NamedSharding(mesh2, P("data"))),
                       jax.random.PRNGKey(7))
    out["loss"] = float(loss)
    out["params"] = {k: np.array(v) for k, v in state.params.items()}
    return out


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_meshes_and_refusals_in_the_group(spatial):
    """A 1 x 2 mesh over two ranks (model index = rank; rows [16 m, 16 m +
    16) of 32, and of a rank's own 16), a 2 x 2 mesh over four laid out as JAX's reshape (rank =
    2 d + m), a (2, 2) mesh over two ranks refused; a patch that does not
    divide by 2 x the model axis refused; the texture step and the recon
    step build under a model axis (tests/test_torch_spatial_texture.py and
    tests/test_torch_spatial_recon.py run them); no JAX module in any
    rank."""
    _, get = spatial
    m2, m4 = get()
    for rank, r in enumerate(m2):
        rows = (16 * rank, 16 * rank + 16)
        assert r["mesh"] == ({"data": 1, "model": 2}, rank, rows, rows)
        assert "mesh over 2 process" in r["mesh_2x2_in_2"]
        assert r["refuse_patch"][0] == "ValueError" and "divide by 2 x 2" in r["refuse_patch"][1]
        for what in ("texture", "recon"):
            assert r[f"built_{what}"] is True and f"refuse_{what}" not in r
        assert r["jax_imported"] == []
    for rank, r in enumerate(m4):
        assert r["mesh"] == ({"data": 2, "model": 2}, rank % 2, rank // 2)


@pytest.mark.parametrize("m", [2, 4])
def test_halo_exchange_and_its_adjoint(spatial, m):
    """The exchange of (1, 1), (1, 2) and (2, 1) rows at m = 2 (a model axis)
    and m = 4 (the whole group): its forward equals slicing the zero-padded
    whole tensor exactly, its backward the adjoint (autograd of a seeded
    linear functional through that slicing) to 1e-6; each rank sends and
    receives max(lo, hi) rows of [2, ., 3] fp32 per neighbour each way,
    whatever m (neighbour pairs, not the whole model axis); a halo wider
    than the neighbour's slab raises."""
    _, get = spatial
    ranks = get()[0] if m == 2 else get()[1]
    for rank, r in enumerate(ranks):
        assert set(r["halo"]) == set(HALOS)
        neighbours = (rank > 0) + (rank < m - 1)
        for (lo, hi), (fwd, bwd, sent, received) in r["halo"].items():
            assert fwd == 0.0 and bwd <= 1e-6, (m, lo, hi, fwd, bwd)
            assert sent == received == 2 * neighbours * max(lo, hi) * 2 * 3 * 4, (m, rank, sent)
    assert "one neighbour" in get()[0][0]["wide_halo"]


@pytest.mark.parametrize("name", sorted(CONV_CASES))
def test_conv_forms_on_slabs_match_the_whole_op(spatial, name):
    """Each conv form on 4-row slabs (m = 2; the strided ones on the 8-row
    input's slabs) against the op on the whole tensor: the output, the input
    gradient and the weight gradient (summed over the model axis; act_conv
    also alpha's and the bias's), each within 1e-5 of its max in fp32 (the
    slab's convs sum the same products in other orders)."""
    _, get = spatial
    for r in get()[0]:
        errs = r["conv"][name]
        assert max(errs.values()) <= 1e-5, (name, errs)
        assert len(errs) == (5 if CONV_CASES[name][0] == "act_conv" else 3)


@pytest.mark.parametrize("name", sorted(STACK_CASES))
def test_res_stacks_on_slabs_match_the_whole_stack(spatial, name):
    """Two residual blocks on 4-row slabs (m = 2) against the whole stack:
    preact (act_conv on the pre-activation's extended slab), plain 3-D,
    remat (the checkpoint's recompute exchanges again), and the
    HWNC-resident route on K5's wrappers along axis 0, with and without
    remat: the output, the input gradient and every parameter's gradient
    (summed over the model axis) within 1e-5 of their max in fp32."""
    _, get = spatial
    for r in get()[0]:
        errs = dict(r["stack"][name])
        assert errs.pop("hwnc") == STACK_CASES[name][3], name
        assert max(errs.values()) <= 1e-5, (name, errs)


def test_sharded_net_matches_jax_and_the_whole_net(spatial):
    """The shader net (``ShaderConfig(new_size=32)``, full width) on a 1 x 2
    mesh, each rank on its 16 camera rows with halo exchanges, the rows
    gathered: equal to the port's unsharded net and to JAX's
    ``shader_rendernet`` jitted on a (1, 2) mesh with the grid under
    ``spatial_sharding(mesh, 5, axis=1)`` (tests/test_train.py's), both
    within atol 1e-5."""
    ref, get = spatial
    for r in get()[0]:
        got = r["net"].numpy()
        assert got.shape == (2, 128, 128, 1)
        np.testing.assert_allclose(got, ref["net"].numpy(), atol=1e-5)
        np.testing.assert_allclose(got, ref["jax"]["net"], atol=1e-5)


def test_sharded_shader_forward_matches_the_whole_forward(spatial):
    """``shader_forward`` with the 1 x 2 mesh (exact warp): each rank takes
    its rows of the raw 16^3 grid, warps its camera rows with e_conv1's
    halo and returns its 64 image rows; ``gather_rows`` of them equals the
    unsharded forward within atol 1e-5 (``gather=True`` runs in the
    four-rank dry run below)."""
    ref, get = spatial
    for r in get()[0]:
        assert r["forward_rows"] == (2, 64, 128, 1)
        np.testing.assert_allclose(r["forward"].numpy(), ref["forward"].numpy(), atol=1e-5)


def test_sharded_train_step_matches_jax_and_the_whole_step(spatial):
    """One train step on a 2 x 2 mesh (batch rows over data, voxel and image
    rows over model, ``P("data", "model")``): the loss equals JAX's step on
    a (2, 2) mesh of CPU devices (tests/test_train.py's) and the port's
    unsharded step to 1e-5 relative; the four ranks' params are bit-equal.
    The model-summed, data-averaged gradients, per parameter, lie within
    1e-2 of its max from the step's float64 gradients, as the unsharded
    step's do: at these inputs both fp32 steps sit up to 3e-3 (sharded) and
    5.6e-3 (unsharded) from them, the fp32 roundoff of 25 residual blocks
    and their adjoints summed in other orders. The params after the step
    match JAX's sharded step's and the unsharded step's as
    tests/test_torch_train.py's _assert_params_close (Adam's first step
    moves a value by +-lr, so a gradient near zero may flip its sign)."""
    from test_torch_train import _assert_params_close

    ref, get = spatial
    ranks = get()[1]
    for r in ranks:
        assert r["loss"] == pytest.approx(ref["jax"]["loss"], rel=1e-5)
        assert r["loss"] == pytest.approx(ref["loss"], rel=1e-5)
        assert r["checksum"] == ranks[0]["checksum"]
    g64 = ref["grads64"]
    for grads in (ranks[0]["grads"], ref["grads"]):
        assert set(grads) == set(g64)
        worst = max((float(np.abs(grads[k] - g).max() / np.abs(g).max()), k)
                    for k, g in g64.items())
        assert worst[0] <= 1e-2, worst
    _assert_params_close(ranks[0]["params"], ref["jax"]["params"], TINY["e_eta"])
    _assert_params_close(ranks[0]["params"], ref["params"], TINY["e_eta"])


def test_sharded_dropout_draws_the_whole_masks(spatial):
    """keep_prob 0.5: a slab's mask is its rows of the mask drawn at the
    whole tensor's shape from the same generator; a train step with
    dropout and the RGB loss on the 1 x 2 mesh (the model ranks share the
    dropout seed; each rank's MSE is its share of the whole image's) has
    the unsharded step's loss to 1e-5 relative and the same params on
    both ranks, which only the same masks give."""
    ref, get = spatial
    x = _seeded((2, 8, 4, 3), 9)
    want = tl.dropout(x, 0.5, torch.Generator().manual_seed(3))
    ranks = get()[0]
    for r in ranks:
        assert torch.equal(r["dropout_slab"], want)
        assert r["dropout_loss"] == pytest.approx(ref["dropout_loss"], rel=1e-5)
        assert r["dropout_params"] == ranks[0]["dropout_params"]


def test_graft_entry_dryrun_four_ranks_runs_the_spatial_phases(monkeypatch):
    """graft_entry.dryrun_multichip(4) on the CPU (a cut model, one thread
    per rank): phase 1 (data parallel), and on a (2, 2) mesh phase 2 (the
    dp + spatial forward of the 4-sample batch, finite, gathered to [4,
    128, 128, 1]) and phase 2b (a dp + spatial train step at patch 16),
    then phase 3 (a data-parallel texture step at patch 16) and phase 4 (a
    2-step recon scan, one hypothesis per rank, its [2, 4] loss history
    gathered), finite losses."""
    from rendernet_tpu_torch import graft_entry

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # read by each spawned rank's torch

    res = graft_entry.dryrun_multichip(4, device="cpu", model_cfg=tshader.ShaderConfig(
        new_size=32, res1_blocks=1, res2_blocks=1, res3_blocks=1, base=8))
    assert set(res) == set(graft_entry.DRYRUN_PHASES)
    assert res["spatial_forward"] == [4, 128, 128, 1]
    assert np.isfinite(res["loss"]) and np.isfinite(res["spatial_loss"]) and res["spatial_loss"] > 0
    assert np.isfinite(res["texture_loss"]) and res["texture_loss"] > 0
    losses = np.asarray(res["recon_losses"])
    assert losses.shape == (2, 4) and np.isfinite(losses).all() and (losses > 0).all()
