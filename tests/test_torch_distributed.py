"""The port's data parallelism (``train/distributed.py``) on the CPU: two
ranks over gloo, spawned, against JAX's sharded steps on a 2-device mesh.

One spawned run of two ranks (a process group on a file store in
``tmp_path``) runs every port-side scenario: the shader step with the fp32
all-reduce, with grad accumulation 2 and with the bf16 all-reduce, the
texture step, ``replicate``, dropout and crops, and ``train_shader`` on a
synthetic tar; each rank saves what it saw and the tests compare. While the
ranks run, the parent computes JAX's steps: the same params (numpy draws on
JAX's key set and shapes, through the flat npz keys and
``compat/jax_params.py``) and the same numpy inputs, the global batch sharded over
``make_mesh(n_data=2, devices=jax.devices()[:2])``. Models as
``tests/test_torch_train.py`` (shader, patch 32 = new_size) and
``tests/test_torch_texture_train.py`` (texture). The ranks import no JAX:
this module imports it only inside the tests that use it.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from rendernet_tpu_torch.compat.jax_params import jax_params_from_module, load_jax_params
from rendernet_tpu_torch.models import shader as tshader
from rendernet_tpu_torch.models import texture_face as ttex
from rendernet_tpu_torch.train import config as tconfig
from rendernet_tpu_torch.train import distributed
from rendernet_tpu_torch.train import steps as tsteps

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
ARCH = dict(new_size=32, res1_blocks=2, res2_blocks=2, res3_blocks=1, base=16,
            preact_policy=True)
TEX_ARCH = dict(tex_base=8, new_size=32, res1_blocks=1, res2_blocks=1, res3_blocks=1, base=8)
LOOP_ARCH = dict(new_size=32, res1_blocks=1, res2_blocks=1, res3_blocks=1, base=8)
SHADER_BASE = dict(batch_size=4, img_res=128, new_size=32, compute_dtype="float32",
                   e_eta=1e-4, decay_steps=2, is_greyscale=True)
TEX_BASE = dict(SHADER_BASE, batch_size=2, is_greyscale=False)
# JAX's bf16 all-reduce (shard_map) cannot differentiate preact_policy's
# custom-VJP unit (_act_conv) under jax 0.9 ("varying manual axes do not
# match"), so the bf16 run against JAX's leaves preact_policy off.
PLAIN_ARCH = dict(ARCH, preact_policy=False)
# The shader runs: (TrainConfig fields beyond SHADER_BASE, model), and the
# ones JAX runs too.
SHADER_RUNS = {"fp32": ({}, ARCH), "accum": ({"grad_accum_steps": 2}, ARCH),
               "bf16": ({"allreduce_dtype": "bfloat16"}, ARCH),
               "bf16_plain": ({"allreduce_dtype": "bfloat16"}, PLAIN_ARCH)}
JAX_RUNS = ("fp32", "accum", "bf16_plain")
STEPS = 2


# ---------------------------------------------------------------------------
# the ranks (torch only)
# ---------------------------------------------------------------------------
def _run_steps(make_step, state, batch, rank, mesh, steps=STEPS):
    """Each step's loss and parameters (JAX's flat keys) on this rank's half
    of ``batch`` (the global batch, rank order)."""
    local = batch[0].shape[0] // 2
    local_batch = distributed.shard_batch(
        mesh, tuple(a[rank * local:(rank + 1) * local] for a in batch))
    step = make_step()
    losses, params = [], []
    for _ in range(steps):
        state, loss = step(state, *local_batch, 7)
        losses.append(float(loss))
        # copies: the next step updates the parameters in place
        params.append({k: np.array(v) for k, v in jax_params_from_module(state.params).items()})
    return state, {"losses": losses, "params": params}


def _rank_run(rank: int, tmp: str) -> None:
    """Every port-side scenario on one rank of two; writes rank{rank}.pt."""
    from rendernet_tpu_torch.train.checkpoint import _flatten
    from rendernet_tpu_torch.train.loop import train_shader

    torch.set_num_threads(2)
    distributed.initialize_multihost(f"file://{tmp}/init", 2, rank, device="cpu")
    try:
        mesh = distributed.make_mesh(device="cpu")
        inputs = dict(np.load(os.path.join(tmp, "inputs.npz")))
        shader_p = dict(np.load(os.path.join(tmp, "shader_params.npz")))
        tex_p = dict(np.load(os.path.join(tmp, "texture_params.npz")))
        batch = tuple(torch.from_numpy(inputs[k]) for k in ("vox", "images", "poses"))
        out = {"mesh_shape": dict(mesh.shape), "process_shard": distributed.process_shard(4)}
        try:
            distributed.process_shard(3)
        except ValueError:
            out["process_shard_3"] = "ValueError"
        try:
            tsteps.make_shader_train_step(tshader.ShaderConfig(**ARCH),
                                          tconfig.TrainConfig(**SHADER_BASE), None, 32)
        except RuntimeError as e:
            out["no_mesh"] = str(e)
        for name, (kw, arch) in SHADER_RUNS.items():
            cfg = tconfig.TrainConfig(**SHADER_BASE, **kw)
            mcfg = tshader.ShaderConfig(**arch)
            state, tx = tsteps.create_shader_state(1, mcfg, cfg, device="cpu")
            load_jax_params(state.params, shader_p)
            state = distributed.replicate(mesh, state)
            state, out[name] = _run_steps(
                lambda: tsteps.make_shader_train_step(mcfg, cfg, tx, 32, mesh=mesh),
                state, batch, rank, mesh)
        # replicate: rank 1's state perturbed, then rank 0's broadcast
        if rank == 1:
            with torch.no_grad():
                for p in state.params.parameters():
                    p.add_(1.0)
                for t in _flatten(state.opt_state)[1]:
                    t.add_(1)
            state.step = 5
        state = distributed.replicate(mesh, state)
        out["replicated"] = {"params": jax_params_from_module(state.params),
                             "opt": [t.clone() for t in _flatten(state.opt_state)[1]],
                             "step": state.step}

        tcfg = tconfig.TrainConfig(**TEX_BASE)
        tm = ttex.TextureFaceConfig(**TEX_ARCH)
        state, tx = tsteps.create_texture_state(1, tm, tcfg, device="cpu")
        load_jax_params(state.params, tex_p)
        state = distributed.replicate(mesh, state)
        tbatch = tuple(torch.from_numpy(inputs[f"tex_{k}"])
                       for k in ("vox", "images", "normals", "codes", "poses"))
        _, out["texture"] = _run_steps(
            lambda: tsteps.make_texture_train_step(tm, tcfg, tx, 32, mesh=mesh),
            state, tbatch, rank, mesh)

        # dropout and crops: both ranks get the same rows at patch 16
        masks, offsets = [], []
        dropout, crop = tshader.dropout, tsteps.random_crop_offsets

        def recording_dropout(x, keep_prob, generator, train=True, shard=None):
            saved = generator.get_state()
            masks.append(torch.rand(x.shape, generator=generator, device=x.device) < keep_prob)
            generator.set_state(saved)
            return dropout(x, keep_prob, generator, train, shard)

        def recording_crop(*a):
            offsets.append(tuple(crop(*a)))
            return offsets[-1]

        tshader.dropout, tsteps.random_crop_offsets = recording_dropout, recording_crop
        try:
            dcfg = tconfig.TrainConfig(**SHADER_BASE, keep_prob=0.5)
            dm = tshader.ShaderConfig(**ARCH, keep_prob=0.5)
            state, tx = tsteps.create_shader_state(1, dm, dcfg, device="cpu")
            step = tsteps.make_shader_train_step(dm, dcfg, tx, 16, mesh=mesh)
            step(state, *distributed.shard_batch(mesh, tuple(a[:2] for a in batch)), 7)
        finally:
            tshader.dropout, tsteps.random_crop_offsets = dropout, crop
        out["dropout"] = {"masks": masks, "offsets": offsets}

        with open(os.path.join(tmp, "loop.json")) as f:
            loop_cfg = json.load(f)
        loop_cfg["sample_save"] = os.path.join(tmp, f"loop{rank}")
        state = train_shader(tconfig.TrainConfig(**loop_cfg),
                             tshader.ShaderConfig(**LOOP_ARCH), device="cpu")
        out["loop"] = {"params": jax_params_from_module(state.params), "step": state.step}
        out["jax_imported"] = sorted(m for m in sys.modules if m == "jax" or m.startswith(
            ("jax.", "rendernet_tpu.")))
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the parent: inputs, the spawned ranks, JAX's references
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Writes the inputs, starts the two ranks in the background, runs JAX's
    steps meanwhile (:func:`_jax_runs`) and returns (inputs, JAX's runs,
    ``get()``), where ``get()`` waits for the ranks (at most 240 s) and
    loads both ranks' results."""
    from test_torch_loop import _shader_cfg
    from test_torch_texture import texture_batch
    from test_torch_train import _batch

    from rendernet_tpu.models import shader as jshader
    from rendernet_tpu.models import texture_face as jtex

    tmp = tmp_path_factory.mktemp("dist")
    vox, images, poses = _batch(4, seed=1)
    tvox, timages, tnormals, tcodes, tposes = texture_batch(2, seed=1)
    np.savez(tmp / "inputs.npz", vox=vox, images=images, poses=poses, tex_vox=tvox,
             tex_images=timages, tex_normals=tnormals, tex_codes=tcodes, tex_poses=tposes)
    shader_p = _draws(lambda k: jshader.init_shader_params(k, jshader.ShaderConfig(**ARCH)))
    tex_p = _draws(lambda k: jtex.init_texture_face_params(k, jtex.TextureFaceConfig(**TEX_ARCH)))
    np.savez(tmp / "shader_params.npz", **shader_p)
    np.savez(tmp / "texture_params.npz", **tex_p)
    loop_data = _loop_data(tmp_path_factory)
    loop_cfg = _shader_cfg(loop_data, "", sample_every_steps=1)
    (tmp / "loop.json").write_text(json.dumps(loop_cfg))
    errors = []

    def run():
        try:
            distributed.launch(_rank_run, 2, (str(tmp),), timeout=240)
        except BaseException as e:  # re-raised by get()
            errors.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    inputs = {"shader": (vox, images, poses), "texture": (tvox, timages, tnormals, tcodes, tposes),
              "shader_params": shader_p, "texture_params": tex_p, "loop_data": loop_data,
              "loop_cfg": loop_cfg, "tmp": tmp}
    results = []

    def get():
        if not results:
            thread.join(300)
            assert not thread.is_alive(), "the ranks did not finish"
            if errors:
                raise errors[0]
            results.extend(torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in (0, 1))
        return results

    try:
        yield inputs, _jax_runs(inputs), get
    finally:
        thread.join(300)


def _draws(init, seed=0):
    """Params on JAX's key set and shapes (``jax.eval_shape`` of the init, so
    no JAX init runs), drawn with numpy as JAX's init draws them: weights
    xavier-uniform, biases 0; the PReLU alphas uniform in [0.05, 0.3), away
    from 0 so the negative slope counts."""
    import math

    import jax

    rng = np.random.default_rng(seed)
    out = {}
    for k, v in sorted(jax.eval_shape(init, jax.random.PRNGKey(0)).items()):
        if k.endswith("alpha"):
            out[k] = rng.uniform(0.05, 0.3, v.shape)
        elif k.endswith("biases"):
            out[k] = np.zeros(v.shape)
        else:
            field = math.prod(v.shape[:-2])
            limit = math.sqrt(6.0 / (field * (v.shape[-2] + v.shape[-1])))
            out[k] = rng.uniform(-limit, limit, v.shape)
    return {k: a.astype(np.float32) for k, a in out.items()}


def _loop_data(tmp_path_factory):
    """test_torch_loop's synthetic shader tar (2 models x 2 poses, 128^2)."""
    from test_torch_texture import sphere_box

    from rendernet_tpu_torch.data.synthetic import make_synthetic_shader_tar
    from rendernet_tpu_torch.io.binvox import save_binvox

    d = tmp_path_factory.mktemp("loopdata")
    paths = []
    for i, g in enumerate((sphere_box(64), sphere_box(64)[::-1])):
        paths.append(str(d / f"proc{i}.binvox"))
        save_binvox(np.ascontiguousarray(g), paths[-1])
    return {"shader": make_synthetic_shader_tar(str(d / "shader"), paths, ((30, 60), (120, 75)),
                                                img_res=128, device="cpu")}


def _jax_runs(inputs):
    """JAX's sharded steps on a 2-device data mesh: the shader runs of
    JAX_RUNS and the texture run, STEPS steps each, as {"losses", "params"}
    (params after each step)."""
    import jax
    import jax.numpy as jnp

    from rendernet_tpu.models import shader as jshader
    from rendernet_tpu.models import texture_face as jtex
    from rendernet_tpu.train import config as jconfig
    from rendernet_tpu.train import distributed as jdist
    from rendernet_tpu.train import steps as jsteps
    from rendernet_tpu.train.optim import make_optimizer

    mesh = jdist.make_mesh(n_data=2, devices=jax.devices()[:2])

    def run(make_step, cfg, params, batch):
        tx = make_optimizer(cfg.e_eta, cfg.decay_steps, cfg.decay_rate,
                            moment_dtype=cfg.moment_dtype)
        params = {k: jnp.asarray(v) for k, v in params.items()}
        state = jdist.replicate(mesh, jsteps.TrainState(params, tx.init(params),
                                                        jnp.zeros((), jnp.int32)))
        step = make_step(tx)
        batch = jdist.shard_batch(mesh, tuple(jnp.asarray(a) for a in batch))
        res = {"losses": [], "params": []}
        for _ in range(STEPS):
            state, loss = step(state, *batch, jax.random.PRNGKey(7))
            res["losses"].append(float(loss))
            # copies: the next step donates this state's buffers
            res["params"].append(jax.tree.map(np.array, state.params))
        return res

    def shader(name):
        kw, arch = SHADER_RUNS[name]
        cfg = jconfig.TrainConfig(**SHADER_BASE, **kw)
        mcfg = jshader.ShaderConfig(**arch)
        return run(lambda tx: jsteps.make_shader_train_step(mcfg, cfg, tx, 32, mesh=mesh),
                   cfg, inputs["shader_params"], inputs["shader"])

    def texture():
        cfg = jconfig.TrainConfig(**TEX_BASE)
        tm = jtex.TextureFaceConfig(**TEX_ARCH)
        return run(lambda tx: jsteps.make_texture_train_step(tm, cfg, tx, 32, mesh=mesh),
                   cfg, inputs["texture_params"], inputs["texture"])

    # one thread per run: their compiles overlap
    with concurrent.futures.ThreadPoolExecutor(len(JAX_RUNS) + 1) as pool:
        futures = {name: pool.submit(shader, name) for name in JAX_RUNS}
        futures["texture"] = pool.submit(texture)
        return {name: f.result() for name, f in futures.items()}


def _assert_params_close(tp, jp, lr):
    from test_torch_train import _assert_params_close

    _assert_params_close(tp, jp, lr)


def _max_dev(a, b):
    """(max |a - b| over every parameter, the parameter where it is)."""
    return max((float(np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64)).max()), k)
               for k in b)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------
def test_initialize_multihost_noop_without_config(monkeypatch):
    """As tests/test_train.py's: with no coordinator in the arguments or the
    environment nothing happens; a process count without one is an error
    that names the way out."""
    for var in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_multihost() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="--coordinator"):
        distributed.initialize_multihost(num_processes=2)


def test_process_shard_and_mesh_in_one_process():
    """One process: the whole batch, a 1 x 1 mesh with no group; a data
    axis of 2 or a model axis of 2 raise ValueError (PyTorch runs one
    process per card, and one process cannot hold two); the sharding of
    the 1 x 1 mesh's model axis is the whole tensor (one slab), and a
    sharded axis other than 1 is refused as JAX's callers shard the rows
    only (tests/test_torch_spatial.py runs the model axis in a group)."""
    assert distributed.process_shard(16) == (16, 0, 1)
    mesh = distributed.make_mesh(device="cpu")
    assert dict(mesh.shape) == {"data": 1, "model": 1} and mesh.group is None
    assert mesh.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="one process per card"):
        distributed.make_mesh(n_data=2, device="cpu")
    for call in (lambda: distributed.make_mesh(n_model=2, device="cpu"),
                 lambda: distributed.make_hybrid_mesh(n_model=2, device="cpu")):
        with pytest.raises(ValueError, match="model axis of 2"):
            call()
    shard = distributed.spatial_sharding(mesh, 5)
    x = torch.arange(8.0).reshape(1, 8, 1, 1, 1)
    assert shard.rows(8) == shard.local_rows(x) == (0, 8) and torch.equal(shard.take(x), x)
    assert distributed.gather_rows(x, mesh) is x
    with pytest.raises(NotImplementedError, match="axis 2"):
        distributed.spatial_sharding(mesh, 5, axis=2)
    (x,) = distributed.shard_batch(mesh, (np.arange(6, dtype=np.float32).reshape(3, 2),))
    assert isinstance(x, torch.Tensor) and x.shape == (3, 2)
    net = tshader.init_shader_params(0, tshader.ShaderConfig(**LOOP_ARCH), device="cpu")
    n = sum(p.numel() for p in net.parameters())
    assert distributed.gradient_bytes(net) == 4 * n
    assert distributed.gradient_bytes(net, torch.bfloat16) == 2 * n


def test_ranks_see_a_two_rank_group(ranks):
    """Inside the group: a 2 x 1 mesh, half the batch per rank, an odd
    batch refused, a step without a mesh refused (its ranks would train
    apart), and no JAX module in either rank."""
    _, _, get = ranks
    for rank, r in enumerate(get()):
        assert r["mesh_shape"] == {"data": 2, "model": 1}
        assert r["process_shard"] == (2, rank, 2) and r["process_shard_3"] == "ValueError"
        assert "without a mesh" in r["no_mesh"]
        assert r["jax_imported"] == []


@pytest.mark.parametrize("run", ["fp32", "accum"])
def test_shader_step_fp32_allreduce_matches_jax_sharded(ranks, run):
    """Two steps at batch 4 (2 per rank; with grad_accum_steps=2 two
    microbatches of 1 per rank), the fp32 all-reduce, against JAX's step on
    the batch sharded over 2 devices: the loss of each step to 1e-5
    relative, the params as tests/test_torch_train.py's
    _assert_params_close."""
    _, jax_runs, get = ranks
    got, want = get()[0][run], jax_runs[run]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert want["losses"][1] != want["losses"][0]
    _assert_params_close(got["params"][-1], want["params"][-1], SHADER_BASE["e_eta"])


def test_shader_step_bf16_allreduce(ranks):
    """The bf16 all-reduce against JAX's bf16 path (shard_map; preact_policy
    off, see PLAIN_ARCH) and against the port's fp32 all-reduce, as
    tests/test_train.py's: the first step's loss (fp32 on every path) to
    1e-5 relative, and the params after it within 2 lr (Adam's first step
    is +-lr, so a sign flipped by bf16 rounding moves a value by at most
    2 lr)."""
    _, jax_runs, get = ranks
    got = get()[0]
    lr = SHADER_BASE["e_eta"]
    for have, want in ((got["bf16_plain"], jax_runs["bf16_plain"]), (got["bf16"], got["fp32"])):
        assert have["losses"][0] == pytest.approx(want["losses"][0], rel=1e-5)
        dev = _max_dev(have["params"][0], want["params"][0])
        assert dev[0] <= 2 * lr, dev
    # the bf16 rounding did move some value
    assert _max_dev(got["bf16"]["params"][0], got["fp32"]["params"][0])[0] > 0


def test_texture_step_matches_jax_sharded(ranks):
    """The texture step at batch 2 (1 per rank), fp32 all-reduce, against
    JAX's texture step sharded over 2 devices (tests/test_train.py's
    sharded texture test, here with the port): losses to 1e-5, params as
    _assert_params_close (decoder and both heads)."""
    _, jax_runs, get = ranks
    got, want = get()[0]["texture"], jax_runs["texture"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _assert_params_close(got["params"][-1], want["params"][-1], TEX_BASE["e_eta"])


def test_ranks_stay_bit_equal_and_replicate(ranks):
    """After every step of every run the two ranks' params are bit-equal
    (one all-reduced gradient, one update); replicate makes a perturbed
    rank 1 (params, optimizer state, step) equal to rank 0."""
    _, _, get = ranks
    r0, r1 = get()
    for run in (*SHADER_RUNS, "texture"):
        for p0, p1 in zip(r0[run]["params"], r1[run]["params"]):
            assert all(np.array_equal(p0[k], p1[k]) for k in p0), run
    a, b = r0["replicated"], r1["replicated"]
    assert a["step"] == b["step"] == STEPS
    assert all(np.array_equal(a["params"][k], b["params"][k]) for k in a["params"])
    assert len(a["opt"]) == len(b["opt"]) and all(torch.equal(x, y)
                                                  for x, y in zip(a["opt"], b["opt"]))


def test_dropout_masks_differ_across_ranks_crops_agree(ranks):
    """keep_prob 0.5 with the same rows on both ranks: every dropout mask
    differs between the ranks (the rank is folded into the dropout seed),
    while the crop offsets (patch 16) are the same (the shared step seed)."""
    _, _, get = ranks
    d0, d1 = (r["dropout"] for r in get())
    assert len(d0["masks"]) == len(d1["masks"]) > 0
    for m0, m1 in zip(d0["masks"], d1["masks"]):
        assert m0.shape == m1.shape and not torch.equal(m0, m1)
        assert 0.4 < m0.float().mean() < 0.6
    assert d0["offsets"] == d1["offsets"] and len(d0["offsets"]) == 1


def test_loop_at_world_2_matches_one_process(ranks, tmp_path):
    """train_shader over two ranks (global batch 2, one image per rank, the
    loss logged and a sample dumped at every step, the validation L1 summed
    per rank and all-reduced): rank 0 alone writes its run dir (rank 1's
    was never made); the metrics match the one-process loop's at the same
    global batch (losses and the validation L1 to 1e-5) and so do the params
    (_assert_params_close)."""
    from rendernet_tpu_torch.train.loop import train_shader

    inputs, _, get = ranks
    r0, r1 = get()
    tmp = inputs["tmp"]
    single = dict(inputs["loop_cfg"], sample_save=str(tmp_path / "single"))
    state = train_shader(tconfig.TrainConfig(**single), tshader.ShaderConfig(**LOOP_ARCH),
                         device="cpu")
    assert r0["loop"]["step"] == r1["loop"]["step"] == state.step == 2
    assert not (tmp / "loop1").exists()
    assert sorted(os.listdir(tmp / "loop0")) == sorted(os.listdir(tmp_path / "single"))
    metrics = [[json.loads(line) for line in open(d / "metrics.jsonl")]
               for d in (tmp / "loop0", tmp_path / "single")]
    assert metrics[0][0] == {"event": "mesh", "layout": "hybrid", "devices": 2, "processes": 2}
    got, want = metrics[0][1:], metrics[1]
    assert [sorted(m) for m in got] == [sorted(m) for m in want]
    for g, w in zip(got, want):
        for k in ("loss", "valid_l1"):
            if k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-5), k
    _assert_params_close(r0["loop"]["params"], jax_params_from_module(state.params),
                         inputs["loop_cfg"]["e_eta"])


def test_cli_two_processes_on_the_cpu(ranks, tmp_path):
    """train-shader as two processes with --coordinator (a file store)
    --num-processes 2 --process-id i --device cpu, one step each: both exit
    0, and rank 0 alone writes (its run dir holds the checkpoint; rank 1's
    run dir, named in its own config, is never made)."""
    inputs, _, _ = ranks
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    procs = []
    for rank in (0, 1):
        cfg = tmp_path / f"c{rank}.json"
        cfg.write_text(json.dumps(dict(inputs["loop_cfg"], image_path_valid="",
                                       sample_save=str(tmp_path / f"run{rank}"))))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "rendernet_tpu_torch.cli", "train-shader", str(cfg),
             "--max-steps", "1", "--device", "cpu", "--coordinator",
             f"file://{tmp_path}/init", "--num-processes", "2", "--process-id", str(rank)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert os.path.exists(tmp_path / "run0" / "3d2d_renderer")
    assert not (tmp_path / "run1").exists()


def test_graft_entry_dryrun_two_ranks(monkeypatch):
    """graft_entry.dryrun_multichip(2) on the CPU (a cut model, one thread
    per rank): one step over two spawned ranks, a finite loss; two ranks
    take no dp + spatial phase (tests/test_torch_spatial.py runs four), but
    phases 3 and 4 (a data-parallel texture step, a recon scan with one
    hypothesis per rank) run at any count, as JAX's do."""
    from rendernet_tpu_torch import graft_entry

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # read by each spawned rank's torch

    res = graft_entry.dryrun_multichip(2, device="cpu",
                                       model_cfg=tshader.ShaderConfig(**LOOP_ARCH))
    assert set(res) == {"loss", "texture_loss", "recon_losses"}
    assert np.isfinite(res["loss"]) and res["loss"] > 0
    assert np.isfinite(res["texture_loss"]) and np.asarray(res["recon_losses"]).shape == (2, 2)
