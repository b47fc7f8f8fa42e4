"""The port's training loops and CLIs on the CPU: a few steps of
``train_shader`` and ``train_texture`` on synthetic datasets, their run
dirs against what JAX's loops write for the same config, crash-resume, and
the ``train-shader`` / ``train-texture`` / ``pack-tar`` commands.

Datasets are made in ``tmp_path`` by the port from a procedural voxel grid;
models are cut to new_size 32 with one block per stack.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rendernet_tpu_torch.data.synthetic import make_synthetic_shader_tar, synthetic_face_dataset
from rendernet_tpu_torch.io.binvox import save_binvox
from rendernet_tpu_torch.models.shader import ShaderConfig
from rendernet_tpu_torch.models.texture_face import TextureFaceConfig
from rendernet_tpu_torch.train.config import TrainConfig
from rendernet_tpu_torch.train.loop import train_shader, train_texture
from test_torch_texture import sphere_box

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SHADER_ARCH = dict(new_size=32, res1_blocks=1, res2_blocks=1, res3_blocks=1, base=8)
TEXTURE_ARCH = dict(SHADER_ARCH, tex_base=8)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("loopdata")
    paths = []
    for i, g in enumerate((sphere_box(64), sphere_box(64)[::-1])):
        paths.append(str(d / f"proc{i}.binvox"))
        save_binvox(np.ascontiguousarray(g), paths[-1])
    shader = make_synthetic_shader_tar(str(d / "shader"), paths, ((30, 60), (120, 75)),
                                       img_res=128, device="cpu")
    face = synthetic_face_dataset(str(d / "face"), paths[:1], ((30, 60), (250, 100)),
                                  img_res=128, device="cpu")
    return {"shader": shader, "face": face}


def _shader_cfg(data, run_dir, **kw):
    tar, mdir = data["shader"]
    base = dict(image_path=tar, model_path=mdir, batch_size=2, img_res=128, new_size=32,
                e_eta=1e-4, compute_dtype="float32", max_epochs=1, sample_save=str(run_dir),
                sample_every_steps=2, resample="exact", image_path_valid=tar)
    base.update(kw)
    return base


def _texture_cfg(data, run_dir, **kw):
    tar, mdir, tdir, ndir = data["face"]
    base = dict(image_path=tar, model_path=mdir, texture_path=tdir, normal_path=ndir,
                batch_size=1, img_res=128, new_size=32, e_eta=1e-4, compute_dtype="float32",
                is_greyscale=False, max_epochs=1, sample_save=str(run_dir),
                sample_every_steps=1, resample="exact")
    base.update(kw)
    return base


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _listing(run_dir):
    """The run dir's names (the TB events file's name carries a time)."""
    return sorted("tb/" if n == "tb" else n for n in os.listdir(run_dir))


def test_shader_loop_run_dir_matches_jax(data, tmp_path):
    """train_shader for one epoch of 2 steps (sample dumps at step 2, the
    validation L1 at the epoch's end, params_final.npz) writes the same file
    names and the same metrics keys, line by line, as JAX's train_shader for
    the same config; the losses agree in kind (finite, positive)."""
    from rendernet_tpu.models.shader import ShaderConfig as JShaderConfig
    from rendernet_tpu.train.config import TrainConfig as JTrainConfig
    from rendernet_tpu.train.loop import train_shader as jtrain_shader

    kw = _shader_cfg(data, tmp_path / "port")
    state = train_shader(TrainConfig(**kw), ShaderConfig(**SHADER_ARCH), device="cpu")
    jkw = _shader_cfg(data, tmp_path / "jax")
    jstate = jtrain_shader(JTrainConfig(**jkw), JShaderConfig(**SHADER_ARCH), use_mesh=False)
    assert state.step == int(jstate.step) == 2
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    assert {"3d2d_renderer", "config.json", "metrics.jsonl", "params_final.npz",
            "tb/"} <= set(_listing(tmp_path / "port"))
    assert any(n.endswith("_2_pred.png") for n in _listing(tmp_path / "port"))
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert [sorted(m) for m in got] == [sorted(m) for m in want]
    assert all(np.isfinite(m["loss"]) and m["loss"] > 0 for m in got if "loss" in m)
    assert "valid_l1" in got[-1]
    with open(tmp_path / "port" / "config.json") as f, open(tmp_path / "jax" / "config.json") as g:
        assert set(json.load(f)) <= set(json.load(g))


def test_shader_loop_resumes_at_step_2(data, tmp_path):
    """A second run in the same dir restores the checkpoint (step 2, the
    parameters and the optimizer state) and stops at max_steps 3. The first
    run also caches one device batch (the cap logs once) and traces step 1
    with the profiler."""
    cfg = TrainConfig(**_shader_cfg(data, tmp_path / "run", image_path_valid="",
                                    batch_size=1, cache_chunks=True, cache_chunks_max_batches=1,
                                    profile_dir=str(tmp_path / "prof"), profile_start_step=1,
                                    profile_steps=1))
    mcfg = ShaderConfig(**SHADER_ARCH)
    s1 = train_shader(cfg, mcfg, max_steps=2, device="cpu")
    saved = {k: v.clone() for k, v in s1.params.state_dict().items()}
    s2 = train_shader(cfg, mcfg, max_steps=3, device="cpu")
    assert s1.step == 2 and s2.step == 3
    metrics = _metrics(tmp_path / "run")
    assert {"resumed_at_step": 2} in metrics
    assert {"event": "cache_chunks_cap", "cached_batches": 1} in metrics
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert any(not torch.equal(saved[k], v) for k, v in s2.params.state_dict().items())


def test_texture_loop_run_dir_matches_jax_and_resumes(data, tmp_path):
    """train_texture for 2 steps (the loss logged at each), against JAX's
    train_texture's file names and metrics keys; then a resumed run to step
    3."""
    from rendernet_tpu.models.texture_face import TextureFaceConfig as JTextureFaceConfig
    from rendernet_tpu.train.config import TrainConfig as JTrainConfig
    from rendernet_tpu.train.loop import train_texture as jtrain_texture

    kw = _texture_cfg(data, tmp_path / "port")
    mcfg = TextureFaceConfig(**TEXTURE_ARCH)
    state = train_texture(TrainConfig(**kw), mcfg, max_steps=2, device="cpu")
    jstate = jtrain_texture(JTrainConfig(**_texture_cfg(data, tmp_path / "jax")),
                            JTextureFaceConfig(**TEXTURE_ARCH), max_steps=2, use_mesh=False)
    assert state.step == int(jstate.step) == 2
    assert _listing(tmp_path / "port") == _listing(tmp_path / "jax")
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert [sorted(m) for m in got] == [sorted(m) for m in want]
    s2 = train_texture(TrainConfig(**kw), mcfg, max_steps=3, device="cpu")
    assert s2.step == 3 and {"resumed_at_step": 2} in _metrics(tmp_path / "port")


def test_loop_refuses_data_parallel(data, tmp_path):
    """data_parallel=2 in one process raises ValueError, saying how to
    launch one process per card, before writing the run dir."""
    with pytest.raises(ValueError, match="one process per card"):
        train_shader(TrainConfig(**_shader_cfg(data, tmp_path / "run", data_parallel=2)),
                     ShaderConfig(**SHADER_ARCH), device="cpu")
    assert not (tmp_path / "run").exists()


def _cli(args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "rendernet_tpu_torch.cli", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=600, **kw)


def test_clis_train_and_pack_on_the_cpu(data, tmp_path):
    """pack-tar packs a directory of the synthetic PNGs; train-shader (full
    width at new_size 32) and train-texture run 1 step each from JSON
    configs with --device cpu and leave a checkpoint."""
    import tarfile

    png_dir = tmp_path / "pngs"
    with tarfile.open(data["shader"][0]) as tf:
        tf.extractall(png_dir, filter="data")
    packed = tmp_path / "packed.tar"
    r = _cli(["pack-tar", "--images_path", str(png_dir), "--save_path", str(packed),
              "--device", "cpu"])
    assert r.returncode == 0, r.stderr
    with tarfile.open(packed) as tf:
        assert sorted(tf.getnames()) == sorted(os.listdir(png_dir)) and len(tf.getnames()) == 4
    for cmd, cfg in (("train-shader", _shader_cfg(data, tmp_path / "s", image_path=str(packed),
                                                  image_path_valid="")),
                     ("train-texture", _texture_cfg(data, tmp_path / "t"))):
        path = tmp_path / f"{cmd}.json"
        path.write_text(json.dumps(cfg))
        r = _cli([cmd, str(path), "--max-steps", "1", "--device", "cpu"])
        assert r.returncode == 0, r.stderr
        assert os.path.exists(os.path.join(cfg["sample_save"], "3d2d_renderer"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the failure with no card")
def test_clis_fail_loudly_without_a_card(data, tmp_path):
    """Without --device cpu on a machine with no card each command exits
    non-zero, naming the way out, and writes no run dir; --num-processes
    without a coordinator fails, naming --coordinator."""
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(_shader_cfg(data, tmp_path / "run")))
    for args in (["train-shader", str(cfg)], ["train-texture", str(cfg)],
                 ["pack-tar", "--images_path", str(tmp_path), "--save_path",
                  str(tmp_path / "x.tar")]):
        r = _cli(args)
        assert r.returncode != 0 and "--device cpu" in r.stderr, args
    assert not (tmp_path / "run").exists() and not (tmp_path / "x.tar").exists()
    r = _cli(["train-shader", str(cfg), "--device", "cpu", "--num-processes", "2"])
    assert r.returncode != 0 and "--coordinator" in r.stderr
    assert "NotImplementedError" not in r.stderr and not (tmp_path / "run").exists()
