"""Frozen artifacts, GraphDef import and the conversion / render CLIs of
the port, against JAX's, on the CPU.

``compat/frozen.py`` (``torch.export``) at the reduced ``ShaderConfig`` of
``tests/test_frozen.py``: the artifact, loaded in a fresh process that
imports no model code, equals the live forward and JAX's frozen artifact
on the same weights. ``compat/pb_import.py`` on a GraphDef that TensorFlow
writes here. ``cli/convert.py``'s five subcommands and the render CLI's
``--frozen`` and reference-directory ``--weights``, run end to end on a
small net. fp32 throughout; the frozen program runs the same aten ops as
the live forward (equal to 1e-6), and JAX's exact path sums its convs in
other orders (2e-5 of a sigmoid output in [0, 1]).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.compat import frozen as jfrozen
from rendernet_tpu.compat import pb_import as jpb
from rendernet_tpu.models import shader as jshader
from rendernet_tpu_torch.cli import convert, demo
from rendernet_tpu_torch.compat import frozen as tfrozen
from rendernet_tpu_torch.compat import pb_import as tpb
from rendernet_tpu_torch.compat.jax_params import jax_params_from_module, load_params_npz
from rendernet_tpu_torch.io.binvox import save_binvox
from rendernet_tpu_torch.models import shader as tshader

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
# tests/test_frozen.py's reduced shader
SMALL = dict(out_channels=1, enc_channels=(2, 2, 4), res1_blocks=1, res2_blocks=1,
             res3_blocks=1, base=2, new_size=16)


def _draws(init, seed):
    """Numpy draws on JAX's key set and shapes (``jax.eval_shape`` of the
    init, so no JAX init runs): weights N(0, 0.3^2), alphas and biases
    uniform in [0.05, 0.3)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return {k: (rng.uniform(0.05, 0.3, v.shape) if k.endswith(("alpha", "biases"))
                else rng.standard_normal(v.shape) * 0.3).astype(np.float32)
            for k, v in sorted(shapes.items())}


def _jax_params(seed=0):
    return _draws(lambda k: jshader.init_shader_params(k, jshader.ShaderConfig(**SMALL)), seed)


def _inputs(voxel_size=8, seed=1):
    rng = np.random.default_rng(seed)
    vox = (rng.random((1, voxel_size, voxel_size, voxel_size, 1)) > 0.6).astype(np.float32)
    return vox, np.array([[1.2, 0.4, 1.0]], np.float32)


_LOAD = r"""
import json, sys, numpy as np, torch
from rendernet_tpu_torch.compat.frozen import load_frozen
mod = load_frozen(sys.argv[1], device="cpu")
vox, pose = (torch.from_numpy(np.load(sys.argv[2])[k]) for k in ("vox", "pose"))
with torch.no_grad():
    np.save(sys.argv[3], mod(vox, pose).numpy())
print(json.dumps({"models": sorted(m for m in sys.modules
                                   if m.startswith("rendernet_tpu_torch.models")),
                  "in_shapes": mod.in_shapes, "platforms": mod.platforms}))
"""


def test_freeze_load_matches_live_and_jax(tmp_path):
    """freeze_shader_render -> save_frozen -> load_frozen in a fresh process
    without model code: the output equals the live exact forward and JAX's
    frozen artifact on the same weights."""
    params = _jax_params()
    vox, pose = _inputs()
    cfg = tshader.ShaderConfig(**SMALL)
    fz = tfrozen.freeze_shader_render(params, cfg, batch=1, voxel_size=8, platforms=("cpu",),
                                      device="cpu")
    assert fz.platforms == ("cpu",) and fz.in_shapes == [(1, 8, 8, 8, 1), (1, 3)]
    path = str(tmp_path / "shader.pt2")
    tfrozen.save_frozen(fz, path)
    np.savez(tmp_path / "in.npz", vox=vox, pose=pose)
    out = subprocess.run([sys.executable, "-c", _LOAD, path, str(tmp_path / "in.npz"),
                          str(tmp_path / "out.npy")], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), check=True, timeout=300)
    info = json.loads(out.stdout.strip().splitlines()[-1])
    assert info["models"] == [] and info["in_shapes"] == [[1, 8, 8, 8, 1], [1, 3]]
    got = np.load(tmp_path / "out.npy")

    net = tshader.init_shader_params(0, cfg, device="cpu")
    from rendernet_tpu_torch.compat.jax_params import load_jax_params

    load_jax_params(net, params)
    with torch.no_grad():
        live = tshader.shader_forward(net, torch.from_numpy(vox), torch.from_numpy(pose)).numpy()
    assert got.shape == (1, 64, 64, 1)
    np.testing.assert_allclose(got, live, atol=1e-6, rtol=0)

    jexp = jfrozen.freeze_shader_render({k: jnp.asarray(v) for k, v in params.items()},
                                        jshader.ShaderConfig(**SMALL), batch=1, voxel_size=8,
                                        platforms=("cpu",))
    want = np.asarray(jexp.call(jnp.asarray(vox), jnp.asarray(pose)))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_frozen_platforms_and_flags(tmp_path):
    """"tpu" is refused; a device the artifact was not checked on is
    refused at load; the kernel flags come back after the trace, also when
    it raises."""
    from rendernet_tpu_torch.nn import layers

    with pytest.raises(ValueError, match="TPU"):
        tfrozen.freeze_fn(lambda x: x * 2, (torch.ones(2),), platforms=("cpu", "tpu"))
    fz = tfrozen.freeze_fn(torch.nn.Linear(3, 2), (torch.ones(4, 3),), platforms=("cpu",))
    path = str(tmp_path / "lin.pt2")
    tfrozen.save_frozen(fz, path)
    mod = tfrozen.load_frozen(path, device="cpu")
    assert tuple(mod(torch.ones(4, 3)).shape) == (4, 2)
    with pytest.raises((ValueError, RuntimeError)):
        tfrozen.load_frozen(path, device="cuda")
    before = {n: getattr(layers, n) for n in ("CUDA_CONV3D", "WINOGRAD_2D", "PHASE_CONV3D")}

    def boom(x):
        assert layers.CUDA_CONV3D is False and layers.PHASE_CONV3D is False
        raise RuntimeError("trace fails")

    with pytest.raises(Exception):
        tfrozen.freeze_fn(boom, (torch.ones(2),), platforms=("cpu",))
    assert {n: getattr(layers, n) for n in before} == before


def _write_pb(path, consts):
    import tensorflow as tf

    g = tf.Graph()
    with g.as_default():
        for name, value in consts.items():
            tf.constant(value, name=name)
        tf.constant(np.int32(7), name="some/shape/metadata")
    with open(path, "wb") as f:
        f.write(g.as_graph_def().SerializeToString())


def test_pb_to_npz_matches_jax(tmp_path):
    """A GraphDef of the shape decoder's weights (TF writes it here, consts
    named by scope path): `convert pb-to-npz --model shape-decoder` writes
    the dict JAX's params_from_frozen_pb reads from it; a pb short of a
    weight raises unless --allow-missing, a misshapen one always. The
    import goes through `npz-to-refdir` and `refdir-to-npz` unchanged."""
    from rendernet_tpu.models import decoders as jdec

    jtemplate = _draws(jdec.init_shape_decoder_params, 3)
    consts = _draws(jdec.init_shape_decoder_params, 4)
    pb = str(tmp_path / "frozen.pb")
    _write_pb(pb, consts)
    out = str(tmp_path / "out.npz")
    assert convert.main(["pb-to-npz", pb, out, "--model", "shape-decoder"]) == 0
    got = load_params_npz(out)
    want = jpb.params_from_frozen_pb(jtemplate, pb)
    assert sorted(got) == sorted(want) == sorted(consts)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])

    refdir = str(tmp_path / "ref")  # and through a reference weight directory
    assert convert.main(["npz-to-refdir", out, refdir]) == 0
    assert convert.main(["refdir-to-npz", refdir, out, "--model", "shape-decoder"]) == 0
    got = load_params_npz(out)
    for k in consts:
        np.testing.assert_array_equal(got[k], consts[k])

    short = dict(consts)
    short.pop("g_conv5/weights")
    _write_pb(pb, short)
    with pytest.raises(KeyError):
        convert.main(["pb-to-npz", pb, out, "--model", "shape-decoder"])
    assert convert.main(["pb-to-npz", pb, out, "--model", "shape-decoder",
                         "--allow-missing"]) == 0
    bad = {"a/weights": np.zeros((2, 2), np.float32)}
    _write_pb(pb, bad)
    with pytest.raises(ValueError):
        tpb.params_from_frozen_pb({"a/weights": np.zeros((3, 2), np.float32)}, pb)


def test_convert_parsers_take_jax_arguments():
    """The five subcommands parse JAX's arguments; the templates cover
    JAX's five --model names; render parses --frozen."""
    p = convert.build_parser()
    assert p.parse_args(["ckpt-to-npz", "c", "o"]).cmd == "ckpt-to-npz"
    assert p.parse_args(["npz-to-refdir", "a.npz", "d"]).out_dir == "d"
    assert p.parse_args(["refdir-to-npz", "d", "o", "--model", "recon-texture"]).model == \
        "recon-texture"
    a = p.parse_args(["pb-to-npz", "f.pb", "o", "--out_channels", "1", "--allow-missing"])
    assert (a.out_channels, a.allow_missing, a.model) == (1, True, "shader")
    a = p.parse_args(["freeze", "w.npz", "o.pt2", "--batch", "2", "--platforms", "cpu",
                      "--voxel_size", "32", "--device", "cpu"])
    assert (a.batch, a.platforms, a.voxel_size, a.device) == (2, "cpu", 32, "cpu")
    for model in convert.MODELS:
        with pytest.raises(SystemExit):
            p.parse_args(["refdir-to-npz", "d", "o", "--model", model + "x"])
    a = demo.build_parser().parse_args(["--voxel_path", "v", "--frozen", "f.pt2"])
    assert a.frozen == "f.pt2"
    from rendernet_tpu_torch.cli.__main__ import COMMANDS

    assert COMMANDS["convert"] == "rendernet_tpu_torch.cli.convert"


def test_ckpt_to_npz_reads_the_port_checkpoint(tmp_path):
    """ckpt-to-npz: the checkpoint's network in JAX's keys and layouts, or
    the params_latest.npz beside it when there is one."""
    from rendernet_tpu_torch.train.checkpoint import save_checkpoint, save_params_npz
    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.train.steps import create_shader_state

    state, _ = create_shader_state(0, tshader.ShaderConfig(**SMALL),
                                   TrainConfig(new_size=16), device="cpu")
    ckpt = str(tmp_path / "run" / "model.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    save_checkpoint(ckpt, state)
    out = str(tmp_path / "p.npz")
    assert convert.main(["ckpt-to-npz", ckpt, out]) == 0
    want = jax_params_from_module(state.params)
    got = load_params_npz(out)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    sibling = {k: v + 1.0 for k, v in want.items()}
    save_params_npz(str(tmp_path / "run" / "params_latest.npz"), sibling)
    assert convert.main(["ckpt-to-npz", ckpt, out]) == 0
    np.testing.assert_array_equal(load_params_npz(out)["encoder/e_conv1/e_conv1/weights"],
                                  sibling["encoder/e_conv1/e_conv1/weights"])


def test_render_frozen_and_weight_dir_match_npz_render(tmp_path):
    """The render CLI on the CPU, one 64^3 voxel: with a flat .npz
    (--arch), with the reference directory `convert npz-to-refdir` writes
    from it, and with the artifact freeze_shader_render writes from the
    same weights: the same image, byte for byte."""
    from rendernet_tpu_torch.train.checkpoint import save_params_npz
    from rendernet_tpu_torch.utils.image import decode_image

    params = _jax_params(seed=2)
    npz = str(tmp_path / "p.npz")
    save_params_npz(npz, params)
    refdir = str(tmp_path / "ref")
    assert convert.main(["npz-to-refdir", npz, refdir]) == 0
    vox = np.zeros((64, 64, 64), bool)
    vox[16:48, 20:44, 24:40] = True
    vpath = str(tmp_path / "box.binvox")
    save_binvox(vox, vpath)
    fz = tfrozen.freeze_shader_render(params, tshader.ShaderConfig(**SMALL), batch=1,
                                      voxel_size=64, platforms=("cpu",), device="cpu")
    art = str(tmp_path / "shader.pt2")
    tfrozen.save_frozen(fz, art)
    arch = json.dumps({k: v for k, v in SMALL.items() if k != "out_channels"})
    images = {}
    for tag, extra in (("npz", ["--weights", npz, "--arch", arch]),
                       ("refdir", ["--weights", refdir, "--arch", arch]),
                       ("frozen", ["--frozen", art])):
        rdir = str(tmp_path / tag)
        assert demo.main(["--voxel_path", vpath, "--render_dir", rdir, "--device", "cpu",
                          "--out_channels", "1", *extra]) == 0
        (name,) = os.listdir(rdir)
        with open(os.path.join(rdir, name), "rb") as f:
            images[tag] = decode_image(f.read())
    assert images["npz"].std() > 0
    np.testing.assert_array_equal(images["refdir"], images["npz"])
    np.testing.assert_array_equal(images["frozen"], images["npz"])
