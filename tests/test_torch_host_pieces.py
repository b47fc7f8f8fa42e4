"""The port's small host-side pieces against the JAX package on the CPU:
pose names, prefetch, TensorBoard events, checkpoints and params npz
archives that cross between the packages.
"""
from __future__ import annotations

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from rendernet_tpu.data import pose as jpose
from rendernet_tpu.models import shader as jshader
from rendernet_tpu.train import checkpoint as jckpt
from rendernet_tpu.utils import tb as jtb
from rendernet_tpu_torch.compat.jax_params import jax_params_from_module, load_jax_params
from rendernet_tpu_torch.data import pose as tpose
from rendernet_tpu_torch.data.prefetch import prefetch
from rendernet_tpu_torch.models import shader as tshader
from rendernet_tpu_torch.train import checkpoint as tckpt
from rendernet_tpu_torch.train import config as tconfig
from rendernet_tpu_torch.train import steps as tsteps
from rendernet_tpu_torch.utils import tb as ttb

torch.set_num_threads(2)

ARCH = dict(new_size=32, res1_blocks=1, res2_blocks=1, res3_blocks=1, base=8)


@pytest.mark.parametrize("name", ["model_normalized_3_clean_p30_t60_r3.3",
                                  "ply80001_p250.5_t100_r2.5", "x_p0_t90_r4.0_extra"])
def test_pose_from_name_matches_jax(name):
    """(azimuth, elevation, scale) parsed alike, float32, bit for bit."""
    got, want = tpose.pose_from_name(name), jpose.pose_from_name(name)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_pose_names_round_trip_and_batch_params():
    suffix = tpose.pose_to_name_suffix(120, 75, 3.3)
    assert suffix == jpose.pose_to_name_suffix(120, 75, 3.3) == "_p120_t75_r3.3"
    np.testing.assert_array_equal(tpose.pose_from_name("m" + suffix),
                                  jpose.pose_from_name("m" + suffix))
    with pytest.raises(ValueError):
        tpose.pose_to_name_suffix(0, 90, 10.0)
    names = ["a_b_c_d_2_3_e", "a_b_c_d_7_1"]
    np.testing.assert_array_equal(tpose.name_to_param(names), jpose.name_to_param(names))


def test_prefetch_order_depth_zero_and_early_break():
    """Items arrive in order at every depth; depth 0 is the iterator itself;
    after an early break and close() the producer stops."""
    assert list(prefetch(range(50), 3)) == list(range(50))
    it = iter([1, 2])
    assert prefetch(it, 0) is it
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    p = prefetch(gen(), 2)
    for i in p:
        if i == 3:
            break
    p.close()
    time.sleep(0.5)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n < 20


def test_prefetch_reraises_the_producers_exception():
    def bad():
        yield 1
        raise KeyError("boom")

    p = prefetch(bad(), 2)
    assert next(p) == 1
    with pytest.raises(KeyError, match="boom"):
        next(p)
    with pytest.raises(StopIteration):
        next(p)
    assert threading.active_count() < 50


def test_tb_events_match_jax_bytes(tmp_path, monkeypatch):
    """At a fixed wall time and host name both writers produce the same file
    name and the same bytes (Event protos framed with masked CRC32C)."""
    for mod in (ttb, jtb):
        monkeypatch.setattr(mod.time, "time", lambda: 1700000000.25)
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
    paths = []
    for mod, d in ((ttb, "t"), (jtb, "j")):
        with mod.TBWriter(str(tmp_path / d)) as w:
            w.scalar("loss", 0.125, 3)
            w.scalar("valid_l1", 1.5e-3, 600)
        paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        a, b = f.read(), g.read()
    assert a == b and len(a) > 60
    assert ttb._crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def _state(seed=0, **kw):
    cfg = tconfig.TrainConfig(batch_size=2, img_res=128, new_size=32, compute_dtype="float32",
                              **kw)
    mcfg = tshader.ShaderConfig(**ARCH)
    state, tx = tsteps.create_shader_state(seed, mcfg, cfg, device="cpu")
    return state, tx, tsteps.make_shader_train_step(mcfg, cfg, tx, 32)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    vox = (rng.random((2, 16, 16, 16, 1)) > 0.6).astype(np.float32)
    img = rng.random((2, 128, 128, 1)).astype(np.float32)
    pose = np.stack([rng.uniform(0, 6, 2), rng.uniform(-1, 1, 2), np.ones(2)], 1)
    return [torch.from_numpy(a.astype(np.float32)) for a in (vox, img, pose)]


@pytest.mark.parametrize("skip", [0, 3])
def test_checkpoint_round_trip_and_resume(tmp_path, skip):
    """save_checkpoint / restore_checkpoint carry the network, the whole
    optimizer state (moments, counts, the non-finite counters) and the step:
    two steps, a save, a restore into a fresh state, and one more step give
    the same parameters as three uninterrupted steps. A state of another
    structure refuses the checkpoint."""
    state, _, step = _state(skip_nonfinite_updates=skip)
    batch = _batch()
    for _ in range(2):
        state, _ = step(state, *batch, 5)
    path = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(path, state)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    fresh, _, step2 = _state(seed=9, skip_nonfinite_updates=skip)
    restored = tckpt.restore_checkpoint(path, fresh)
    assert restored.step == 2
    state, _ = step(state, *batch, 5)
    restored, _ = step2(restored, *batch, 5)
    for (n, a), b in zip(state.params.named_parameters(), restored.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    other, _, _ = _state(skip_nonfinite_updates=3 - skip)
    with pytest.raises(ValueError, match="structure"):
        tckpt.restore_checkpoint(path, other)
    raw = tckpt.restore_checkpoint(path)
    assert raw["step"] == 2 and set(raw) >= {"params", "opt_leaves", "opt_structure"}


def test_params_npz_crosses_between_the_packages(tmp_path):
    """A params npz written by the port loads in JAX's load_params_npz with
    JAX's keys and layouts, and one JAX writes loads into the port's
    network, array for array."""
    net = tshader.init_shader_params(3, tshader.ShaderConfig(**ARCH), device="cpu")
    path = str(tmp_path / "port.npz")
    tckpt.save_params_npz(path, net)
    back = jckpt.load_params_npz(path)
    want = jax.eval_shape(lambda k: jshader.init_shader_params(
        k, jshader.ShaderConfig(**ARCH)), jax.random.PRNGKey(0))
    assert set(back) == set(want)
    assert all(back[k].shape == want[k].shape for k in want)
    flat = jax_params_from_module(net)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])

    rng = np.random.default_rng(1)
    jparams = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in want.items()}
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_params_npz(jpath, jparams)
    net2 = load_jax_params(tshader.init_shader_params(0, tshader.ShaderConfig(**ARCH),
                                                      device="cpu"),
                           tckpt.load_params_npz(jpath))
    got = jax_params_from_module(net2)
    for k in jparams:
        np.testing.assert_array_equal(got[k], jparams[k])
