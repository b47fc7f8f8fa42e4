"""Pieces of the port's shader training slice against the JAX package on
the CPU: the crops, the crop-fused resamples, the optimizer against optax,
dropout and the training config. The step and the network's gradients are
in ``tests/test_torch_train.py``.
"""
from __future__ import annotations

import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rendernet_tpu.ops import crops as jcrops
from rendernet_tpu.ops import pallas_resample
from rendernet_tpu.ops import resample as jresample
from rendernet_tpu.train import config as jconfig
from rendernet_tpu.train import optim as joptim
from rendernet_tpu_torch.models import shader as tshader
from rendernet_tpu_torch.nn import layers as tl
from rendernet_tpu_torch.ops import crops as tcrops
from rendernet_tpu_torch.ops import cuda_resample
from rendernet_tpu_torch.ops import resample as tresample
from rendernet_tpu_torch.train import config as tconfig
from rendernet_tpu_torch.train import optim as toptim

torch.set_num_threads(2)

ARCH = dict(new_size=32, res1_blocks=2, res2_blocks=2, res3_blocks=1, base=16,
            preact_policy=True)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _voxels_poses(b, seed, vox_size=16):
    rng = np.random.default_rng(seed)
    vox = (rng.random((b, vox_size, vox_size, vox_size, 1)) > 0.6).astype(np.float32)
    poses = np.stack([rng.uniform(0, 2 * math.pi, b), rng.uniform(-1.2, 1.2, b),
                      rng.uniform(0.9, 1.1, b)], axis=1).astype(np.float32)
    return vox, poses


# ---------------------------------------------------------------------------
# crops and the crop-fused resamples
# ---------------------------------------------------------------------------
def test_crops_match_jax():
    rng = np.random.default_rng(5)
    vox = rng.random((2, 12, 12, 6, 1)).astype(np.float32)
    img = rng.random((2, 48, 48, 3)).astype(np.float32)
    for off in ((0, 0), (3, 2), (4, 4)):  # crop starts in [0, 12 - 8]
        np.testing.assert_array_equal(
            tcrops.crop_voxel(torch.from_numpy(vox), off, 8).numpy(),
            np.asarray(jcrops.crop_voxel(jnp.asarray(vox), jnp.asarray(off), 8)))
        np.testing.assert_array_equal(
            tcrops.crop_image(torch.from_numpy(img), off, 8, 4).numpy(),
            np.asarray(jcrops.crop_image(jnp.asarray(img), jnp.asarray(off), 8, 4)))


def test_exact_patch_resample_matches_jax():
    """rotate_resample_camera_patch: equal to JAX's and to the crop of the
    full exact resample, fp32, 1e-5 (the same gathers and weights)."""
    vox, poses = _voxels_poses(3, seed=6)
    for off in ((0, 0), (5, 11), (16, 16)):
        want = jresample.rotate_resample_camera_patch(
            jnp.asarray(vox), jnp.asarray(poses), jnp.asarray(off), 16, new_size=32)
        got = tresample.rotate_resample_camera_patch(
            torch.from_numpy(vox), torch.from_numpy(poses), off, 16, new_size=32)
        full = tresample.rotate_resample_to_camera(torch.from_numpy(vox),
                                                   torch.from_numpy(poses), new_size=32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.numpy(), full[:, off[0]:off[0] + 16,
                                                     off[1]:off[1] + 16].numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multipass_patch_resample_matches_jax(dtype):
    """rotate_resample_camera_patch_multipass vs JAX's (Pallas K1 in
    interpret mode), and vs the crop of the port's full multipass resample;
    K1 runs 8 passes, the last pass of each cropped axis emitting only the
    window. fp32: 1e-5. bf16: each pass rounds to bf16 in both, and a
    one-ulp difference can carry through later passes: 2^-6 of max."""
    vox, poses = _voxels_poses(2, seed=7)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    shapes = []
    orig = cuda_resample.apply_interp_pass

    def rec(vol, params, db, out_lanes=None):
        shapes.append((tuple(vol.shape), out_lanes))
        return orig(vol, params, db, out_lanes)

    cuda_resample.apply_interp_pass = rec
    try:
        for off in ((5, 11), (16, 0)):
            shapes.clear()
            want = pallas_resample.rotate_resample_camera_patch_multipass(
                jnp.asarray(vox), jnp.asarray(poses), jnp.asarray(off), 16, new_size=32,
                compute_dtype=jdt)
            got = cuda_resample.rotate_resample_camera_patch_multipass(
                torch.from_numpy(vox), torch.from_numpy(poses), off, 16, new_size=32,
                compute_dtype=tdt)
            assert len(shapes) == 8 and sum(o is not None for _, o in shapes) == 2
            full = cuda_resample.rotate_resample_to_camera_multipass(
                torch.from_numpy(vox), torch.from_numpy(poses), new_size=32, compute_dtype=tdt)
            assert got.dtype == tdt and tuple(got.shape) == (2, 16, 16, 32, 1)
            w = np.asarray(want.astype(jnp.float32))
            assert np.abs(got.float().numpy() - w).max() <= tol * np.abs(w).max()
            crop = full[:, off[0]:off[0] + 16, off[1]:off[1] + 16].float().numpy()
            assert np.abs(got.float().numpy() - crop).max() <= tol * np.abs(crop).max()
    finally:
        cuda_resample.apply_interp_pass = orig


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("moment_dtype,skip", [("float32", 0), ("bfloat16", 0),
                                               ("float32", 1), ("bfloat16", 1)])
def test_optimizer_matches_optax(moment_dtype, skip):
    """make_optimizer vs the JAX package's (optax Adam with the staircase
    schedule, b1 = 0.5; bf16 moments; reject_nonfinite) over six steps of
    random gradients, one of them non-finite when ``skip`` (rejected: zero
    update, state kept, counters 1 then 0). The decay step is 2 so the
    schedule steps twice. Updates agree to 1e-6 relative (fp32 arithmetic
    in the same order; the bias corrections' powers may differ by an ulp);
    with bf16 moments to 1e-2 relative (a bf16 rounding of the stored
    moments can land on either side)."""
    rng = np.random.default_rng(8)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jtx = joptim.make_optimizer(1e-3, 2, 0.5, skip_nonfinite=skip, moment_dtype=moment_dtype)
    ttx = toptim.make_optimizer(1e-3, 2, 0.5, skip_nonfinite=skip, moment_dtype=moment_dtype)
    jstate = jtx.init({k: jnp.asarray(v) for k, v in params.items()})
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = ttx.init(tparams)
    tol = 1e-6 if moment_dtype == "float32" else 1e-2
    for i in range(6):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        if skip and i == 3:
            g["a"][1, 2] = np.inf
        ju, jstate = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate)
        tu, tstate = ttx.update({k: torch.from_numpy(v) for k, v in g.items()}, tstate,
                                tparams)
        for k in shapes:
            if skip and i == 3:
                assert not np.asarray(ju[k]).any() and not tu[k].numpy().any()
            else:
                assert _rel_err(tu[k].numpy(), ju[k]) <= tol, (i, k)
        if skip:
            assert int(tstate.notfinite_count) == int(jstate.notfinite_count)
            assert int(tstate.total_notfinite) == int(jstate.total_notfinite)
        toptim.apply_updates(tparams, tu)


def test_staircase_schedule_matches_optax():
    sched = toptim.exponential_staircase(1e-3, 3, 0.96)
    want = optax.exponential_decay(1e-3, 3, 0.96, staircase=True)
    for s in range(10):
        assert abs(sched(s) - float(want(s))) <= 1e-9
        assert abs(float(sched(torch.tensor(s, dtype=torch.int32))) - float(want(s))) <= 1e-9


# ---------------------------------------------------------------------------
# dropout, config
# ---------------------------------------------------------------------------
def test_dropout():
    """Identity at eval and at keep_prob = 1; in train mode a kept value is
    scaled by 1 / keep_prob and the dropped share is near 1 - keep_prob
    (4 standard deviations of a binomial over 40000 draws); the same
    generator seed draws the same mask."""
    x = torch.full((200, 200), 2.0)
    g = torch.Generator().manual_seed(0)
    assert tl.dropout(x, 0.7, g, train=False) is x
    assert tl.dropout(x, 1.0, g) is x
    y = tl.dropout(x, 0.7, torch.Generator().manual_seed(1))
    kept = y != 0
    assert torch.allclose(y[kept], torch.tensor(2.0 / 0.7))
    share = 1.0 - kept.float().mean().item()
    assert abs(share - 0.3) <= 4 * math.sqrt(0.3 * 0.7 / x.numel())
    assert torch.equal(tl.dropout(x, 0.7, torch.Generator().manual_seed(1)), y)
    with pytest.raises(ValueError, match="generator"):
        tl.dropout(x, 0.7, None)
    net = tshader.init_shader_params(0, tshader.ShaderConfig(**{**ARCH, "keep_prob": 0.5}),
                                     device="cpu")
    vox = torch.rand(1, 8, 8, 32, 1)
    with torch.no_grad():
        a = net(vox)
        b = net(vox, train=True, generator=torch.Generator().manual_seed(0))
        c = net(vox, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(b, c) and not torch.equal(a, b)


def test_train_config_matches_jax(tmp_path):
    """The port's TrainConfig copy reads a reference-style JSON (string
    booleans, unknown keys) into the same fields and values as JAX's, and
    validates the same way."""
    raw = {"image_path": "/data/img", "is_greyscale": "False", "batch_size": 24,
           "e_eta": 2e-5, "keep_prob": 0.8, "moment_dtype": "bfloat16",
           "unknown_key": 3, "img_res": 512}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(raw))
    j = jconfig.TrainConfig.from_json(str(path))
    t = tconfig.TrainConfig.from_json(str(path))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.image_channels == 3 and t.patch_size_for_epoch(0) == 32
    for bad in ({"img_res": 256}, {"keep_prob": 0.0}, {"moment_dtype": "float16"}):
        with pytest.raises(ValueError):
            tconfig.TrainConfig.from_dict(bad)
