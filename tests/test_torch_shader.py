"""The port's serving slice end to end against the JAX package on the CPU:
the shader network with weights carried across, the render CLI, and the
host-side codecs it uses.
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

from rendernet_tpu.io import binvox as jbinvox
from rendernet_tpu.models import shader as jshader
from rendernet_tpu.nn import layers as jl
from rendernet_tpu.train.checkpoint import load_params_npz, save_params_npz
from rendernet_tpu_torch.compat import jax_params
from rendernet_tpu_torch.io import binvox as tbinvox
from rendernet_tpu_torch.models import shader as tshader
from rendernet_tpu_torch.nn import layers as tl
from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd
from rendernet_tpu_torch.utils.image import encode_png

torch.set_num_threads(2)

ASSETS = os.path.join(os.path.dirname(__file__), os.pardir, "assets")


def _sphere_box(n):
    """A sphere plus a box in an n^3 grid (bool [x, y, z])."""
    g = np.arange(n, dtype=np.float32) * (64.0 / n)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sphere = (x - 26) ** 2 + (y - 34) ** 2 + (z - 30) ** 2 <= 14.0 ** 2
    box = (np.abs(x - 40) <= 9) & (np.abs(y - 22) <= 12) & (np.abs(z - 38) <= 7)
    return sphere | box


def _poses(b, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0, 2 * math.pi, b), rng.uniform(-1.2, 1.2, b),
                     rng.uniform(0.9, 1.1, b)], axis=1).astype(np.float32)


def _carry(jparams, tmp_path, cfg):
    """JAX params -> npz on disk -> the port's network (the weight path the
    CLI's --weights takes)."""
    path = os.path.join(tmp_path, "params.npz")
    save_params_npz(path, jparams)
    net = tshader.init_shader_params(1, cfg, device="cpu")
    return jax_params.load_jax_params(net, jax_params.load_params_npz(path))


def test_whole_slice_matches_jax_multipass(tmp_path, monkeypatch):
    """The slice against JAX shader_forward(resample="multipass") in fp32 at
    batch 8, 16^3 voxels, new_size 32, one block per stack, base 16: e_conv3
    is [8,16,16,8,32] and res2/res3 are 256 wide, so JAX runs its three
    Pallas kernels (interpret mode) and the port routes the same layers to
    its three kernel wrappers (plain versions on the CPU). The sigmoid
    output agrees to 2e-4: fp32 roundoff of ~20 convs in other summation
    orders, amplified by the residual stacks."""
    cfg_kw = dict(new_size=32, res1_blocks=1, res2_blocks=1, res3_blocks=1, base=16)
    jcfg = jshader.ShaderConfig(**cfg_kw)
    tcfg = tshader.ShaderConfig(**cfg_kw)
    jparams = jax.tree.map(np.asarray, jax.jit(jshader.init_shader_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    jparams = {k: (rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
                   if k.endswith("alpha") else v) for k, v in jparams.items()}
    vox = np.repeat(_sphere_box(16).astype(np.float32)[None, :, :, :, None], 8, axis=0)
    pose = _poses(8)

    monkeypatch.setattr(jl, "PALLAS_CONV3D", True)
    monkeypatch.setattr(jl, "WINOGRAD_2D", "pallas")
    fwd = jax.jit(lambda p, v, q: jshader.shader_forward(p, v, q, jcfg, resample="multipass"))
    want = np.asarray(fwd({k: jnp.asarray(v) for k, v in jparams.items()},
                          jnp.asarray(vox), jnp.asarray(pose)))

    monkeypatch.setattr(tl, "CUDA_CONV3D", True)
    monkeypatch.setattr(tl, "WINOGRAD_2D", True)
    calls = {"k1": 0, "k2": 0, "k3": 0}

    def counted(key, fn):
        def wrapped(*a):
            calls[key] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(cuda_resample, "interp_pass_fwd",
                        counted("k1", cuda_resample.interp_pass_fwd))
    monkeypatch.setattr(cuda_conv3d, "nc_conv3d", counted("k2", cuda_conv3d.nc_conv3d))
    monkeypatch.setattr(cuda_winograd, "wino_conv2d", counted("k3", cuda_winograd.wino_conv2d))
    net = _carry(jparams, tmp_path, tcfg)
    got = tshader.shader_forward(net, torch.from_numpy(vox), torch.from_numpy(pose),
                                 resample="multipass").detach().numpy()
    # e_conv3 + 2 res1 convs + skip; 3 res2 + 3 res3 convs; 8 passes
    assert calls == {"k1": 8, "k2": 4, "k3": 6}
    assert got.shape == want.shape == (8, 128, 128, 1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_trained_asset_exact_path_matches_jax(tmp_path):
    """The trained assets/shader_tiny_silhouette.npz (+ shader_tiny_arch.json)
    carried into the port renders what JAX renders on the exact resample
    path; fp32, 2e-4 as above."""
    arch = _tiny_arch()
    jparams = load_params_npz(os.path.join(ASSETS, "shader_tiny_silhouette.npz"))
    vox = np.repeat(_sphere_box(64).astype(np.float32)[None, :, :, :, None], 2, axis=0)
    pose = _poses(2, seed=1)
    want = np.asarray(jshader.shader_forward(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(vox),
        jnp.asarray(pose), jshader.ShaderConfig(**arch), resample="exact"))
    net = _carry(jparams, tmp_path, tshader.ShaderConfig(**arch))
    got = tshader.shader_forward(net, torch.from_numpy(vox), torch.from_numpy(pose),
                                 resample="exact").detach().numpy()
    assert got.shape == want.shape == (2, 256, 256, 1)
    assert want.max() - want.min() > 0.5  # the trained net draws a silhouette
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def _tiny_arch():
    with open(os.path.join(ASSETS, "shader_tiny_arch.json")) as f:
        return {k: tuple(v) if isinstance(v, list) else v for k, v in json.load(f).items()}


def test_params_round_trip_and_strict_keys():
    """JAX params -> port -> JAX params is the identity; loading is strict."""
    cfg = tshader.ShaderConfig(**_tiny_arch())
    jparams = load_params_npz(os.path.join(ASSETS, "shader_tiny_silhouette.npz"))
    net = jax_params.load_jax_params(tshader.init_shader_params(0, cfg, device="cpu"), jparams)
    back = jax_params.jax_params_from_module(net)
    assert set(back) == set(jparams)
    for k in jparams:
        np.testing.assert_array_equal(back[k], jparams[k])
    assert net.encoder["e_conv1"].e_conv1.weight.shape == (8, 1, 5, 5, 5)  # OIDHW
    assert net.encoder["e_conv7"].e_conv7.weight.shape == (32, 16, 4, 4)  # (in, out, k, k)
    with pytest.raises(KeyError, match="missing"):
        jax_params.load_jax_params(net, {k: v for k, v in jparams.items()
                                         if not k.endswith("e_conv11/biases")})
    with pytest.raises(KeyError, match="unexpected"):
        jax_params.load_jax_params(net, {**jparams, "encoder/extra/weights": np.zeros(1)})
    bad = dict(jparams)
    bad["encoder/e_conv11/weights"] = np.zeros((3, 3, 1, 16), np.float32)
    with pytest.raises(ValueError, match="shape"):
        jax_params.load_jax_params(net, bad)


def test_binvox_and_png_codecs(tmp_path):
    """The port's binvox codec round-trips and reads what the JAX package's
    writes; its PNG encoder decodes (PIL) to the same pixels."""
    from PIL import Image

    vox = _sphere_box(32)
    p1 = os.path.join(tmp_path, "a.binvox")
    p2 = os.path.join(tmp_path, "b.binvox")
    tbinvox.save_binvox(vox, p1)
    jbinvox.save_binvox(vox, p2)
    np.testing.assert_array_equal(tbinvox.load_binvox(p1) > 0, vox)
    np.testing.assert_array_equal(jbinvox.load_binvox(p1) > 0, vox)
    np.testing.assert_array_equal(tbinvox.load_binvox(p2) > 0, vox)
    rng = np.random.default_rng(0)
    for img in (rng.integers(0, 256, (5, 7), dtype=np.uint8),
                rng.integers(0, 256, (6, 4, 3), dtype=np.uint8)):
        path = os.path.join(tmp_path, "x.png")
        with open(path, "wb") as f:
            f.write(encode_png(img))
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def _cli_args(tmp_path, render_dir, extra):
    vox_path = os.path.join(tmp_path, "sb.binvox")
    tbinvox.save_binvox(_sphere_box(64), vox_path)
    return ["--voxel_path", vox_path, "--render_dir", str(render_dir),
            "--weights", os.path.join(ASSETS, "shader_tiny_silhouette.npz"),
            "--arch", os.path.join(ASSETS, "shader_tiny_arch.json")] + extra


def test_cli_render_matches_jax_render(tmp_path):
    """`render --device cpu` with the trained asset writes one PNG holding
    what the JAX package renders for the same voxel, pose and weights (JAX
    shader_forward, exact resample, scaled to uint8 as both CLIs do): at
    most one level apart, since 2e-4 of fp32 roundoff can cross a rounding
    boundary."""
    from PIL import Image

    from rendernet_tpu.cli.demo import compute_pose_param
    from rendernet_tpu.utils.image import to_uint8
    from rendernet_tpu_torch.cli import demo as tdemo

    out = tmp_path / "t"
    assert tdemo.main(_cli_args(tmp_path, out, ["--device", "cpu"])) == 0
    names = sorted(os.listdir(out))
    assert names == ["000_sb_pose_250.000000_60.000000_3.300000_light_250.000000_"
                     "60.000000.png"]
    jparams = load_params_npz(os.path.join(ASSETS, "shader_tiny_silhouette.npz"))
    vox = _sphere_box(64).astype(np.float32)[None, :, :, :, None]
    fwd = jax.jit(lambda p, v, q: jshader.shader_forward(
        p, v, q, jshader.ShaderConfig(**_tiny_arch())))
    img = np.asarray(fwd({k: jnp.asarray(v) for k, v in jparams.items()},
                         jnp.asarray(vox), jnp.asarray(compute_pose_param(250, 60, 3.3))))
    want = to_uint8(img[0, :, :, 0], 255.0).astype(int)
    got = np.asarray(Image.open(out / names[0])).astype(int)
    assert got.shape == want.shape == (256, 256)
    assert np.abs(got - want).max() <= 1


def test_cli_rotate_sweep_writes_every_frame(tmp_path):
    """`--rotate --sweep_batch 24 --resample multipass`: 72 frames in 3
    forwards, the tail unpadded, names numbered 000..071."""
    from rendernet_tpu_torch.cli import demo as tdemo

    out = tmp_path / "sweep"
    tdemo.main(_cli_args(tmp_path, out, ["--device", "cpu", "--rotate", "--sweep_batch",
                                         "24", "--resample", "multipass"]))
    names = sorted(os.listdir(out))
    assert len(names) == 72
    assert [n[:3] for n in names] == [f"{i:03d}" for i in range(72)]


def test_cli_without_cuda_fails_loudly(tmp_path):
    """No card and no --device cpu: the CLI raises instead of quietly
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device works")
    from rendernet_tpu_torch.cli import demo as tdemo

    with pytest.raises(RuntimeError, match="--device cpu"):
        tdemo.main(_cli_args(tmp_path, tmp_path / "none", []))
    assert not os.path.exists(tmp_path / "none")
