"""The port's ops against the JAX package on the CPU.

Same numpy inputs (from a seed) go through each JAX function and its
PyTorch counterpart. Where JAX reaches a Pallas kernel it runs it in
interpret mode, as its own tests do; the port runs each kernel's plain
PyTorch version (its wrapper's CPU path). Tolerances are stated per test.
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.ops import pallas_conv3d, pallas_winograd, resample as jresample
from rendernet_tpu.ops import pallas_resample as jmp
from rendernet_tpu.ops import transforms as jtransforms
from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd
from rendernet_tpu_torch.ops import resample as tresample
from rendernet_tpu_torch.ops import transforms as ttransforms

torch.set_num_threads(2)

S, N = 16, 32  # small grids keep JAX's interpret mode fast

# Poses whose quarter turns reach k = 0, 1, 2, 3 in the (x, z) plane
# (k = round((pi/2 - azimuth) / (pi/2)) mod 4) and in the (x, y) plane
# (k = round(elevation / (pi/2)) mod 4), negative angles included so that the
# floor modulo of negative turn counts is exercised.
POSES = np.array([
    [math.pi / 2 + 0.2, 0.3, 1.0],          # kxz 0, kxy 0
    [0.2, 1.2 + 0.3, 0.9],                  # kxz 1, kxy 1
    [-math.pi / 2 + 0.2, math.pi + 0.3, 1.1],  # kxz 2, kxy 2
    [-math.pi + 0.3, -1.4, 1.05],           # kxz 3, kxy 3 (-1 mod 4)
    [4.9, -3.0, 0.95],                      # kxz 2 via a large azimuth, kxy 2
    [2.5, -0.8, 0.85],
], np.float32)


def _blob(rng, s=S, c=1):
    vol = rng.random((2, s, s, s, c)).astype(np.float32)
    vol[:, :1] = vol[:, -1:] = 0
    vol[:, :, :1] = vol[:, :, -1:] = 0
    vol[:, :, :, :1] = vol[:, :, :, -1:] = 0
    return vol


def test_quarter_turns_reach_all_k_in_both_planes():
    steps = cuda_resample.build_pass_plan(torch.from_numpy(POSES), size=S, new_size=N)
    ks = {plane: set(k.tolist()) for _, plane, k in
          (s for s in steps if s[0] == "qturn")}
    assert ks == {(0, 2): {0, 1, 2, 3}, (0, 1): {0, 1, 2, 3}}


def test_transforms_match_jax():
    """Pose matrices: fp32 on both sides; 1e-6 covers the sin/cos ulps."""
    for fn in ("rotation_around_grid_centroid", "grid_to_grid_matrix"):
        want = np.asarray(getattr(jtransforms, fn)(jnp.asarray(POSES)))
        got = getattr(ttransforms, fn)(torch.from_numpy(POSES)).numpy()
        scale = max(1.0, np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=1e-6 * scale, rtol=0)
    vox = np.random.default_rng(0).random((2, 3, 4, 5, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        ttransforms.voxel_to_image_axes(torch.from_numpy(vox)).numpy(),
        np.asarray(jtransforms.voxel_to_image_axes(jnp.asarray(vox))))


def test_exact_resample_matches_jax():
    """Exact trilinear path: the same fp32 lerp tree; 1e-5 covers one-ulp
    differences in the source coordinates."""
    vol = _blob(np.random.default_rng(1), c=2)
    want = np.asarray(jresample.rotate_resample_to_camera(
        jnp.asarray(vol), jnp.asarray(POSES[:2]), new_size=N))
    got = tresample.rotate_resample_to_camera(
        torch.from_numpy(vol), torch.from_numpy(POSES[:2]), new_size=N).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_plan_matches_jax_and_exact_backward_map():
    """The multipass plan: same step structure and turn counts as JAX, and
    its composed matrix equals grid_to_grid_matrix (+ the embedding pad).
    Tolerances are JAX's own test's (1e-5 linear part, 1e-4 offsets: the
    solved offsets carry fp32 solve roundoff)."""
    poses = torch.from_numpy(POSES)
    steps = cuda_resample.build_pass_plan(poses, size=S, new_size=N)
    jsteps = jmp.build_pass_plan(jnp.asarray(POSES), size=S, new_size=N)
    assert [(s[0], s[1]) for s in steps] == [(s[0], s[1]) for s in jsteps]
    assert [s[1] for s in steps if s[0] == "interp"] == [0, 2, 0, 0, 1, 0, 1, 2]
    for s, js in zip(steps, jsteps):
        if s[0] == "qturn":
            np.testing.assert_array_equal(s[2].numpy(), np.asarray(js[2]))
        else:
            np.testing.assert_allclose(s[2].numpy(), np.asarray(js[2]), atol=1e-4)
    total = cuda_resample.compose_plan_matrix(steps, N).numpy()
    target = ttransforms.grid_to_grid_matrix(poses, size=S, new_size=N).numpy()
    pad = (N - S) // 2
    np.testing.assert_allclose(total[:, :3, :3], target[:, :, :3], atol=1e-5)
    np.testing.assert_allclose(total[:, :3, 3], target[:, :, 3] + pad, atol=1e-4)


def test_interp_pass_plain_matches_pallas_kernel():
    """K1's plain version against the Pallas kernel (interpret mode), with
    an out_lanes window and positions falling off both ends of the row:
    identical fp32 arithmetic, 1e-5 covers reordering by the compilers."""
    rng = np.random.default_rng(2)
    bc, r, lanes, ol, db = 3, 64, 32, 20, 8
    vol = rng.standard_normal((bc, r, lanes)).astype(np.float32)
    u = rng.uniform(-1, 1, (bc, 4)).astype(np.float32)
    params = np.stack([1 + 0.4 * u[:, 0], 0.4 * u[:, 1], 0.4 * u[:, 2], 20 * u[:, 3]],
                      -1).astype(np.float32)
    want = np.asarray(jmp.apply_interp_pass(jnp.asarray(vol), jnp.asarray(params), db, 6, ol))
    got = cuda_resample.apply_interp_pass(torch.from_numpy(vol), torch.from_numpy(params), db, ol)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multipass_matches_jax(dtype):
    """The whole multipass warp (plain passes) against JAX's (Pallas passes
    in interpret mode) at S=16, N=32. fp32: 1e-4 (plan coefficients carry
    solve roundoff into positions). bf16: each of the 8 passes rounds to
    bf16 (2^-8 relative) on both sides from slightly different positions;
    the data are in [0, 1], so 2^-5 absolute."""
    vol = _blob(np.random.default_rng(3))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jmp.rotate_resample_multipass(
        jnp.asarray(vol), jnp.asarray(POSES[:2]), new_size=N,
        compute_dtype=jdt).astype(jnp.float32))
    got = cuda_resample.rotate_resample_multipass(
        torch.from_numpy(vol), torch.from_numpy(POSES[:2]), new_size=N,
        compute_dtype=tdt)
    assert got.dtype == tdt
    atol = 1e-4 if dtype == "float32" else 2.0 ** -5
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol, rtol=0)


def test_multipass_all_turns():
    """All quarter-turn cases, with two channels, against JAX in fp32
    (1e-4, as above)."""
    vol = _blob(np.random.default_rng(4), c=2)
    vol = np.concatenate([vol] * 3)  # 6 samples for the 6 poses
    want = np.asarray(jmp.rotate_resample_multipass(
        jnp.asarray(vol), jnp.asarray(POSES), new_size=N))
    got = cuda_resample.rotate_resample_multipass(
        torch.from_numpy(vol), torch.from_numpy(POSES), new_size=N)
    assert got.shape == want.shape == (6, N, N, N, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# K2: narrow-channel conv3d
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,co", [
    ((1, 4, 8, 8, 16), 16),
    ((2, 3, 4, 8, 8), 32),
    ((1, 2, 8, 4, 32), 64),
])
def test_conv3d_plain_matches_pallas(shape, co):
    """K2's plain version against nc_conv3d (interpret mode): fp32 sums of
    27*ci products in different orders; 1e-4, as JAX's own kernel test."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, shape[-1], co)) * 0.1).astype(np.float32)
    want = np.asarray(pallas_conv3d.nc_conv3d(jnp.asarray(x), jnp.asarray(w)))
    got = cuda_conv3d.nc_conv3d(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_conv3d_envelope_matches_jax():
    table = [
        ((8, 64, 64, 32, 16), (3, 3, 3, 16, 32), (1, 1, 1)),
        ((8, 64, 64, 32, 32), (3, 3, 3, 32, 32), (1, 1, 1)),
        ((8, 16, 16, 8, 16), (3, 3, 3, 16, 32), (1, 1, 1)),
        ((1, 4, 8, 8, 16), (3, 3, 3, 16, 16), (1, 1, 1)),
        ((2, 5, 10, 24, 24), (3, 3, 3, 24, 64), (1, 1, 1)),
        ((1, 4, 7, 8, 16), (3, 3, 3, 16, 16), (1, 1, 1)),   # W*D/f not a multiple of 8
        ((1, 4, 8, 6, 16), (3, 3, 3, 16, 32), (1, 1, 1)),   # D % f
        ((1, 4, 8, 8, 16), (3, 3, 3, 16, 8), (1, 1, 1)),    # co = 8
        ((1, 4, 8, 8, 16), (3, 3, 3, 16, 128), (1, 1, 1)),  # co = 128
        ((1, 4, 8, 8, 16), (3, 3, 3, 16, 32), (1, 1, 2)),   # strided
        ((1, 4, 8, 8, 16), (5, 5, 5, 16, 32), (1, 1, 1)),   # 5x5x5
        ((1, 4, 8, 8, 16), (3, 3, 3, 8, 32), (1, 1, 1)),    # ci mismatch
        ((1, 4, 8, 16), (3, 3, 16, 32), (1, 1)),            # 2D
    ]
    for xs, ws, st in table:
        assert (cuda_conv3d.nc_conv3d_supported(xs, ws, st)
                == pallas_conv3d.nc_conv3d_supported(xs, ws, st)), (xs, ws, st)


# ---------------------------------------------------------------------------
# K3: Winograd
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_winograd_plain_matches_pallas(dtype):
    """K3's plain version against wino_conv2d (interpret mode) at
    (8,16,16,256)->256: same rounding points (V and U cast to the dtype,
    fp32 GEMM sums in other orders, one output rounding). fp32: 1e-4 of
    max|y|. bf16: the output roundings may land one bf16 ulp apart
    (2^-8 relative): 2^-7 of max|y|."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((8, 16, 16, 256)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 256, 256)) * 0.05).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(pallas_winograd.wino_conv2d(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)).astype(jnp.float32))
    got = cuda_winograd.wino_conv2d(
        torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)).float().numpy()
    tol = (1e-4 if dtype == "float32" else 2.0 ** -7) * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


# The old edge table of the envelope test; each model shape below is swept
# over batches 8-64, where JAX's tiling clause (_tiles) turns convs away at
# batches that are not multiples of 8.
_WINO_EDGES = [
    ((8, 64, 64, 1024), (3, 3, 1024, 1024), (1, 1)),
    ((8, 64, 64, 512), (3, 3, 512, 512), (1, 1)),
    ((8, 16, 16, 256), (3, 3, 256, 256), (1, 1)),
    ((8, 6, 70, 256), (3, 3, 256, 128), (1, 1)),
    ((1, 64, 64, 1024), (3, 3, 1024, 1024), (1, 1)),    # batch < 8
    ((8, 64, 64, 128), (3, 3, 128, 128), (1, 1)),       # ci < 256
    ((8, 64, 64, 320), (3, 3, 320, 320), (1, 1)),       # not a multiple of 128
    ((8, 63, 64, 256), (3, 3, 256, 256), (1, 1)),       # odd H
    ((8, 64, 64, 256), (4, 4, 256, 256), (1, 1)),       # 4x4
    ((8, 64, 64, 256), (3, 3, 256, 256), (2, 2)),       # strided
]
_WINO_SWEEPS = {f"{h}x{w}x{c}": [((b, h, w, c), (3, 3, c, c), (1, 1)) for b in range(8, 65)]
                for h, w, c in ((64, 64, 1024), (64, 64, 512), (32, 32, 1024), (32, 32, 512),
                                (64, 64, 256), (32, 32, 256))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cases", ["edges", *_WINO_SWEEPS])
def test_winograd_envelope_matches_jax(cases, dtype):
    """The port's envelope equals JAX's for the activations' dtype, its
    tiling clause included: the edge table, and each model shape at every
    batch from 8 to 64."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    table = _WINO_EDGES if cases == "edges" else _WINO_SWEEPS[cases]
    for xs, ws, st in table:
        assert (cuda_winograd.wino_conv2d_supported(xs, ws, st, tdt)
                == pallas_winograd.wino_conv2d_supported(xs, ws, st, dtype=jdt)), (xs, ws)


def test_phong_composite_matches_jax():
    """The CLI's host-side shading: the same float64 numpy on both sides."""
    from rendernet_tpu.ops import phong as jphong
    from rendernet_tpu_torch.ops import phong as tphong

    imgs = np.random.default_rng(7).random((2, 6, 5, 3)).astype(np.float32)
    light = tphong.np_generate_light_pos(60, 250)
    np.testing.assert_array_equal(light, jphong.np_generate_light_pos(60, 250))
    col = np.array([[1.0, 1.0, 1.0]])
    np.testing.assert_allclose(tphong.np_phong_composite(imgs, light, col, 0.1, 0.9),
                               jphong.np_phong_composite(imgs, light, col, 0.1, 0.9),
                               rtol=1e-12, atol=1e-12)
