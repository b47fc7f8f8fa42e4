"""The host side of K2's and K2w's kernels, on the CPU.

The kernels (``csrc/conv3d.cu``, ``csrc/conv3d_wgrad.cu``) cut the positions
into columns of ``TILE_W x TILE_D`` positions of one batch element and walk
each column down H, one row per h; the rows of all columns split into one
contiguous range per persistent CTA (``cuda_conv3d.conv3d_plan``'s grid),
and ``cuda_conv3d.wgrad_plan`` sizes K2w's partial sums. These tests hold the
schedule to covering every position exactly once, the workspace to what the
kernels write, and the weight operand K2 reads to JAX's layout, for the
forward and for the data gradient (``pallas_conv3d._nc_bwd``'s flipped,
io-swapped weights). K2w's fp32 kernel walks rows of 4 W x 32 D and cuts
each CTA's rows into accumulator chains (``wgrad_chains``): its chains,
parts and slices must sum every position once and fill every value of the
workspace once.
"""
from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu_torch.ops import cuda_conv3d
from rendernet_tpu_torch.ops.conv_grad import flip_io

# The models' shapes (serving, training at patch 128 and 64, recon), a ragged
# one, and the card tests' odd shapes.
SHAPES = [(8, 64, 64, 32, 32), (24, 64, 64, 32, 16), (24, 32, 32, 32, 32), (5, 64, 64, 32, 16),
          (2, 5, 10, 24, 24), (2, 4, 8, 20, 32), (2, 4, 8, 16, 20), (1, 3, 4, 40, 8)]


def _row_ranges(rows, grid):
    """CTA i's rows ``[rows * i // grid, rows * (i + 1) // grid)``, as the
    kernels split them (``conv3d_mma_kernel``, ``conv3d_wgrad_mma_kernel``)."""
    return [(rows * i // grid, rows * (i + 1) // grid) for i in range(grid)]


def _row_tile(x_shape, r):
    """Row r -> (b, h, first w, first d), as ``column()`` and the row walk
    of ``csrc/conv3d_tile.cuh`` decode it: D tiles vary fastest, then W
    tiles, then b; a column's rows are its h, in order."""
    b_, h_, w_, d_, _ = x_shape
    ndt, nwt = -(-d_ // cuda_conv3d.TILE_D), -(-w_ // cuda_conv3d.TILE_W)
    col, h = divmod(r, h_)
    rest, dt = divmod(col, ndt)
    b, wt = divmod(rest, nwt)
    return b, h, wt * cuda_conv3d.TILE_W, dt * cuda_conv3d.TILE_D


@pytest.mark.parametrize("x_shape", SHAPES)
def test_schedule_covers_every_position_once(x_shape):
    """For several grids, the CTAs' row ranges tile the rows without gap or
    overlap, and their rows' tiles (clipped to W and D) cover every position
    of the volume exactly once."""
    b_, h_, w_, d_, _ = x_shape
    rows = cuda_conv3d.conv3d_rows(x_shape)
    for grid in sorted({1, 7, 132, cuda_conv3d.conv3d_plan(x_shape, 132), rows}):
        if grid > rows:
            continue
        ranges = _row_ranges(rows, grid)
        assert ranges[0][0] == 0 and ranges[-1][1] == rows
        assert all(r1 == n0 for (_, r1), (n0, _) in zip(ranges, ranges[1:]))
        assert all(r1 > r0 for r0, r1 in ranges)  # every CTA has a row
        seen = np.zeros((b_, h_, w_, d_), np.int32)
        for r0, r1 in ranges:
            for r in range(r0, r1):
                b, h, w0, d0 = _row_tile(x_shape, r)
                seen[b, h, w0:w0 + cuda_conv3d.TILE_W, d0:d0 + cuda_conv3d.TILE_D] += 1
        assert (seen == 1).all(), (x_shape, grid)


@pytest.mark.parametrize("x_shape", SHAPES)
@pytest.mark.parametrize("co", [16, 32, 64])
def test_wgrad_workspace_holds_every_cta(x_shape, co):
    """Both dtypes: one CTA per SM over all channel slices, each CTA writing
    its [27, slice] sums; cpad covers C in whole slices (16 or 32 wide);
    never more CTAs than the dtype's rows (bf16 8 W, fp32 4 W x 32 D)."""
    c = x_shape[-1]
    cs, os_ = (16 if c <= 16 else 32), (16 if co == 16 else 32)
    for dtype in (torch.bfloat16, torch.float32):
        parts, cpad = cuda_conv3d.wgrad_plan(dtype, x_shape, co, 132)
        assert cpad % cs == 0 and c <= cpad < c + cs
        slices = cpad // cs * (co // os_)
        assert 1 <= parts <= cuda_conv3d.conv3d_rows(x_shape, dtype)
        assert parts * slices <= max(132, slices)


def test_wgrad_plan_at_the_training_shape():
    """The res1 training shape on a 132-SM card: 132 CTAs of 32 x 32
    channels (a 14.6 MB workspace) in both dtypes."""
    assert cuda_conv3d.wgrad_plan(torch.bfloat16, (24, 64, 64, 32, 32), 32, 132) == (132, 32)
    assert cuda_conv3d.wgrad_plan(torch.float32, (24, 64, 64, 32, 32), 32, 132) == (132, 32)
    assert cuda_conv3d.conv3d_plan((24, 64, 64, 32, 32), 132) == 132


# fp32 K2w's cases in chip_smoke.py (the gradient check's, the texture
# step's, the batch-24 check shapes, the ragged one) and the card tests'
# fp32 edges (W and D not whole tiles, C = 24 and 48, co = 64).
F32_WGRAD_SHAPES = [((8, 64, 64, 32, 16), 32), ((8, 64, 64, 32, 32), 32),
                    ((8, 64, 64, 32, 16), 16), ((24, 64, 64, 32, 16), 32),
                    ((24, 64, 64, 32, 32), 32), ((2, 5, 10, 24, 24), 64),
                    ((2, 5, 6, 40, 24), 64), ((2, 3, 6, 48, 48), 32)]


def _f32_row_positions(x_shape, rows):
    """Flat position indices of fp32 K2w's rows (4 W x 32 D of one (b, h),
    decoded as ``column<F_TW>``), clipped to W and D."""
    b_, h_, w_, d_, _ = x_shape
    tw, td = cuda_conv3d.TILE_W_F32, cuda_conv3d.TILE_D
    col, h = np.divmod(rows, h_)
    rest, dt = np.divmod(col, -(-d_ // td))
    b, wt = np.divmod(rest, -(-w_ // tw))
    w = wt[:, None, None] * tw + np.arange(tw)[None, :, None]
    d = dt[:, None, None] * td + np.arange(td)[None, None, :]
    ok = (w < w_) & (d < d_)
    flat = ((b[:, None, None] * h_ + h[:, None, None]) * w_ + w) * d_ + d
    return flat[np.broadcast_to(ok, flat.shape)]


@pytest.mark.parametrize("x_shape,co", F32_WGRAD_SHAPES)
def test_wgrad_f32_chains_cover_every_position_once(x_shape, co):
    """fp32 K2w on a 132-SM card: each CTA's rows cut into chains
    (``wgrad_chains``) of 1 to WGRAD_CHAIN_ROWS_F32 rows, contiguous and in
    order; over all parts and chains every position of the volume is summed
    exactly once, and every (input, output) channel pair of cpad x co lies
    in exactly one slice."""
    b_, h_, w_, d_, c = x_shape
    rows = cuda_conv3d.conv3d_rows(x_shape, torch.float32)
    parts, cpad = cuda_conv3d.wgrad_plan(torch.float32, x_shape, co, 132)
    cs, os_ = (16 if c <= 16 else 32), (16 if co == 16 else 32)
    seen = np.zeros(b_ * h_ * w_ * d_, np.int32)
    for i in range(parts):
        r0, r1 = rows * i // parts, rows * (i + 1) // parts
        chains = cuda_conv3d.wgrad_chains(r0, r1)
        assert chains[0][0] == r0 and chains[-1][1] == r1
        assert all(a1 == b0 for (_, a1), (b0, _) in zip(chains, chains[1:]))
        assert all(1 <= e - a <= cuda_conv3d.WGRAD_CHAIN_ROWS_F32 for a, e in chains)
        for a, e in chains:
            np.add.at(seen, _f32_row_positions(x_shape, np.arange(a, e)), 1)
    assert (seen == 1).all()
    pairs = np.zeros((cpad, co), np.int32)
    for ys in range(cpad // cs):
        for zs in range(co // os_):
            pairs[ys * cs:(ys + 1) * cs, zs * os_:(zs + 1) * os_] += 1
    assert (pairs == 1).all() and c <= cpad


@pytest.mark.parametrize("x_shape,co", F32_WGRAD_SHAPES)
def test_wgrad_f32_workspace_holds_every_slot(x_shape, co):
    """Every value of the workspace ``[parts, 27, cpad, co]`` is written by
    exactly one thread's fragment of fp32 K2w's store (block (part, C
    slice, co slice), warp (kh, kw), tap kd, m16 block, row half, lane, n8
    block; channel c0 + 16 mf + 8 half + lane / 4, outputs o0 + 8 nf + 2
    (lane % 4) and + 1), and nothing outside it."""
    c = x_shape[-1]
    parts, cpad = cuda_conv3d.wgrad_plan(torch.float32, x_shape, co, 132)
    cs, os_ = (16 if c <= 16 else 32), (16 if co == 16 else 32)
    p, ys, zs, warp, kd, mf, half, lane, nf, e = np.meshgrid(
        np.arange(parts), np.arange(cpad // cs), np.arange(co // os_), np.arange(9),
        np.arange(3), np.arange(cs // 16), np.arange(2), np.arange(32), np.arange(os_ // 8),
        np.arange(2), indexing="ij", sparse=True)
    tap = warp * 3 + kd
    cc = ys * cs + mf * 16 + half * 8 + lane // 4
    o = zs * os_ + nf * 8 + 2 * (lane % 4) + e
    flat = ((p * 27 + tap) * cpad + cc) * co + o
    size = parts * 27 * cpad * co
    flat = np.broadcast_to(flat, np.broadcast_shapes(*(a.shape for a in (
        p, ys, zs, warp, kd, mf, half, lane, nf, e)))).ravel()
    assert flat.min() >= 0 and flat.max() < size
    assert (np.bincount(flat, minlength=size) == 1).all()


@pytest.mark.parametrize("c,co", [(16, 32), (32, 32), (32, 16), (24, 64)])
def test_kernel_weights_match_jax_layout(c, co):
    """K2's weight operand is JAX's [3,3,3,C,co] as [27, C, co], tap-major in
    (kh, kw, kd) order; for the data gradient, JAX's flipped, io-swapped
    weights (``jnp.flip(w, (0, 1, 2)).swapaxes(3, 4)``) as [27, co, C]."""
    w = np.random.default_rng(0).standard_normal((3, 3, 3, c, co)).astype(np.float32)
    got = cuda_conv3d.kernel_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.asarray(w).reshape(27, c, co)))
    assert got.is_contiguous()
    got = cuda_conv3d.kernel_weights(flip_io(torch.from_numpy(w)))
    want = jnp.flip(jnp.asarray(w), axis=(0, 1, 2)).swapaxes(3, 4).reshape(27, co, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.is_contiguous()


def test_wgrad_f32_kernel_constants_and_shared_memory():
    """fp32 K2w's compiled tile (``F_TW``, ``TD``) is the plan's rows', and
    its shared memory (128 bytes of alignment, ``F_RING`` slots of a halo
    plane (F_TW + 2) x (TD + 2) x CS and a gy row F_TW x TD x OS, fp32) fits
    a CTA at every channel slice; at res1 it is 212,608 bytes."""
    src = (pathlib.Path(cuda_conv3d.__file__).parents[1] / "csrc" / "conv3d_wgrad.cu").read_text()
    tile = (pathlib.Path(cuda_conv3d.__file__).parents[1] / "csrc" / "conv3d_tile.cuh").read_text()
    k = {n: int(re.search(rf"constexpr int {n} = (\d+);", src)[1]) for n in ("F_TW", "F_RING")}
    td = int(re.search(r"constexpr int TD = (\d+);", tile)[1])
    assert (k["F_TW"], td) == (cuda_conv3d.TILE_W_F32, cuda_conv3d.TILE_D)
    smem = {(cs, os_): 128 + k["F_RING"] * ((k["F_TW"] + 2) * (td + 2) * cs
                                            + k["F_TW"] * td * os_) * 4
            for cs in (16, 32) for os_ in (16, 32)}
    assert max(smem.values()) <= 232448 and smem[32, 32] == 212608
