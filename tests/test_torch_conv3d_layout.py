"""The host side of K2's and K2w's bf16 kernels, on the CPU.

The kernels (``csrc/conv3d.cu``, ``csrc/conv3d_wgrad.cu``) cut the positions
into columns of ``TILE_W x TILE_D`` positions of one batch element and walk
each column down H, one row per h; the rows of all columns split into one
contiguous range per persistent CTA (``cuda_conv3d.conv3d_plan``'s grid),
and ``cuda_conv3d.wgrad_plan`` sizes K2w's partial sums. These tests hold the
schedule to covering every position exactly once, the workspace to what the
kernels write, and the weight operand K2 reads to JAX's layout, for the
forward and for the data gradient (``pallas_conv3d._nc_bwd``'s flipped,
io-swapped weights).
"""
from __future__ import annotations

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
    """bf16: one CTA per SM over all channel slices, each CTA writing its
    [27, slice] sums; cpad covers C in whole slices (16 or 32 wide). fp32:
    the CUDA-core kernel's position chunks over 3 kh x 16-channel slices."""
    c = x_shape[-1]
    parts, cpad = cuda_conv3d.wgrad_plan(torch.bfloat16, x_shape, co, 132)
    cs, os_ = (16 if c <= 16 else 32), (16 if co == 16 else 32)
    assert cpad % cs == 0 and c <= cpad < c + cs
    slices = cpad // cs * (co // os_)
    assert 1 <= parts <= cuda_conv3d.conv3d_rows(x_shape)
    assert parts * slices <= max(132, slices)
    parts, cpad = cuda_conv3d.wgrad_plan(torch.float32, x_shape, co, 132)
    assert cpad == -(-c // 16) * 16 and parts >= 1
    assert parts <= x_shape[0] * x_shape[1] * -(-x_shape[2] // 4) * -(-x_shape[3] // 16)


def test_wgrad_plan_at_the_training_shape():
    """The res1 training shape on a 132-SM card: 132 CTAs of 32 x 32
    channels (a 14.6 MB workspace); fp32 keeps its 176 chunks."""
    assert cuda_conv3d.wgrad_plan(torch.bfloat16, (24, 64, 64, 32, 32), 32, 132) == (132, 32)
    assert cuda_conv3d.wgrad_plan(torch.float32, (24, 64, 64, 32, 32), 32, 132) == (176, 32)
    assert cuda_conv3d.conv3d_plan((24, 64, 64, 32, 32), 132) == 132


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
