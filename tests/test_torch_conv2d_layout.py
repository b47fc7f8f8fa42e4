"""The host side of K5's and K5w's bf16 kernels, on the CPU.

Both kernels (``csrc/conv2d.cu``, ``csrc/conv2d_wgrad.cu``) are persistent,
one CTA per SM in clusters of two: cluster k walks work items k, k + grid /
2, ..., each CTA taking its half of the item. K5's items are pairs of
output tiles of 128 pixels of one image row h (along the flattened W * B
axis) by 128 or 256 output channels, the pair sharing its output channels
(``cuda_conv2d.conv2d_plan``, ``conv2d_tile``). Every tap reads its shifted
activation rows as one TMA box of a 3-D tensor map over x as ``[H][W *
B][C]``, whose zero fill outside the tensor is the SAME halo. K5w's items
are (pixel part, pair of row pairs, output tile); the parts' fp32 partial
sums are added in part order (``wgrad_plan``, ``wgrad_item``,
``wgrad_row_block``, ``wgrad_chains``).

These tests hold the schedules to covering every output exactly once, a
numpy emulation of the TMA box gather to the plain version's shifted taps
(``cuda_conv2d._taps``), K5w's plan to its workspace and a fixed
summation order, and the weight operand K5 reads to JAX's layout.
"""
from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu_torch.ops import cuda_conv2d as cc
from rendernet_tpu_torch.ops.conv_grad import flip_io

# HWNC shapes: batches 3, 5, 7, 8 and 24; W * B a multiple of 128 (64 x 8,
# 32 x 24, 16 x 8) and not (64 x 5 = 320, 8 x 3 = 24, 20 x 7 = 140, 12 x 5).
SCHEDULE_SHAPES = [((64, 64, 8, 1024), 1024), ((32, 32, 24, 512), 512),
                   ((64, 64, 5, 512), 512), ((7, 8, 3, 384), 256), ((6, 20, 7, 256), 384),
                   ((4, 16, 8, 128), 128), ((5, 12, 5, 96), 256), ((64, 64, 24, 1024), 1024)]


def _cta_items(n_items, grid):
    """CTA j's (item, rank), as both kernels walk them: CTA j is rank j % 2
    of cluster j // 2, which takes items j // 2, j // 2 + grid / 2, ..."""
    return [[(q, j % 2) for q in range(j // 2, n_items, grid // 2)] for j in range(grid)]


@pytest.mark.parametrize("x_shape,co", SCHEDULE_SHAPES)
def test_conv2d_schedule_covers_every_output_once(x_shape, co):
    """For several grids, the CTAs' tiles (masked past W * B) cover every
    (h, pixel, output channel) of the output exactly once."""
    h, w, b, _ = x_shape
    wb = w * b
    grid0, bn, tiles_per_row, pairs = cc.conv2d_plan(x_shape, co, 132)
    assert bn in (128, 256) and co % bn == 0 and grid0 == 2 * min(pairs, 66)
    assert tiles_per_row * cc.TILE_M >= wb > (tiles_per_row - 1) * cc.TILE_M
    assert pairs == -(-h * tiles_per_row // 2) * (co // bn)
    for grid in sorted({2, 8, grid0, 2 * pairs}):
        seen = np.zeros((h, wb, co), np.int32)
        for items in _cta_items(pairs, grid):
            for q, rank in items:
                hh, m0, n0 = cc.conv2d_tile(q, rank, x_shape, co)
                assert m0 < wb and m0 % cc.TILE_M == 0
                if hh == h:  # the partner of an odd last pixel tile
                    assert rank == 1 and (h * tiles_per_row) % 2 == 1 and m0 == 0
                    continue
                assert 0 <= hh < h
                seen[hh, m0:min(m0 + cc.TILE_M, wb), n0:n0 + bn] += 1
        assert (seen == 1).all(), (x_shape, co, grid)
    # both CTAs of a cluster share the output channels; the co / bn pairs
    # of one pixel-tile pair are adjacent in the walk
    for q in range(pairs):
        assert cc.conv2d_tile(q, 0, x_shape, co)[2] == cc.conv2d_tile(q, 1, x_shape, co)[2]
    assert [cc.conv2d_tile(q, 0, x_shape, co)[:2] for q in range(co // bn)] == \
        [(0, 0)] * (co // bn)


def _box(x3, c0, r0, hh, nc, nr):
    """A numpy emulation of one TMA box of the map ``[H][W * B][C]``: channels
    c0 .. c0 + nc - 1, rows r0 .. r0 + nr - 1 along W * B, image row hh;
    coordinates outside the tensor (negative ones included) read zero."""
    h, wb, c = x3.shape
    out = np.zeros((nr, nc), x3.dtype)
    if not 0 <= hh < h:
        return out
    rs = np.arange(r0, r0 + nr)
    cs = np.arange(c0, c0 + nc)
    ok_r, ok_c = (rs >= 0) & (rs < wb), cs < c
    out[np.ix_(ok_r, ok_c)] = x3[hh][np.ix_(rs[ok_r], cs[ok_c])]
    return out


@pytest.mark.parametrize("x_shape,co", [((5, 6, 3, 96), 128), ((4, 40, 5, 64), 256),
                                        ((3, 16, 8, 128), 128), ((6, 20, 7, 32), 384)])
def test_tma_box_gather_is_the_plain_shifted_tap(x_shape, co):
    """K5: for every tile, tap (ky, kx) and 64-channel chunk, the box at
    (c0, m0 + (kx - 1) B, h + ky - 1) equals the plain version's shifted tap
    ``xpad[h + ky, w + kx, b]`` on the tile's unmasked rows, channels past C
    reading zero: the zero fill outside [0, H) x [0, W B) is the SAME halo.
    K5w: the same for its 64-pixel steps."""
    h, w, b, c = x_shape
    wb = w * b
    x = np.random.default_rng(0).standard_normal(x_shape).astype(np.float32)
    x3 = x.reshape(h, wb, c)
    taps = [t.reshape(h, wb, c).numpy() for t in cc._taps(torch.from_numpy(x))]
    _, _, _, pairs = cc.conv2d_plan(x_shape, co, 132)
    for q, rank in ((q, r) for q in range(pairs) for r in (0, 1)):
        hh, m0, _ = cc.conv2d_tile(q, rank, x_shape, co)
        if hh == h:
            continue
        rows = min(cc.TILE_M, wb - m0)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            for c0 in range(0, c, 64):
                got = _box(x3, c0, m0 + (kx - 1) * b, hh + ky - 1, 64, cc.TILE_M)
                want = np.zeros((rows, 64), np.float32)
                want[:, :min(64, c - c0)] = taps[tap][hh, m0:m0 + rows, c0:c0 + 64]
                np.testing.assert_array_equal(got[:rows], want)
    steps_per_row = -(-wb // cc.STEP_PIXELS)
    for s in range(cc.wgrad_steps(x_shape)):
        hh, m0 = s // steps_per_row, s % steps_per_row * cc.STEP_PIXELS
        rows = min(cc.STEP_PIXELS, wb - m0)
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            got = _box(x3, 0, m0 + (kx - 1) * b, hh + ky - 1, c, cc.STEP_PIXELS)
            np.testing.assert_array_equal(got[:rows], taps[tap][hh, m0:m0 + rows])


WGRAD_SHAPES = [((64, 64, 24, 1024), 1024), ((64, 64, 24, 512), 512), ((32, 32, 24, 1024), 1024),
                ((32, 32, 24, 512), 512), ((64, 64, 5, 512), 512), ((7, 8, 3, 384), 256),
                ((64, 64, 5, 256), 256), ((8, 8, 2, 128), 384), ((6, 36, 5, 128), 384)]


@pytest.mark.parametrize("x_shape,co", WGRAD_SHAPES)
def test_wgrad_plan_holds_every_partial(x_shape, co):
    """K5w bf16 on a 132-SM card: every part non-empty, the parts' steps
    tiling the image's, each item's chains at most 8,192 pixels and tiling
    its steps, the workspace within its cap; the clusters take every item
    once, both CTAs of a cluster the same part, steps and output tile, and
    each part's items write every [9 C, co] sum of its partial once (row
    blocks over every (tap, channel); an odd row pair's partner writes
    nothing)."""
    h, w, b, c = x_shape
    parts, grid = cc.wgrad_plan(torch.bfloat16, x_shape, co, 132)
    bn = cc.tile_n(co)
    rpairs = 9 * c // 128
    per_part = -(-rpairs // 2) * (co // bn)
    steps = cc.wgrad_steps(x_shape)
    assert 1 <= parts <= steps and grid == 2 * min(66, per_part * parts)
    assert parts == 1 or parts * 9 * c * co * 4 <= cc.MAX_PART_BYTES
    taken = sorted(i for items in _cta_items(per_part * parts, grid) for i in items)
    assert taken == sorted((q, r) for q in range(per_part * parts) for r in (0, 1))
    written = np.zeros((parts, 9, c, co), np.int32)
    ranges = {}
    for q, rank in taken:
        p, rp, n0, s0, s1 = cc.wgrad_item(q, rank, x_shape, co, parts)
        assert cc.wgrad_item(q, 1 - rank, x_shape, co, parts)[::2] == (p, n0, s1)
        assert s1 > s0 and ranges.setdefault(p, (s0, s1)) == (s0, s1)
        if rp == rpairs:  # the partner of an odd last row pair
            assert rank == 1 and rpairs % 2 == 1
            assert all(cc.wgrad_row_block(rb)[1] >= c for rb in (2 * rp, 2 * rp + 1))
            continue
        chains = cc.wgrad_chains(s0, s1)
        assert chains[0][0] == s0 and chains[-1][1] == s1
        assert all(e0 == b1 for (_, e0), (b1, _) in zip(chains, chains[1:]))
        assert all(0 < e - s <= cc.MAX_CHAIN_STEPS for s, e in chains)
        assert cc.MAX_CHAIN_STEPS * cc.STEP_PIXELS <= 8192
        for rb in (2 * rp, 2 * rp + 1):
            tap, c0 = cc.wgrad_row_block(rb)
            written[p, tap, c0:c0 + 64, n0:n0 + bn] += 1
    assert (written == 1).all()
    assert [ranges[p] for p in range(parts)] == \
        [(steps * p // parts, steps * (p + 1) // parts) for p in range(parts)]
    # most row pairs are two taps of one channel block
    pairs = [(cc.wgrad_row_block(2 * rp), cc.wgrad_row_block(2 * rp + 1))
             for rp in range(9 * c // 128)]
    assert sum(a[1] == bb[1] and a[0] != bb[0] for a, bb in pairs) >= len(pairs) * 3 // 4


def test_wgrad_plan_at_the_training_shapes():
    """The res2 / res3 training shapes at batch 24 on a 132-SM card: a few
    parts, a workspace well under the 512 MiB cap; the fp32 kernel's
    persistent plan at the gradient check's batch 8 (5 parts of 205 steps
    of 32 pixels at res2), at batch 24 and at a tiny image (one part, no
    workspace); K5's fp32 tiles 128 channels wide."""
    assert cc.wgrad_plan(torch.bfloat16, (64, 64, 24, 1024), 1024, 132) == (5, 132)
    assert cc.wgrad_plan(torch.bfloat16, (64, 64, 24, 512), 512, 132) == (11, 132)
    assert cc.wgrad_plan(torch.float32, (64, 64, 24, 1024), 1024, 132) == (5, 132)
    assert cc.wgrad_plan(torch.float32, (64, 64, 8, 1024), 1024, 132) == (5, 132)
    assert cc.wgrad_plan(torch.float32, (64, 64, 8, 512), 512, 132) == (9, 132)
    assert cc.wgrad_plan(torch.float32, (7, 8, 3, 384), 256, 132) == (1, 28)  # no partials
    assert cc.conv2d_plan((64, 64, 24, 1024), 1024, 132) == (132, 256, 12, 1536)
    assert cc.conv2d_plan((64, 64, 8, 1024), 1024, 132, torch.float32) == (132, 128, 4, 1024)


@pytest.mark.parametrize("x_shape,co,parts", [((5, 12, 5, 128), 128, 3), ((4, 40, 3, 256), 256, 2),
                                              ((130, 2, 4, 128), 128, 1)])
def test_wgrad_order_emulated(x_shape, co, parts):
    """A numpy emulation of K5w's bf16 schedule (its boxes, chains and parts,
    the parts added in order) on one cluster of 2 CTAs, with several parts
    and with one part of two chains (130 steps): equal to the plain version
    within fp32 summation order, and bit for bit the same on a second
    run."""
    h, w, b, c = x_shape
    wb = w * b
    rng = np.random.default_rng(1)
    x = rng.standard_normal(x_shape).astype(np.float32)
    gz = rng.standard_normal((h, w, b, co)).astype(np.float32)
    x3, g3 = x.reshape(h, wb, c), gz.reshape(h, wb, co)
    grid = 2
    bn = cc.tile_n(co)
    rpairs = 9 * c // 128
    per_part = -(-rpairs // 2) * (co // bn)
    steps_per_row = -(-wb // cc.STEP_PIXELS)

    def run():
        part = np.zeros((parts, 9, c, co), np.float32)
        for items in _cta_items(per_part * parts, grid):
            for q, rank in items:
                p, rp, n0, s0, s1 = cc.wgrad_item(q, rank, x_shape, co, parts)
                if rp == rpairs:
                    continue
                for rb in (2 * rp, 2 * rp + 1):
                    tap, c0 = cc.wgrad_row_block(rb)
                    ky, kx = divmod(tap, 3)
                    for k, (cb, ce) in enumerate(cc.wgrad_chains(s0, s1)):
                        acc = np.zeros((64, bn), np.float32)
                        for s in range(cb, ce):
                            hh, m0 = s // steps_per_row, s % steps_per_row * cc.STEP_PIXELS
                            xa = _box(x3, c0, m0 + (kx - 1) * b, hh + ky - 1, 64, cc.STEP_PIXELS)
                            gb = _box(g3, n0, m0, hh, bn, cc.STEP_PIXELS)
                            acc += xa.T @ gb
                        blk = part[p, tap, c0:c0 + 64, n0:n0 + bn]
                        part[p, tap, c0:c0 + 64, n0:n0 + bn] = acc if k == 0 else blk + acc
        out = part[0].copy()
        for p in range(1, parts):
            out += part[p]
        return out.reshape(3, 3, c, co)

    got = run()
    np.testing.assert_array_equal(got, run())
    want = cc.conv2d_wgrad_plain(torch.from_numpy(x), torch.from_numpy(gz)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("c,co", [(96, 128), (256, 384), (512, 512)])
def test_kernel_weights_match_jax_layout(c, co):
    """K5's bf16 weight operand is JAX's [3,3,C,co] as [9, C, co], taps in
    (ky, kx) order (MN-major); its box (n0, c0, tap) is ``w[ky, kx,
    c0:c0+64, n0:n0+64]`` with zeros past C. The fp32 operand is K-major,
    [9, co, C] (``w[ky, kx].T``): its box (c0, n0, tap) of 32 input x 128
    output channels is ``w[ky, kx, c0:c0+32, n0:n0+128].T``. For the data
    gradient, JAX's flipped, io-swapped weights (``jnp.flip(w, (0,
    1)).swapaxes(2, 3)``), and in fp32 that is the flip as it lies."""
    w = np.random.default_rng(2).standard_normal((3, 3, c, co)).astype(np.float32)
    w = torch.from_numpy(w).to(torch.bfloat16).float().numpy()  # exact in both dtypes
    got = cc.kernel_weights(torch.from_numpy(w), torch.bfloat16).float()
    assert got.is_contiguous() and tuple(got.shape) == (9, c, co)
    wj = jnp.asarray(w)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        for c0 in range(0, c, 64):
            for n0 in range(0, co, 64):
                box = _box(got[tap].numpy().T[None], c0, n0, 0, 64, 64).T
                want = np.zeros((64, 64), np.float32)
                blk = np.asarray(wj[ky, kx, c0:c0 + 64, n0:n0 + 64])
                want[:blk.shape[0], :blk.shape[1]] = blk
                np.testing.assert_array_equal(box, want)
    got = cc.kernel_weights(flip_io(torch.from_numpy(w)), torch.bfloat16).float()
    want = jnp.flip(wj, axis=(0, 1)).swapaxes(2, 3).reshape(9, co, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.is_contiguous()
    got = cc.kernel_weights(torch.from_numpy(w), torch.float32)
    assert got.is_contiguous() and tuple(got.shape) == (9, co, c)
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        for c0 in range(0, c, 32):
            for n0 in range(0, co, 128):
                box = _box(got[tap].numpy()[None], c0, n0, 0, 32, 128)
                np.testing.assert_array_equal(box, np.asarray(wj[ky, kx, c0:c0 + 32,
                                                                 n0:n0 + 128]).T)
    wf = flip_io(torch.from_numpy(w))
    got = cc.kernel_weights(wf, torch.float32)
    want = jnp.flip(wj, axis=(0, 1)).reshape(9, c, co)  # K-major for co -> C
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.is_contiguous() and got.data_ptr() == wf.data_ptr()  # the flip, not a copy


# ---------------------------------------------------------------------------
# the fp32 forms (TF32 wgmma, both operands K-major)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x_shape,co", SCHEDULE_SHAPES)
def test_conv2d_fp32_schedule_covers_every_output_once(x_shape, co):
    """K5 fp32: 128-channel tiles; for several grids the CTAs' tiles cover
    every (h, pixel, output channel) exactly once, and each tile's
    accumulator chains (``conv2d_chains``) every stage (tap, 32-channel
    chunk) exactly once, in order."""
    h, w, b, c = x_shape
    wb = w * b
    grid0, bn, tiles_per_row, pairs = cc.conv2d_plan(x_shape, co, 132, torch.float32)
    assert bn == cc.TILE_N_F32 == 128 and grid0 == 2 * min(pairs, 66)
    assert pairs == -(-h * tiles_per_row // 2) * (co // bn)
    for grid in sorted({2, grid0, 2 * pairs}):
        seen = np.zeros((h, wb, co), np.int32)
        for items in _cta_items(pairs, grid):
            for q, rank in items:
                hh, m0, n0 = cc.conv2d_tile(q, rank, x_shape, co, torch.float32)
                if hh == h:
                    assert rank == 1 and (h * tiles_per_row) % 2 == 1
                    continue
                seen[hh, m0:min(m0 + cc.TILE_M, wb), n0:n0 + bn] += 1
        assert (seen == 1).all(), (x_shape, co, grid)
    for chain in (cc.CHAIN_STAGES_F32, 2, 5, 9 * c // 32):
        chains = cc.conv2d_chains(c, chain)
        stages = [k for k0, k1 in chains for k in range(k0, k1)]
        assert stages == list(range(9 * c // 32)) and all(k1 - k0 <= chain for k0, k1 in chains)


def _cmajor_planes(x):
    """A numpy emulation of K5w fp32's pre-pass (``tf32_split_cmajor``)
    before the split: x [H, W, B, C] as channel-major [C][H][Rp], a row's
    pixel w Bp + b, zeros at b >= B and past W Bp."""
    h, w, b, c = x.shape
    bp = cc.wgrad_batch_pitch(b, torch.float32)
    rp = cc.wgrad_row_pitch(x.shape)
    xb = np.zeros((h, w, bp, c), x.dtype)
    xb[:, :, :b] = x
    out = np.zeros((c, h, rp), x.dtype)
    out[:, :, :w * bp] = xb.reshape(h, w * bp, c).transpose(2, 0, 1)
    return out


def _cmajor_box(planes, m0, hh, c0, nc=64, npx=32):
    """One TMA box of K5w fp32's map over [C][H][Rp]: channels c0 .. c0 +
    nc - 1, image row hh, pixels m0 .. m0 + npx - 1 of the padded row;
    outside the tensor, zeros. [nc, npx]."""
    c, h, rp = planes.shape
    out = np.zeros((nc, npx), planes.dtype)
    if not 0 <= hh < h:
        return out
    ms, cs = np.arange(m0, m0 + npx), np.arange(c0, c0 + nc)
    ok_m, ok_c = (ms >= 0) & (ms < rp), cs < c
    out[np.ix_(ok_c, ok_m)] = planes[np.ix_(cs[ok_c], [hh], ms[ok_m])][:, 0]
    return out


@pytest.mark.parametrize("x_shape", [(5, 6, 3, 128), (4, 10, 5, 256), (3, 16, 8, 128),
                                     (6, 9, 2, 128), (2, 40, 4, 128)])
def test_cmajor_box_gather_is_the_plain_shifted_tap(x_shape):
    """K5w fp32: for every step (32 pixels of one padded row), tap (ky, kx)
    and 64-channel block, the box of x's channel-major planes at (m0 + (kx
    - 1) Bp, h + ky - 1, c0) is the plain version's shifted tap ``xpad[h +
    ky, w + kx, b]`` at the step's pixels (w < W, b < B): the zeros of the
    padding and of the map's edges are the SAME halo. At the step's other
    pixels (padded batch entries, past W Bp) the cotangent's box is zero,
    so their products vanish. The shift (kx - 1) Bp falls on 16 bytes."""
    h, w, b, c = x_shape
    bp = cc.wgrad_batch_pitch(b, torch.float32)
    assert bp % 4 == 0 and bp >= b and cc.wgrad_row_pitch(x_shape) % 32 == 0
    x = np.random.default_rng(3).standard_normal(x_shape).astype(np.float32)
    gz = np.random.default_rng(4).standard_normal(x_shape).astype(np.float32)
    planes, gplanes = _cmajor_planes(x), _cmajor_planes(gz)
    taps = [t.numpy() for t in cc._taps(torch.from_numpy(x))]  # [H, W, B, C] each
    steps_per_row = cc.wgrad_steps(x_shape, torch.float32) // h
    assert steps_per_row == -(-(w * bp) // cc.STEP_PIXELS_F32)
    for s in range(cc.wgrad_steps(x_shape, torch.float32)):
        hh, m0 = s // steps_per_row, s % steps_per_row * cc.STEP_PIXELS_F32
        px = np.arange(m0, m0 + cc.STEP_PIXELS_F32)
        ww, bb = px // bp, px % bp
        real = (ww < w) & (bb < b)
        for c0 in range(0, c, 64):
            g = _cmajor_box(gplanes, m0, hh, c0)
            assert not g[:, ~real].any()
            np.testing.assert_array_equal(g[:, real], gz[hh, ww[real], bb[real], c0:c0 + 64].T)
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                got = _cmajor_box(planes, m0 + (kx - 1) * bp, hh + ky - 1, c0)
                np.testing.assert_array_equal(got[:, real],
                                              taps[tap][hh, ww[real], bb[real], c0:c0 + 64].T)


@pytest.mark.parametrize("x_shape,co", WGRAD_SHAPES + [((64, 64, 8, 1024), 1024),
                                                      ((64, 64, 8, 512), 512),
                                                      ((9, 9, 3, 128), 128)])
def test_wgrad_fp32_plan_covers_every_step_once(x_shape, co):
    """K5w fp32 on a 132-SM card: the clusters take every item once; each
    part's items write every [9 C, co] sum of its partial once; and every
    (tap, channel block, output tile, pixel step) is summed exactly once
    over the parts' chains, each chain at most MAX_CHAIN_STEPS_F32 steps;
    the scratch planes and the workspace as the wrapper allocates them."""
    h, w, b, c = x_shape
    dt = torch.float32
    parts, grid = cc.wgrad_plan(dt, x_shape, co, 132)
    bn = cc.tile_n(co)
    rpairs = 9 * c // 128
    per_part = -(-rpairs // 2) * (co // bn)
    steps = cc.wgrad_steps(x_shape, dt)
    assert 1 <= parts <= steps and grid == 2 * min(66, per_part * parts)
    assert parts == 1 or parts * 9 * c * co * 4 <= cc.MAX_PART_BYTES
    taken = sorted(i for items in _cta_items(per_part * parts, grid) for i in items)
    assert taken == sorted((q, r) for q in range(per_part * parts) for r in (0, 1))
    written = np.zeros((parts, 9, c // 64, co // bn), np.int32)
    summed = np.zeros((9, c // 64, co // bn, steps), np.int32)
    for q, rank in taken:
        p, rp, n0, s0, s1 = cc.wgrad_item(q, rank, x_shape, co, parts, dt)
        if rp == rpairs:
            continue
        chains = cc.wgrad_chains(s0, s1, dt)
        assert all(0 < e - s <= cc.MAX_CHAIN_STEPS_F32 for s, e in chains)
        for rb in (2 * rp, 2 * rp + 1):
            tap, c0 = cc.wgrad_row_block(rb)
            written[p, tap, c0 // 64, n0 // bn] += 1
            for cb, ce in chains:
                summed[tap, c0 // 64, n0 // bn, cb:ce] += 1
    assert (written == 1).all() and (summed == 1).all()
    rp_ = cc.wgrad_row_pitch(x_shape)
    assert cc.split_floats(x_shape, co, "wgrad") == 2 * (c + co) * h * rp_
    assert cc.split_floats(x_shape, co, "conv2d") == 2 * (h * w * b * c + 9 * co * c)


BLOCK_SMEM = 232448  # shared memory one CTA may use on an H100


def _tf32_constants(name):
    src = (Path(cc.__file__).parents[1] / "csrc" / f"{name}.cu").read_text()
    tf = src[src.index("namespace tf {"):]
    return {n: int(re.search(rf"constexpr int {n} = (\d+);", tf)[1])
            for n in ("BN", "BK", "BKP", "STAGES") if re.search(rf"constexpr int {n} = \d+;", tf)}


def test_tf32_kernel_constants_and_shared_memory():
    """The fp32 kernels' compiled constants are the plan's (K5: 128-channel
    tiles of 128 pixels, 32-channel stages; K5w: 32-pixel steps), and each
    kernel's shared memory (1,024 bytes of alignment, STAGES stages of its
    boxes, two mbarriers a stage) fits a CTA: K5 three stages of both
    planes' activation and weight boxes, K5w two stages at 256 output
    channels and three at 128, of both planes' boxes of its two row blocks
    and its BN cotangent rows."""
    k5, k5w = _tf32_constants("conv2d"), _tf32_constants("conv2d_wgrad")
    assert (k5["BN"], k5["BK"]) == (cc.TILE_N_F32, 32) and k5w["BKP"] == cc.STEP_PIXELS_F32
    stage = 2 * cc.TILE_M * k5["BK"] * 4 + 2 * k5["BN"] * k5["BK"] * 4
    smem = 1024 + k5["STAGES"] * stage + 2 * k5["STAGES"] * 8
    assert stage == 64 << 10 and smem == 197680 <= BLOCK_SMEM
    src = (Path(cc.__file__).parents[1] / "csrc" / "conv2d_wgrad.cu").read_text()
    assert "STAGES = TN == 256 ? 2 : 3;" in src[src.index("namespace tf {"):]
    box = 64 * k5w["BKP"] * 4
    for tn, stages in ((256, 2), (128, 3)):
        stage = 4 * box + 2 * (tn // 64) * box
        assert 1024 + stages * stage + 2 * stages * 8 <= BLOCK_SMEM
