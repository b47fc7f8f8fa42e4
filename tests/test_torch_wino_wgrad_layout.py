"""The host side and the arithmetic of K6's kernels, on the CPU.

K6 (``csrc/winograd_wgrad.cu``) writes V ``[P, 16, T, C]`` (K3's input
transform) and dM ``[P, 16, T, K]`` (the cotangent spread) in bf16, as one
plane or, for fp32 products, as hi / lo planes; then a persistent wgmma GEMM
whose clusters walk work items (part of T, frequency, pair of 128-channel C
blocks, output tile) forms ``gU[f] = V[f]^T dM[f]`` in fp32 chains of at
most 8,192 tiles, and a last kernel adds the parts in order and folds gU
through G. The GEMM reads its schedule from the table that
``cuda_winograd.wino_wgrad_table`` builds (``wino_wgrad_plan``,
``wino_wgrad_item``, ``wino_wgrad_chains``); these tests decode that table
as the kernel does.

They hold the schedule to covering every (frequency, C block, output tile)
over all of T exactly once, the plan to its parts, chains and workspace,
the kernel's compiled constants to the plan's, a numpy emulation of the spread to the plain version's dM, the
split products to a stated bound of the float64 product, and a numpy
emulation of the whole summation order to ``wino_wgrad_plain`` within
``chip_smoke.WGRAD_TOL`` (1e-4 of max|gw|).
"""
from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

from rendernet_tpu_torch.ops import cuda_winograd as cw
from rendernet_tpu_torch.ops.winograd import cotangent_spread, input_transform, wino_wgrad_plain

WGRAD_TOL = 1e-4  # chip_smoke.WGRAD_TOL: K6 against its plain version, of max|gw|

# Every batch 8-24 at which the envelope admits the training step's res2 and
# res3 convs in either dtype, and the ragged shape (T = 840, not a multiple
# of either step's tiles; C = 256, one pair of C blocks; K = 128).
_TRAIN = [((b, 64, 64, c), c) for c in (1024, 512) for b in range(8, 25)
          if any(cw.wino_conv2d_supported((b, 64, 64, c), (3, 3, c, c), (1, 1), d)
                 for d in (torch.float32, torch.bfloat16))]
SCHEDULE_SHAPES = _TRAIN + [((8, 6, 70, 256), 128), ((8, 6, 70, 384), 384)]


def _cta_items(n_items, grid):
    """CTA j's (item, rank): CTA j is rank j % 2 of cluster j // 2, which
    takes items j // 2, j // 2 + grid / 2, ..."""
    return [[(q, j % 2) for q in range(j // 2, n_items, grid // 2)] for j in range(grid)]


def _n_items(x_shape, k, parts):
    c = x_shape[-1]
    return parts * 16 * -(-(c // cw.WGRAD_C_BLOCK) // 2) * (k // cw.tile_n(k))


def _decode(table, n, q, rank):
    """Item q of the table as CTA ``rank`` of a cluster reads it in
    ``k6_gemm`` (``item_of``): ``(part, frequency, C block, n0, [(first
    step, end step) per chain])``."""
    p, f, cp, n0, c0, c1 = table[cw.WGRAD_ITEM_INTS * q:cw.WGRAD_ITEM_INTS * (q + 1)]
    base = cw.WGRAD_ITEM_INTS * n
    return p, f, 2 * cp + rank, n0, [tuple(table[base + 2 * j:base + 2 * j + 2])
                                     for j in range(c0, c1)]


def _table(x_shape, k, split, parts):
    table = cw.wino_wgrad_table(tuple(x_shape), k, split, parts)
    n = _n_items(x_shape, k, parts)
    return n, [[_decode(table, n, q, r) for r in (0, 1)] for q in range(n)]


def test_kernel_constants_match_the_plan():
    """The constants compiled into ``k6_gemm`` that the table's meaning
    rests on: a row's ints, the C block, and a step's tiles in each form
    (which the C entry also checks against the wrapper's at each call)."""
    src = (pathlib.Path(cw.__file__).parents[1] / "csrc" / "winograd_wgrad.cu").read_text()
    assert int(re.search(r"constexpr int ITEM_INTS = (\d+);", src)[1]) == cw.WGRAD_ITEM_INTS
    assert int(re.search(r"constexpr int CB = (\d+);", src)[1]) == cw.WGRAD_C_BLOCK
    split_bkp, bkp = map(int, re.search(r"int BKP = SPLIT \? (\d+) : (\d+);", src).groups())
    assert (split_bkp, bkp) == (cw._step_tiles(True), cw._step_tiles(False))


@pytest.mark.parametrize("x_shape,k", SCHEDULE_SHAPES)
def test_wino_wgrad_schedule_covers_every_sum_once(x_shape, k):
    """In both operand forms and for several grids, decoding the table the
    kernel reads: every (part, frequency, C block, output tile) is taken
    once by one cluster, both CTAs of a cluster share part, frequency,
    chains and output tile, each item's chains run in order with at most
    MAX_CHAIN_TILES tiles each, and the parts' step ranges tile [0, S), so
    every (frequency, C block, output tile) sums all of T exactly once; an
    odd count of C blocks leaves one partner CTA with channels past C."""
    c = x_shape[-1]
    cblocks, bn = c // cw.WGRAD_C_BLOCK, cw.tile_n(k)
    for split in (False, True):
        parts, grid0 = cw.wino_wgrad_plan(x_shape, k, split, 132)
        steps = cw.wino_wgrad_steps(x_shape, split)
        max_steps = cw.MAX_CHAIN_TILES // cw._step_tiles(split)
        n, items = _table(x_shape, k, split, parts)
        assert 1 <= parts <= steps and grid0 == 2 * min(66, n)
        for grid in sorted({2, 8, grid0}):
            taken = sorted(i for cta in _cta_items(n, grid) for i in cta)
            assert taken == [(q, r) for q in range(n) for r in (0, 1)]
        seen = {}
        for (p, f, cb0, n0, chains), other in items:
            assert other == (p, f, cb0 + 1, n0, chains) and cb0 % 2 == 0
            assert 0 <= f < 16 and n0 % bn == 0 and 0 <= p < parts and chains
            assert all(a[1] == b[0] for a, b in zip(chains, chains[1:]))
            assert all(0 < e - s <= max_steps for s, e in chains)
            s0, s1 = chains[0][0], chains[-1][1]
            assert 0 <= s0 < s1 <= steps
            for cb in (cb0, cb0 + 1):
                if cb >= cblocks:  # the partner of an odd last C block
                    assert cb == cblocks and cblocks % 2 == 1
                    continue
                seen.setdefault((f, cb, n0), []).append((p, s0, s1))
        assert len(seen) == 16 * cblocks * (k // bn)
        for ranges in seen.values():
            ranges.sort()
            assert [r[0] for r in ranges] == list(range(parts))
            assert ranges[0][1] == 0 and ranges[-1][2] == steps
            assert all(a[2] == b[1] for a, b in zip(ranges, ranges[1:]))
        if parts == 1:  # the clusters at work at once hold the tiles of a few frequencies
            first = [items[q][0][1] for q in range(min(n, grid0 // 2))]
            assert first == sorted(first)
            assert len(set(first)) <= -(-(grid0 // 2) // (n // 16)) + 1


@pytest.mark.parametrize("split", [False, True])
def test_wino_wgrad_plan_at_the_training_shapes(split):
    """The res2 / res3 training shapes at batch 24 on a 132-SM card: one part
    (its 64 MB workspace under the 512 MiB cap), every cluster busy at res2
    (256 items on 66 clusters), 64 of 66 at res3; chains of at most 8,192
    tiles that tile each item's steps; the scratch the WGRAD steps allocate
    per call."""
    for c, items in ((1024, 256), (512, 64)):
        x_shape = (24, 64, 64, c)
        parts, grid = cw.wino_wgrad_plan(x_shape, c, split, 132)
        assert (parts, grid) == (1, 2 * min(66, items))
        assert _n_items(x_shape, c, parts) == items
        steps = cw.wino_wgrad_steps(x_shape, split)
        assert steps == 24 * 32 * 32 // (32 if split else 64)
        n, decoded = _table(x_shape, c, split, parts)
        table = cw.wino_wgrad_table(x_shape, c, split, parts)
        assert len(table) == cw.WGRAD_ITEM_INTS * n + 2 * 3 * n
        for (_, _, _, _, chains), _ in decoded:
            assert len(chains) == 3 and chains[0][0] == 0 and chains[-1][1] == steps
            assert all(a[1] == b[0] for a, b in zip(chains, chains[1:]))
            assert all((e - s) * (32 if split else 64) <= cw.MAX_CHAIN_TILES
                       for s, e in chains)
        planes = 2 if split else 1
        assert cw.wgrad_scratch_bytes(x_shape, c, torch.bfloat16, split, 132) == \
            planes * 16 * 24576 * 2 * c * 2 + 16 * c * c * 4
    assert cw.wgrad_split(torch.float32, False) and not cw.wgrad_split(torch.bfloat16, False)
    assert cw.wgrad_split(torch.bfloat16, True)


def test_wino_wgrad_plan_caps_the_workspace():
    """Where a small T leaves clusters idle the plan cuts T into parts, never
    beyond the steps or the workspace cap."""
    for x_shape, k in ((8, 6, 70, 256), 128), ((8, 8, 8, 2048), 2048), ((16, 16, 16, 256), 256):
        for split in (False, True):
            parts, grid = cw.wino_wgrad_plan(x_shape, k, split, 132)
            assert parts <= cw.wino_wgrad_steps(x_shape, split)
            assert parts == 1 or parts * 16 * x_shape[-1] * k * 4 <= cw.MAX_PART_BYTES
            assert grid == 2 * min(66, _n_items(x_shape, k, parts)) and grid % 2 == 0
    assert cw.wino_wgrad_plan((8, 6, 70, 256), 128, False, 132)[0] > 1


def _bf16(a):
    """numpy float32 -> the nearest bf16 (ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(torch.bfloat16).float().numpy()


_AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cotangent_spread_emulated(dtype):
    """A numpy emulation of the spread kernel (``k6_spread``): tile t in K3's
    order (b, th, tw), frequency 4 k1 + k2, the non-zero terms A[p1, k1]
    A[p2, k2] gy[b, 2 th + p1, 2 tw + p2] summed in fp32, (p1, p2) in order,
    rounded once: bit for bit the plain version's dM."""
    b, h, w, k = 3, 6, 10, 16
    gy = np.random.default_rng(3).standard_normal((b, h, w, k)).astype(np.float32)
    gy = torch.from_numpy(gy).to(dtype).float().numpy()
    nh, nw = h // 2, w // 2
    dm = np.zeros((16, b * nh * nw, k), np.float32)
    for bb in range(b):
        for th in range(nh):
            for tw in range(nw):
                t = (bb * nh + th) * nw + tw
                for k1 in range(4):
                    for k2 in range(4):
                        s = None
                        for p1 in range(2):
                            for p2 in range(2):
                                a = _AT[p1, k1] * _AT[p2, k2]
                                if a:
                                    term = gy[bb, 2 * th + p1, 2 * tw + p2] * np.float32(a)
                                    s = term if s is None else (s + term).astype(np.float32)
                        dm[4 * k1 + k2, t] = s
    want = cotangent_spread(torch.from_numpy(gy).to(dtype), dtype).float().numpy()
    got = dm if dtype == torch.float32 else _bf16(dm)
    np.testing.assert_array_equal(got, want)


def _split(a):
    hi = _bf16(a)
    return hi, _bf16(a - hi)


def test_split_products_bound():
    """The split form's three bf16 products, hi.hi + hi.lo + lo.hi, against
    the float64 product at the check shape's operands (V and dM of a
    [8, 6, 70, 256] -> 128 conv): each product within 3 x 2^-16 of |a b|
    (the dropped lo.lo and each plane's rounding), the whole gU within that
    bound of sum |v| |dm| and within a tenth of WGRAD_TOL of max|gU|
    (4.6e-6 of it here)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((8, 6, 70, 256)).astype(np.float32))
    gy = torch.from_numpy(rng.standard_normal((8, 6, 70, 128)).astype(np.float32))
    v = input_transform(x, torch.float32).numpy()
    dm = cotangent_spread(gy, torch.float32).numpy()
    bound = 3 * 2.0 ** -16
    a, bq = v[5, :64, :64].ravel(), dm[5, :64, :64].ravel()
    (ah, al), (bh, bl) = _split(a), _split(bq)
    got = ah.astype(np.float64) * bh + ah.astype(np.float64) * bl + al.astype(np.float64) * bh
    exact = a.astype(np.float64) * bq
    assert (np.abs(got - exact) <= bound * np.abs(exact)).all()
    for f in (0, 5, 10, 15):
        (vh, vl), (dh, dl) = _split(v[f]), _split(dm[f])
        vh, vl, dh, dl = (z.astype(np.float64) for z in (vh, vl, dh, dl))
        gu = vh.T @ dh + vh.T @ dl + vl.T @ dh
        exact = v[f].astype(np.float64).T @ dm[f].astype(np.float64)
        mag = np.abs(v[f]).astype(np.float64).T @ np.abs(dm[f]).astype(np.float64)
        assert (np.abs(gu - exact) <= bound * mag).all()
        assert np.abs(gu - exact).max() <= 0.1 * WGRAD_TOL * np.abs(exact).max()


def _fold(u):
    """The fold kernel's G^T gU G, in fp32, in its order."""
    u = u.reshape(4, 4, *u.shape[1:])
    h = np.float32(0.5)
    t = [[(u[a, 0] + h * u[a, 1]) + h * u[a, 2], h * u[a, 1] - h * u[a, 2],
          (h * u[a, 1] + h * u[a, 2]) + u[a, 3]] for a in range(4)]
    rows = [[(t[0][s] + h * t[1][s]) + h * t[2][s], h * t[1][s] - h * t[2][s],
             (h * t[1][s] + h * t[2][s]) + t[3][s]] for s in range(3)]
    return np.stack([np.stack([rows[s][r] for s in range(3)]) for r in range(3)])


@pytest.mark.parametrize("x_shape,k,dtype,split,parts", [
    ((8, 6, 70, 256), 128, torch.bfloat16, False, None),
    ((8, 6, 70, 256), 128, torch.bfloat16, True, 3),
    ((8, 6, 70, 384), 128, torch.float32, True, None),
    ((16, 64, 34, 256), 128, torch.bfloat16, False, 1)])
def test_wino_wgrad_order_emulated(x_shape, k, dtype, split, parts):
    """A numpy emulation of K6's schedule, decoded from its table as the
    kernel decodes it, on one cluster: the operands as
    the transforms write them (one bf16 plane, or hi / lo planes), each
    item's boxes (zero past T and past C), fp32 chains that store then
    add, the three products of the split form, the parts added in order and
    the fold. With several parts, with an odd count of C blocks (384), and
    with one part of two chains (8,704 tiles): equal to the plain version
    within WGRAD_TOL, and bit for bit the same on a second run."""
    b, h, w, c = x_shape
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32)).to(dtype)
    gy = torch.from_numpy(rng.standard_normal((b, h, w, k)).astype(np.float32)).to(dtype)
    opdt = torch.float32 if split else dtype
    v = input_transform(x, opdt).float().numpy()
    dm = cotangent_spread(gy, opdt).float().numpy()
    planes = [_split(v), _split(dm)] if split else [(v,), (dm,)]
    t_all = v.shape[1]
    if parts is None:
        parts = cw.wino_wgrad_plan(x_shape, k, split, 132)[0]
    bkp = 32 if split else 64
    bn = cw.tile_n(k)
    n, items = _table(x_shape, k, split, parts)

    def box(a, f, t0, c0, width):
        out = np.zeros((bkp, width), np.float32)
        blk = a[f, t0:t0 + bkp, c0:c0 + width]
        out[:blk.shape[0], :blk.shape[1]] = blk
        return out

    def run():
        part = np.zeros((parts, 16, c, k), np.float32)
        for q in range(n):
            for rank in (0, 1):
                p, f, cb, n0, chains = items[q][rank]
                c0 = cb * cw.WGRAD_C_BLOCK
                for ci, (cs, ce) in enumerate(chains):
                    acc = np.zeros((cw.WGRAD_C_BLOCK, bn), np.float32)
                    for s in range(cs, ce):
                        a = [box(pl, f, s * bkp, c0, cw.WGRAD_C_BLOCK) for pl in planes[0]]
                        d = [box(pl, f, s * bkp, n0, bn) for pl in planes[1]]
                        acc += a[0].T @ d[0]
                        if split:
                            acc += a[0].T @ d[1]
                            acc += a[1].T @ d[0]
                    if c0 >= c:
                        continue
                    blk = part[p, f, c0:c0 + cw.WGRAD_C_BLOCK, n0:n0 + bn]
                    part[p, f, c0:c0 + cw.WGRAD_C_BLOCK, n0:n0 + bn] = acc if ci == 0 else blk + acc
        gu = part[0].copy()
        for p in range(1, parts):
            gu += part[p]
        return _fold(gu)

    assert t_all % bkp or x_shape[0] == 16
    got = run()
    np.testing.assert_array_equal(got, run())
    want = wino_wgrad_plain(x, gy, split).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=WGRAD_TOL * np.abs(want).max())
