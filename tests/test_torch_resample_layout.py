"""The launch plan and tile walk of K1 and K4, on the CPU.

K1 (``csrc/resample.cu``) and K4 (``csrc/resample_bwd.cu``) are persistent
kernels over tiles of whole rows of one bc; ``cuda_resample.pass_plan``
chooses rows per tile, ring stages, grid, path and shared bytes, and the
kernels decode it (``csrc/resample_tile.cuh``: tile -> (bc, first row,
rows); a thread's (row, lane) walk in steps of PASS_THREADS, carried
without division). These tests decode the plan as the kernels do: every
(bc, row) and every element of a tile is covered exactly once, shared memory
fits, the bulk path is taken exactly where rows are whole 16-byte vectors,
and a numpy float32 emulation of the kernels' tile walk and arithmetic
equals the plain versions bit for bit (the kernels' contract).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from rendernet_tpu_torch.ops import cuda_resample
from rendernet_tpu_torch.ops.cuda_resample import pass_plan

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# (BC, R, L, out_lanes, adjoint) of every K1 and K4 row of chip_smoke.py,
# then ragged R and lanes.
SMOKE = sorted({(*spec[:4], op == "pass_bwd") for kid, _, op, spec, _, _ in chip_smoke.CASES
                if kid in ("K1", "K4")})
RAGGED = [(2, 1000, 100, 37, a) for a in (False, True)] + [
    (3, 77, 128, 64, a) for a in (False, True)] + [(1, 5, 24, 24, a) for a in (False, True)] + [
    (2, 40, 6144, 6144, a) for a in (False, True)]
DTYPES = (torch.float32, torch.bfloat16)
SMS = (132, 7)


def _tiles(plan, r):
    """(bc, first row, rows) of every tile, as ``tile_at`` decodes them, in
    the order the CTAs walk them (CTA i: tiles i, i + grid, ...)."""
    out = []
    for cta in range(plan.grid):
        for tile in range(cta, plan.tiles, plan.grid):
            bc, blk = divmod(tile, plan.tiles_per_bc)
            r0 = blk * plan.rows
            out.append((bc, r0, min(plan.rows, r - r0)))
    return out


def _walk(nrows, width, threads=cuda_resample.PASS_THREADS):
    """(rr, lane) of every element a tile's threads visit, as ``Walk``
    carries them: thread t starts at divmod(t, width) and steps by
    divmod(threads, width) with a carry, while rr < nrows."""
    step_r, step_l = divmod(threads, width)
    rr, lane = np.divmod(np.arange(threads), width)
    seen = []
    while True:
        live = rr < nrows
        if not live.any():
            break
        seen.append(np.stack([rr[live], lane[live]], -1))
        lane = lane + step_l
        rr = rr + step_r
        carry = lane >= width
        lane = np.where(carry, lane - width, lane)
        rr = np.where(carry, rr + 1, rr)
    return np.concatenate(seen) if seen else np.zeros((0, 2), np.int64)


@pytest.mark.parametrize("shape", SMOKE + RAGGED)
def test_plan_covers_every_row_once_and_fits(shape):
    """The CTAs' walks take every tile once, the tiles cover every (bc, row)
    once, and every CTA of the grid fits on its SM at once (persistent)."""
    bc, r, lanes, ol, adjoint = shape
    for dtype in DTYPES:
        for sms in SMS:
            plan = pass_plan(bc, r, lanes, ol, dtype, sms, adjoint)
            assert 1 <= plan.grid <= plan.tiles
            assert plan.smem <= cuda_resample.SMEM_PER_CTA
            per_sm = -(-plan.grid // sms)
            threads = (cuda_resample.PASS_BULK_THREADS if plan.path == "bulk"
                       else cuda_resample.PASS_THREADS)
            assert per_sm * (plan.smem + 1024) <= cuda_resample.SMEM_PER_SM
            assert per_sm * threads <= 2048
            walked = np.concatenate([np.arange(c, plan.tiles, plan.grid)
                                     for c in range(plan.grid)])
            assert np.array_equal(np.sort(walked), np.arange(plan.tiles))
            b, blk = np.divmod(walked, plan.tiles_per_bc)
            r0 = blk * plan.rows
            n = np.minimum(plan.rows, r - r0)
            assert (n >= 1).all() and (b < bc).all()
            count = np.zeros(bc * r + 1, np.int64)  # difference array over bc * R rows
            np.add.at(count, b * r + r0, 1)
            np.add.at(count, b * r + r0 + n, -1)
            assert (np.cumsum(count)[:-1] == 1).all()


@pytest.mark.parametrize("width", [128, 64, 37, 100, 256, 300, 1, 24])
@pytest.mark.parametrize("nrows", [1, 3, 8, 32, 59])
def test_thread_walk_covers_each_element_once(width, nrows):
    seen = _walk(nrows, width)
    j = seen[:, 0] * width + seen[:, 1]
    assert (seen[:, 1] < width).all()
    assert np.array_equal(np.sort(j), np.arange(nrows * width))


def test_bulk_path_exactly_where_rows_are_whole_vectors():
    for dtype, item in ((torch.float32, 4), (torch.bfloat16, 2)):
        for lanes in (8, 12, 16, 24, 36, 37, 64, 100, 128):
            for ol in sorted({1, 4, 8, 9, 16, 37, 64, lanes}):
                if ol > lanes:
                    continue
                for adjoint in (False, True):
                    plan = pass_plan(3, 50, lanes, ol, dtype, 132, adjoint)
                    whole = (lanes * item) % 16 == 0 and (ol * item) % 16 == 0
                    assert plan.path == ("bulk" if whole else "scalar")
                    assert plan.stages == (cuda_resample.PASS_STAGES if whole else 1)
                    if whole:  # every tile's first value of v, g, out, gv, gp is 16-byte aligned
                        for b, r0, _ in _tiles(plan, 50):
                            for width, size in ((lanes, item), (ol, item), (ol, 4)):
                                assert ((b * 50 + r0) * width * size) % 16 == 0


# --- numpy emulation of the kernels' arithmetic over the plan's tile walk ---
f32 = np.float32


def _params(rng, bc, lanes, sign):
    u = rng.uniform(-1, 1, (bc, 4)).astype(f32)
    alpha = sign * (1 + 0.4 * u[:, 0])
    delta = 20 * u[:, 3] if sign > 0 else lanes - 1 - 20 * u[:, 3]
    return np.stack([alpha, 0.4 * u[:, 1], 0.4 * u[:, 2], delta], -1).astype(f32)


def _row_offsets(p, r0, n, db):
    """``row_offsets``: o_row of rows r0.. of a tile, fp32, in the order."""
    rows = np.arange(r0, r0 + n)
    d_a, d_b = (rows // db).astype(f32), (rows % db).astype(f32)
    return (p[1] * d_a + p[2] * d_b) + p[3]


PAD = cuda_resample.PASS_PAD


def _padded(row):
    """A staged input row: PASS_PAD zeros on each side (``kPad``)."""
    return np.concatenate([np.zeros(PAD, f32), row, np.zeros(PAD, f32)])


def _taps(v, al, lane, o_row):
    """The two-tap read of K1 and of K4's gp: (w, v0, v1). The floor index
    is clamped to [-2, L] and both taps read the padded row, so a tap
    outside the row reads a zero of the padding."""
    lanes = v.shape[-1]
    pos = al * lane.astype(f32) + o_row
    i0f = np.floor(pos)
    i0 = np.clip(i0f, -2, lanes).astype(np.int64) + PAD
    row = _padded(v)
    return pos - i0f, row[i0], row[i0 + 1]


def emulate_k1(vol, params, db, ol, plan):
    """K1 as the kernel computes it, tile by tile and thread walk by walk."""
    bc, r, lanes = vol.shape
    out = np.full((bc, r, ol), np.nan, f32)
    for b, r0, n in _tiles(plan, r):
        p = params[b]
        o = _row_offsets(p, r0, n, db)
        rr, lane = _walk(n, ol).T
        for k in range(n):
            sel = rr == k
            w, g0, g1 = _taps(vol[b, r0 + k], p[0], lane[sel], o[k])
            out[b, r0 + k, lane[sel]] = (f32(1) - w) * g0 + w * g1
    return out


def emulate_k4(vol, params, g, db, taps, plan):
    """K4 as the kernel computes it: gv (fp32, before the store's rounding)
    and gp, tile by tile and thread walk by walk. With at most PASS_PAD - 1
    taps (the kernel's compiled bands) a tap outside the window reads a zero
    of the padded g row and adds its zero product; wider bands check the
    window."""
    bc, r, lanes = vol.shape
    ol = g.shape[-1]
    gv = np.full((bc, r, lanes), np.nan, f32)
    gp = np.full((bc, r, ol), np.nan, f32)
    for b, r0, n in _tiles(plan, r):
        p = params[b]
        al, inv_al = p[0], f32(1) / p[0]
        o = _row_offsets(p, r0, n, db)
        rr, lane = _walk(n, lanes).T
        for k in range(n):
            i = lane[rr == k]
            li = i.astype(f32)
            b1 = ((li - f32(1)) - o[k]) * inv_al
            b2 = ((li + f32(1)) - o[k]) * inv_al
            l0f = np.minimum(np.maximum(np.ceil(np.minimum(b1, b2)), f32(-taps - 1)), f32(ol))
            grow = _padded(g[b, r0 + k])
            acc = np.zeros(i.shape, f32)
            for t in range(taps):  # in order, adding where the weight is positive
                lt = (l0f + f32(t)).astype(np.int64)
                wgt = f32(1) - np.abs((al * (l0f + f32(t)) + o[k]) - li)
                use = wgt > 0
                if taps >= PAD:
                    use &= (lt >= 0) & (lt < ol)
                gl = grow[np.clip(lt + PAD, 0, ol + 2 * PAD - 1)]
                acc = np.where(use, acc + wgt * gl, acc)
            gv[b, r0 + k, i] = acc
        rr, lane = _walk(n, ol).T
        for k in range(n):
            lo = lane[rr == k]
            _, v0, v1 = _taps(vol[b, r0 + k], al, lo, o[k])
            gp[b, r0 + k, lo] = g[b, r0 + k][lo] * (v1 - v0)
    return gv, gp


# (BC, R, L, out_lanes, db, taps, alpha sign): full rows, a window, the
# ragged shape (scalar path), alpha < 0 (a folded quarter-turn flip), edge
# tiles (R not a multiple of rows per tile), a band wider than the padding.
EMULATED = [(2, 60, 32, 32, 6, 3, 1), (2, 60, 32, 16, 10, 6, 1), (3, 42, 20, 7, 6, 4, -1),
            (2, 90, 32, 32, 9, 3, -1), (1, 33, 64, 64, 11, 6, 1), (2, 51, 24, 24, 17, 6, -1),
            (2, 40, 16, 16, 8, 9, 1)]


@pytest.mark.parametrize("case", EMULATED)
@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_kernels_equal_plain_versions(case, dtype, monkeypatch):
    """Small stages and one CTA per SM on a 2-SM card, so that each CTA walks
    several tiles and most cases end a bc on a shorter tile."""
    bc, r, lanes, ol, db, taps, sign = case
    monkeypatch.setattr(cuda_resample, "STAGE_BYTES", {False: 1024, True: 1024})
    monkeypatch.setattr(cuda_resample, "MAX_CTAS_PER_SM", 1)
    plan_of = cuda_resample.pass_plan.__wrapped__  # uncached: reads the patched sizes
    rng = np.random.default_rng([abs(x) for x in case])
    vol = torch.from_numpy(rng.standard_normal((bc, r, lanes)).astype(f32)).to(dtype)
    g = torch.from_numpy(rng.standard_normal((bc, r, ol)).astype(f32)).to(dtype)
    params = _params(rng, bc, lanes, sign)
    tp = torch.from_numpy(params)
    v32, g32 = vol.float().numpy(), g.float().numpy()

    plan = plan_of(bc, r, lanes, ol, dtype, 2)
    assert plan.tiles > plan.grid == 2
    got = torch.from_numpy(emulate_k1(v32, params, db, ol, plan)).to(dtype)
    want = cuda_resample.interp_pass_plain(vol, tp, db, ol)
    assert torch.equal(got, want)

    plan = plan_of(bc, r, lanes, ol, dtype, 2, adjoint=True)
    assert plan.tiles > plan.grid == 2
    gv, gp = emulate_k4(v32, params, g32, db, taps, plan)
    want_gv, want_gp = cuda_resample.interp_pass_bwd_plain(vol, tp, g, db, taps, ol)
    assert torch.equal(torch.from_numpy(gv).to(dtype), want_gv)
    assert torch.equal(torch.from_numpy(gp), want_gp)


def test_edge_tiles_in_the_emulated_cases(monkeypatch):
    """In each kernel and dtype, some emulated case ends each bc on a
    shorter tile."""
    monkeypatch.setattr(cuda_resample, "STAGE_BYTES", {False: 1024, True: 1024})
    for dtype in DTYPES:
        for adjoint in (False, True):
            plans = [cuda_resample.pass_plan.__wrapped__(bc, r, lanes, ol, dtype, 2, adjoint)
                     for bc, r, lanes, ol, *_ in EMULATED]
            assert any(r % p.rows for (_, r, *_), p in zip(EMULATED, plans))
