"""The arithmetic and the host side of K3's, K2's, K5's and K5w's fp32
forms, on the CPU.

Both kernels run fp32 products on the TF32 tensor cores as three passes:
each operand a is split into hi = tf32(a) (to nearest, ties away from zero,
10 stored mantissa bits: ``cvt.rna.tf32.f32``) and lo = tf32(a - hi), and
hi.hi + hi.lo + lo.hi go into one fp32 sum (K3 on wgmma, its V split in
registers and U split by its weight transform; K2 on mma.sync, both split
in registers). A numpy emulation of that split holds every product to
within 3 x 2^-22 (1 + 2^-10) of |a b| (the dropped lo.lo and both
remainders' rounding; the 2^-10 covers lo's size past 2^-11 |a|), the 16
GEMMs of a Winograd conv and the 27-tap GEMM of a 3-D conv to that bound of
their sums of |a| |b|, and one whole emulated conv of each kind to a tenth
of ``chip_smoke.KERNEL_TOL["float32"]`` (1e-4 of max|y|) of the port's
plain version and of JAX's function. K2's fp32 plan is held to covering
every position once on its 4-wide rows, and its shared memory, from the
kernel's compiled constants, to what a CTA may use. K5 and K5w (the fused
wide conv and its weight gradient) read both operands' splits from
shared memory (a pre-pass writes them as planes) and restart their
accumulator chains (K5 every 32-channel stage, summed in fp32; K5w every
MAX_CHAIN_STEPS_F32 steps of 32 pixels, added into its partial): an
emulation of each as built, chains and order included, stays within BOUND
of each chain's sum of |a| |b| and within a tenth of KERNEL_TOL of the
plain versions and of JAX's Pallas kernels (interpret mode).
"""
from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.ops import pallas_conv2d, pallas_conv3d, pallas_winograd
from rendernet_tpu_torch.ops import cuda_conv2d, cuda_conv3d, cuda_winograd
from rendernet_tpu_torch.ops.winograd import _AT, input_transform, transform_weights

KERNEL_TOL = 1e-4  # chip_smoke.KERNEL_TOL["float32"]: a kernel against its plain version
BOUND = 3 * 2.0 ** -22 * (1 + 2.0 ** -10)
BLOCK_SMEM = 232448  # shared memory one CTA may use on an H100
CSRC = pathlib.Path(cuda_conv3d.__file__).parents[1] / "csrc"


def _tf32(a):
    """``cvt.rna.tf32.f32``: the magnitude rounded to 10 stored mantissa
    bits, half away from zero, sign kept (finite values)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    mag = ((u & np.uint32(0x7FFFFFFF)) + np.uint32(0x1000)) & np.uint32(0x7FFFE000)
    return (mag | (u & np.uint32(0x80000000))).view(np.float32)


def _split(a):
    """(hi, lo) as float64: hi = tf32(a), lo = tf32(a - hi), a - hi in fp32
    (exact)."""
    a = np.asarray(a, np.float32)
    hi = _tf32(a)
    return hi.astype(np.float64), _tf32(a - hi).astype(np.float64)


def _three_pass(a, b):
    """hi.hi + hi.lo + lo.hi of matrices a [.., M, K] and b [.., K, N], each
    product and sum in float64."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return ah @ bh + ah @ bl + al @ bh


def test_tf32_rounding():
    """The emulated cvt.rna: 13 low bits cleared, ties away from zero."""
    ulp = 2.0 ** -10
    a = np.array([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -23, 1 + 1.5 * ulp, 0.0],
                 np.float32)
    np.testing.assert_array_equal(_tf32(a), np.array([1 + ulp, -(1 + ulp), 1, 1 + 2 * ulp, 0],
                                                     np.float32))
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    assert not (_tf32(x).view(np.uint32) & 0x1FFF).any()
    assert (np.abs(_tf32(x) - x) <= 2.0 ** -11 * np.abs(x)).all()


def _wino_operands():
    """V and U of the card check's ragged K3 shape, [8, 6, 70, 256] -> 128."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((8, 6, 70, 256)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 256, 128)) / np.sqrt(9 * 256)).astype(np.float32)
    v = input_transform(torch.from_numpy(x), torch.float32).numpy()
    u = transform_weights(torch.from_numpy(w), torch.float32).numpy()
    return x, w, v, u


def _conv3d_operands():
    """K2's operands at a res1-like [2, 4, 8, 32, 32] -> 32: the 27-tap
    patches [positions, 27 C] (SAME zeros) and the weights [27 C, co]."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 8, 32, 32)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 32, 32)) / np.sqrt(27 * 32)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    b, h, wd, d, c = x.shape
    patches = np.concatenate([xp[:, i:i + h, j:j + wd, k:k + d, :].reshape(-1, c)
                              for i in range(3) for j in range(3) for k in range(3)], axis=1)
    return x, w, patches, w.reshape(27 * c, -1)


@pytest.mark.parametrize("which", ["winograd", "conv3d"])
def test_split_products_bound(which):
    """Each three-pass product within BOUND of |a b|, and each GEMM's sums
    within BOUND of the sums of |a| |b| (float64 sums: the split alone)."""
    if which == "winograd":
        _, _, v, u = _wino_operands()
        a, b = v[5, :64, :64].ravel(), u[5, :64, :64].ravel()
        pairs = [(v[f], u[f]) for f in (0, 5, 10, 15)]
    else:
        _, _, patches, wm = _conv3d_operands()
        a = np.repeat(patches[:64], wm.shape[1], axis=1).ravel()
        b = np.tile(wm.ravel(), 64)
        pairs = [(patches, wm)]
    (ah, al), (bh, bl) = _split(a), _split(b)
    got = ah * bh + ah * bl + al * bh
    exact = a.astype(np.float64) * b
    assert (np.abs(got - exact) <= BOUND * np.abs(exact)).all()
    for lhs, rhs in pairs:
        exact = lhs.astype(np.float64) @ rhs.astype(np.float64)
        mag = np.abs(lhs).astype(np.float64) @ np.abs(rhs).astype(np.float64)
        assert (np.abs(_three_pass(lhs, rhs) - exact) <= BOUND * mag).all()


def test_emulated_winograd_conv():
    """The whole fp32 K3 at [8, 6, 70, 256] -> 128, emulated: the 16 GEMMs
    in three passes, then Y = A^T M A, against ``wino_conv2d_plain`` and
    JAX's ``wino_conv2d`` (its Pallas kernel in interpret mode)."""
    x, w, v, u = _wino_operands()
    m = _three_pass(v, u).reshape(4, 4, 8, 3, 35, 128)
    at = _AT.astype(np.float64)
    y = np.einsum("pa,qb,abtrsk->trpsqk", at, at, m).reshape(8, 6, 70, 128)
    plain = cuda_winograd.wino_conv2d_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    jax_y = np.asarray(pallas_winograd.wino_conv2d(jnp.asarray(x), jnp.asarray(w)))
    for want in (plain, jax_y):
        assert np.abs(y - want).max() <= 0.1 * KERNEL_TOL * np.abs(want).max()


def test_emulated_conv3d():
    """The whole fp32 K2 at [2, 4, 8, 32, 32] -> 32, emulated: the 27 * C
    products in three passes, against ``nc_conv3d_plain`` and JAX's
    ``nc_conv3d`` (interpret mode)."""
    x, w, patches, wm = _conv3d_operands()
    y = _three_pass(patches, wm).reshape(*x.shape[:4], -1)
    plain = cuda_conv3d.nc_conv3d_plain(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    jax_y = np.asarray(pallas_conv3d.nc_conv3d(jnp.asarray(x), jnp.asarray(w)))
    for want in (plain, jax_y):
        assert np.abs(y - want).max() <= 0.1 * KERNEL_TOL * np.abs(want).max()


def _constants():
    src = (CSRC / "conv3d.cu").read_text()
    tile = (CSRC / "conv3d_tile.cuh").read_text()
    const = {n: int(re.search(rf"constexpr int {n} = (\d+);", src)[1])
             for n in ("F_TW", "F_RING", "F_CO")}
    const["TD"] = int(re.search(r"constexpr int TD = (\d+);", tile)[1])
    return const


def test_tf32_kernel_constants_and_shared_memory():
    """The fp32 kernel's compiled tile (F_TW, F_RING, F_CO, TD) is the
    plan's, and its shared memory (128 bytes of alignment, the resident
    weights of the channel step CP and a CTA's output slice, F_RING halo
    planes of (F_TW + 2) x (TD + 2) x CP values) fits a CTA at every
    (CP, slice), and the CTAs the plan puts on one SM fit the SM."""
    k = _constants()
    assert (k["F_TW"], k["F_RING"], k["F_CO"], k["TD"]) == (
        cuda_conv3d.TILE_W_F32, cuda_conv3d.RING_F32, cuda_conv3d.CO_F32, cuda_conv3d.TILE_D)
    for cp in (16, 32):
        for co in (16, 32, 64):
            cs = min(co, k["F_CO"])
            smem = 128 + 27 * cp * cs * 4 + k["F_RING"] * (k["F_TW"] + 2) * (k["TD"] + 2) * cp * 4
            assert smem == cuda_conv3d.tf32_smem_bytes(cp, co) <= BLOCK_SMEM
            per_sm = cuda_conv3d.SMEM_PER_SM // (smem + 1024)
            assert per_sm >= 1
            grid = cuda_conv3d.conv3d_plan((8, 64, 64, 32, cp), 132, torch.float32, co)
            assert grid * max(co // k["F_CO"], 1) <= 132 * per_sm
    assert cuda_conv3d.tf32_smem_bytes(32, 32) == 215168  # res1, 32 -> 32


# The models' fp32 shapes (serving, gradient check, recon, texture), the
# card tests' ragged ones (co = 64 in two slices, C % 4 != 0, D and W not
# whole tiles).
F32_SHAPES = [((8, 64, 64, 32, 32), 32), ((8, 64, 64, 32, 16), 32), ((8, 64, 64, 32, 32), 16),
              ((5, 64, 64, 32, 16), 16), ((2, 5, 10, 24, 24), 64), ((2, 4, 8, 20, 32), 32),
              ((2, 4, 6, 16, 18), 16), ((1, 3, 5, 40, 8), 64)]


@pytest.mark.parametrize("x_shape,co", F32_SHAPES)
def test_tf32_plan_covers_every_position_once(x_shape, co):
    """The fp32 kernel's rows (4 W x 32 D of one (b, h), decoded as the
    kernel's ``column<F_TW>`` does) split into the plan's contiguous ranges
    per slice of co, for the plan's grid and others: every output position
    of every slice exactly once."""
    b_, h_, w_, d_, _ = x_shape
    tw, td = cuda_conv3d.TILE_W_F32, cuda_conv3d.TILE_D
    rows = cuda_conv3d.conv3d_rows(x_shape, torch.float32)
    assert rows == b_ * -(-w_ // tw) * -(-d_ // td) * h_
    slices = max(co // cuda_conv3d.CO_F32, 1)
    plan = cuda_conv3d.conv3d_plan(x_shape, 132, torch.float32, co)
    assert 1 <= plan <= rows
    for grid in sorted({1, 7, plan, rows}):
        seen = np.zeros((slices, b_, h_, w_, d_), np.int32)
        for sl in range(slices):
            for i in range(grid):
                for r in range(rows * i // grid, rows * (i + 1) // grid):
                    col, h = divmod(r, h_)
                    rest, dt = divmod(col, -(-d_ // td))
                    b, wt = divmod(rest, -(-w_ // tw))
                    seen[sl, b, h, wt * tw:wt * tw + tw, dt * td:dt * td + td] += 1
        assert (seen == 1).all(), (x_shape, co, grid)


# ---------------------------------------------------------------------------
# K5 and K5w: both operands split into planes, chains restarted
# ---------------------------------------------------------------------------
K5_SHAPE, K5_CO = (4, 8, 2, 256), 256  # HWNC; NHWC [2, 4, 8, 256] is in JAX's envelope


def _k5_operands():
    rng = np.random.default_rng(9)
    h, w, b, c = K5_SHAPE
    return dict(x=rng.standard_normal(K5_SHAPE).astype(np.float32),
                w=(rng.standard_normal((3, 3, c, K5_CO)) / (3 * np.sqrt(c))).astype(np.float32),
                b=(rng.standard_normal(K5_CO) * 0.1).astype(np.float32),
                al=rng.uniform(0.05, 0.3, K5_CO).astype(np.float32),
                r=rng.standard_normal((h, w, b, K5_CO)).astype(np.float32),
                gz=rng.standard_normal((h, w, b, K5_CO)).astype(np.float32))


def _chain_sum(a, b, mags):
    """One accumulator chain: the three-pass sum of a [M, K] @ b [K, N] in
    float64 (the tensor cores' products are exact), held to BOUND of its
    sum of |a| |b| (appended to ``mags`` with its error), rounded to fp32."""
    got = _three_pass(a, b)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    mags.append(bool((np.abs(got - exact) <= BOUND * mag).all()))
    return got.astype(np.float32)


def _emulated_k5(x, w, mags):
    """K5 fp32 as built: per tile row the stages (tap, 32-channel chunk),
    chains of CHAIN_STAGES_F32 stages, each chain's three-pass sum rounded
    to fp32 and the chains added in fp32 in stage order. [H, W, B, co]."""
    h, wd, b, c = x.shape
    co = w.shape[-1]
    taps = [t.numpy().reshape(-1, c) for t in cuda_conv2d._taps(torch.from_numpy(x))]
    wk = cuda_conv2d.kernel_weights(torch.from_numpy(w), torch.float32).numpy()  # [9, co, C]
    nc = c // 32
    tot = None
    for k0, k1 in cuda_conv2d.conv2d_chains(c):
        a = np.concatenate([taps[k // nc][:, k % nc * 32:k % nc * 32 + 32] for k in range(k0, k1)], 1)
        bm = np.concatenate([wk[k // nc][:, k % nc * 32:k % nc * 32 + 32] for k in range(k0, k1)], 1)
        part = _chain_sum(a, bm.T, mags)
        tot = part if tot is None else tot + part
    return tot.reshape(h, wd, b, co)


def _epilogue(acc, d, epilogue):
    """The kernels' epilogue in the TPU kernel's order, in fp32: + bias, z,
    activation, + residual. Returns (y, z or None)."""
    if epilogue == "none":
        return acc, None
    v = acc + d["b"]
    z = v if epilogue == "prelu+pre" else None
    if epilogue.startswith("prelu"):
        v = np.where(v < 0, d["al"] * v, v)
    elif epilogue == "relu":
        v = np.where(v < 0, np.float32(0), v)
    if epilogue == "res":
        v = v + d["r"]
    return v, z


@pytest.mark.parametrize("epilogue", ["none", "prelu+pre", "relu", "res"])
def test_emulated_fused_conv(epilogue):
    """The whole fp32 K5 at [4, 8, 2, 256] -> 256, emulated (the split
    planes, three passes, chains of CHAIN_STAGES_F32 stages) with each
    epilogue, against ``conv2d_hwnc_plain`` and JAX's ``_wc_conv2d_padded``
    (interpret mode): y and z within a tenth of KERNEL_TOL; every chain's
    sum within BOUND of its sum of |a| |b|."""
    d = _k5_operands()
    mags = []
    y, z = _epilogue(_emulated_k5(d["x"], d["w"], mags), d, epilogue)
    assert mags and all(mags)
    tkw, jkw = {}, {}
    if epilogue != "none":
        tkw["bias"], jkw["bias"] = torch.from_numpy(d["b"]), jnp.asarray(d["b"])
    if epilogue.startswith("prelu"):
        tkw.update(alpha=torch.from_numpy(d["al"]), act="prelu", emit_pre=True)
        jkw.update(alpha=jnp.asarray(d["al"]), act="prelu", emit_pre=True)
    if epilogue == "relu":
        tkw["act"] = jkw["act"] = "relu"
    if epilogue == "res":
        tkw["res"], jkw["res"] = torch.from_numpy(d["r"]), jnp.asarray(d["r"])
    plain = cuda_conv2d.conv2d_hwnc_plain(torch.from_numpy(d["x"]), torch.from_numpy(d["w"]), **tkw)
    plain = [t.numpy() for t in (plain if isinstance(plain, tuple) else (plain,))]
    obufs = 2 if jkw.get("emit_pre") or "res" in jkw else 1
    jax_out = pallas_conv2d._wc_conv2d_padded(pallas_conv2d._pad_hw(jnp.asarray(d["x"])),
                                              jnp.asarray(d["w"]), jnp.float32, obufs=obufs, **jkw)
    jax_out = [np.asarray(t) for t in (jax_out if isinstance(jax_out, tuple) else (jax_out,))]
    got = [y] + ([z] if epilogue.startswith("prelu") else [])
    for want_set in (plain, jax_out):
        assert len(want_set) == len(got)
        for g, want in zip(got, want_set):
            assert np.abs(g - want).max() <= 0.1 * KERNEL_TOL * np.abs(want).max()


def _emulated_k5w(x, gz, mags):
    """K5w fp32 as built: the channel-major planes (batch padded to a
    multiple of 4), the plan's parts and items, each item's chains of at
    most MAX_CHAIN_STEPS_F32 steps of 32 pixels (three-pass sums rounded to
    fp32, the first stored, later ones added in fp32 in order), then the
    parts added in part order. [3, 3, C, co] fp32."""
    h, wd, b, c = x.shape
    co = gz.shape[-1]
    dt = torch.float32
    bp, rp = cuda_conv2d.wgrad_batch_pitch(b, dt), cuda_conv2d.wgrad_row_pitch(x.shape)

    def planes(a):
        out = np.zeros((a.shape[-1], h, rp + 2 * 32), np.float32)  # room for the shifts
        ab = np.zeros((h, wd, bp, a.shape[-1]), np.float32)
        ab[:, :, :b] = a
        out[:, :, 32:32 + wd * bp] = ab.reshape(h, wd * bp, -1).transpose(2, 0, 1)
        return out

    xp, gp = planes(x), planes(gz)
    parts, _ = cuda_conv2d.wgrad_plan(dt, x.shape, co, 132)
    bn = cuda_conv2d.tile_n(co)
    rpairs = 9 * c // 128
    per_part = -(-rpairs // 2) * (co // bn)
    spr = cuda_conv2d.wgrad_steps(x.shape, dt) // h
    part = np.zeros((parts, 9, c, co), np.float32)
    for q in range(per_part * parts):
        for rank in (0, 1):
            p, rpair, n0, s0, s1 = cuda_conv2d.wgrad_item(q, rank, x.shape, co, parts, dt)
            if rpair == rpairs:
                continue
            for rb in (2 * rpair, 2 * rpair + 1):
                tap, c0 = cuda_conv2d.wgrad_row_block(rb)
                ky, kx = divmod(tap, 3)
                for k, (cb, ce) in enumerate(cuda_conv2d.wgrad_chains(s0, s1, dt)):
                    xa, ga = [], []
                    for st in range(cb, ce):
                        hh, m0 = st // spr, st % spr * 32
                        hs, m = hh + ky - 1, 32 + m0 + (kx - 1) * bp
                        xa.append(xp[c0:c0 + 64, hs, m:m + 32] if 0 <= hs < h
                                  else np.zeros((64, 32), np.float32))
                        ga.append(gp[n0:n0 + bn, hh, 32 + m0:64 + m0])
                    acc = _chain_sum(np.concatenate(xa, 1), np.concatenate(ga, 1).T, mags)
                    blk = part[p, tap, c0:c0 + 64, n0:n0 + bn]
                    part[p, tap, c0:c0 + 64, n0:n0 + bn] = acc if k == 0 else blk + acc
    out = part[0].copy()
    for i in range(1, parts):
        out += part[i]
    return out.reshape(3, 3, c, co)


@pytest.mark.parametrize("chain", [None, 1])
def test_emulated_fused_conv_wgrad(chain, monkeypatch):
    """The whole fp32 K5w at [4, 8, 2, 256] -> 256 (batch 2 padded to 4),
    emulated, with the kernels' chains and with a chain of one step each,
    against ``conv2d_wgrad_plain`` and JAX's ``_wgrad`` (interpret mode):
    within a tenth of KERNEL_TOL of max|gw|; every chain's sum within BOUND
    of its sum of |a| |b|."""
    if chain is not None:
        monkeypatch.setattr(cuda_conv2d, "MAX_CHAIN_STEPS_F32", chain)
    d = _k5_operands()
    mags = []
    got = _emulated_k5w(d["x"], d["gz"], mags)
    assert mags and all(mags)
    plain = cuda_conv2d.conv2d_wgrad_plain(torch.from_numpy(d["x"]),
                                           torch.from_numpy(d["gz"])).numpy()
    jax_gw = np.asarray(pallas_conv2d._wgrad(pallas_conv2d._pad_hw(jnp.asarray(d["x"])),
                                             jnp.asarray(d["gz"]), K5_CO))
    for want in (plain, jax_gw):
        assert np.abs(got - want).max() <= 0.1 * KERNEL_TOL * np.abs(want).max()


# ---------------------------------------------------------------------------
# K2w: both operands split in registers (rounded to nearest even), chains
# of rows added into each CTA's partial
# ---------------------------------------------------------------------------
def _tf32_rn(a):
    """``cvt.rn.tf32.f32``: the magnitude rounded to 10 stored mantissa
    bits, half to even, sign kept (finite values)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    mag = u & np.uint32(0x7FFFFFFF)
    mag = (mag + np.uint32(0xFFF) + ((mag >> np.uint32(13)) & np.uint32(1))) & np.uint32(0x7FFFE000)
    return (mag | (u & np.uint32(0x80000000))).view(np.float32)


def _three_pass_rn(a, b):
    """hi.hi + hi.lo + lo.hi as ``_three_pass``, with K2w's split
    (``rn::tf32_split_rn``: both roundings to nearest even)."""
    def split(v):
        v = np.asarray(v, np.float32)
        hi = _tf32_rn(v)
        return hi.astype(np.float64), _tf32_rn(v - hi).astype(np.float64)

    (ah, al), (bh, bl) = split(a), split(b)
    return ah @ bh + ah @ bl + al @ bh


def test_tf32_rn_rounding_and_products():
    """The emulated cvt.rn: ties to even, each value within 2^-11 of itself;
    each three-pass product of the rn split within BOUND of |a b|."""
    ulp = 2.0 ** -10
    a = np.array([1 + ulp / 2, 1 + 1.5 * ulp, -(1 + 1.5 * ulp), 1 + ulp / 2 + 2.0 ** -23, 0.0],
                 np.float32)
    np.testing.assert_array_equal(_tf32_rn(a), np.array([1, 1 + 2 * ulp, -(1 + 2 * ulp),
                                                         1 + ulp, 0], np.float32))
    rng = np.random.default_rng(11)
    x = rng.standard_normal(4096).astype(np.float32)
    y = rng.standard_normal(4096).astype(np.float32)
    assert not (_tf32_rn(x).view(np.uint32) & 0x1FFF).any()
    assert (np.abs(_tf32_rn(x) - x) <= 2.0 ** -11 * np.abs(x)).all()
    got = _three_pass_rn(x[:, None, None], y[:, None, None])[:, 0, 0]
    exact = x.astype(np.float64) * y
    assert (np.abs(got - exact) <= BOUND * np.abs(exact)).all()


def _k2w_rows(x_shape, r0, r1):
    """The positions of rows [r0, r1) of fp32 K2w's walk (4 W x 32 D of one
    (b, h), decoded as ``column<F_TW>``), as index arrays (b, h, w, d)."""
    b_, h_, w_, d_, _ = x_shape
    tw, td = cuda_conv3d.TILE_W_F32, cuda_conv3d.TILE_D
    idx = []
    for r in range(r0, r1):
        col, h = divmod(r, h_)
        rest, dt = divmod(col, -(-d_ // td))
        b, wt = divmod(rest, -(-w_ // tw))
        w, d = np.meshgrid(np.arange(wt * tw, min(wt * tw + tw, w_)),
                           np.arange(dt * td, min(dt * td + td, d_)), indexing="ij")
        idx.append(np.stack([np.full(w.size, b), np.full(w.size, h), w.ravel(), d.ravel()]))
    return tuple(np.concatenate(idx, axis=1))


def _emulated_k2w(x, gy, n_sm, mags):
    """K2w fp32 as built: the plan's parts (CTAs over the 4 W x 32 D rows),
    each part's chains of rows (``wgrad_chains``), each chain's three-pass
    sums (rn split) rounded to fp32, stored by the first chain and added in
    fp32 by each later one, then the parts added in part order (the reduce
    kernel's). Every channel slice sums its channels in this same order.
    [3, 3, 3, C, co] fp32."""
    b, h, wd, d, c = x.shape
    co = gy.shape[-1]
    parts, _ = cuda_conv3d.wgrad_plan(torch.float32, x.shape, co, n_sm)
    rows = cuda_conv3d.conv3d_rows(x.shape, torch.float32)
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    part = np.zeros((parts, 27, c, co), np.float32)
    for i in range(parts):
        for k, (c0, c1) in enumerate(cuda_conv3d.wgrad_chains(rows * i // parts,
                                                              rows * (i + 1) // parts)):
            pb, ph, pw, pd = _k2w_rows(x.shape, c0, c1)
            a = np.stack([xp[pb, ph + kh, pw + kw, pd + kd].T
                          for kh in range(3) for kw in range(3) for kd in range(3)])
            g = gy[pb, ph, pw, pd]
            got = _three_pass_rn(a, g)
            exact = a.astype(np.float64) @ g.astype(np.float64)
            mag = np.abs(a).astype(np.float64) @ np.abs(g).astype(np.float64)
            mags.append(bool((np.abs(got - exact) <= BOUND * mag).all()))
            part[i] = got.astype(np.float32) if k == 0 else part[i] + got.astype(np.float32)
    out = part[0].copy()
    for i in range(1, parts):
        out += part[i]
    return out.reshape(3, 3, 3, c, co)


# A res1-like and a texture-like (16 -> 16) shape, on 2 SMs: two parts of 8
# rows each, so that the kernel's chains (4 rows) and chains of one row differ.
K2W_SHAPES = [((2, 4, 8, 32, 32), 32), ((2, 4, 8, 32, 16), 16)]


@pytest.fixture(scope="module")
def k2w_refs():
    """Per shape: x, gy, the plain version and JAX's weight cotangent of
    ``pallas_conv3d.nc_conv3d`` (``jax.vjp``; its Pallas kernels in
    interpret mode), each computed once."""
    import jax

    out = {}
    for xs, co in K2W_SHAPES:
        rng = np.random.default_rng(12)
        x = rng.standard_normal(xs).astype(np.float32)
        gy = rng.standard_normal(xs[:-1] + (co,)).astype(np.float32)
        plain = cuda_conv3d.nc_conv3d_wgrad_plain(torch.from_numpy(x), torch.from_numpy(gy))
        w = jnp.zeros((3, 3, 3, xs[-1], co), jnp.float32)
        _, vjp = jax.vjp(pallas_conv3d.nc_conv3d, jnp.asarray(x), w)
        out[xs, co] = x, gy, plain.numpy(), np.asarray(vjp(jnp.asarray(gy))[1])
    return out


@pytest.mark.parametrize("chain", [None, 1])
@pytest.mark.parametrize("xs,co", K2W_SHAPES)
def test_emulated_conv3d_wgrad(xs, co, chain, k2w_refs, monkeypatch):
    """The whole fp32 K2w, emulated with the kernel's chains and with chains
    of one row, against ``nc_conv3d_wgrad_plain`` and JAX's weight
    cotangent: within a tenth of KERNEL_TOL of max|gw|; every chain's sum
    within BOUND of its sum of |a| |b|."""
    if chain is not None:
        monkeypatch.setattr(cuda_conv3d, "WGRAD_CHAIN_ROWS_F32", chain)
    x, gy, plain, jax_gw = k2w_refs[xs, co]
    assert cuda_conv3d.wgrad_plan(torch.float32, xs, co, 2)[0] == 2
    mags = []
    got = _emulated_k2w(x, gy, 2, mags)
    assert len(mags) == 2 * -(-8 // cuda_conv3d.WGRAD_CHAIN_ROWS_F32) and all(mags)
    for want in (plain, jax_gw):
        assert np.abs(got - want).max() <= 0.1 * KERNEL_TOL * np.abs(want).max()
