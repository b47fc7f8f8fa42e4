"""The port's fused wide-conv ops (``ops/cuda_conv2d.py``, K5 and K5w)
against ``pallas_conv2d`` on the CPU: the kernels' plain versions against
the Pallas kernels in interpret mode, every autograd Function against
``jax.vjp`` of the JAX custom VJP (tie masks included), the envelope and the
dispatch against JAX's.

The same numpy inputs and cotangents go to both sides; module switches are
set with ``monkeypatch`` and restored after each test. Tolerances, as a
fraction of max|reference|: fp32 1e-4 for kernels (sums in other orders),
2e-4 for gradients (JAX's own test's); bf16 2^-7 (both round an fp32 sum
once to bf16: at most one bf16 ulp of a value, two of the max); the weight
gradients are fp32 sums of exact products in either dtype: 1e-4.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.nn import layers as jl
from rendernet_tpu.ops import pallas_conv2d as pc
from rendernet_tpu_torch.nn import layers as tl
from rendernet_tpu_torch.ops import cuda_conv2d as tc

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPILOGUES = ["none", "bias", "prelu", "prelu+pre", "relu", "res"]


def _rel_close(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _inputs(rng, shape, co):
    """HWNC input, HWIO weights, bias, alpha, residual and a cotangent."""
    h, wd, b, c = shape
    return dict(
        x=rng.standard_normal(shape).astype(np.float32),
        w=(rng.standard_normal((3, 3, c, co)) / (3 * np.sqrt(c))).astype(np.float32),
        b=(rng.standard_normal(co) * 0.1).astype(np.float32),
        al=rng.uniform(0.05, 0.3, co).astype(np.float32),
        r=rng.standard_normal((h, wd, b, co)).astype(np.float32),
        cot=rng.standard_normal((h, wd, b, co)).astype(np.float32))


def _epilogue_kwargs(epilogue, d, cast):
    kw = {}
    if epilogue != "none":
        kw["bias"] = cast(d["b"])
    if epilogue.startswith("prelu"):
        kw.update(alpha=cast(d["al"]), act="prelu", emit_pre=epilogue.endswith("pre"))
    if epilogue == "relu":
        kw["act"] = "relu"
    if epilogue == "res":
        kw["res"] = cast(d["r"])
    return kw


# ---------------------------------------------------------------------------
# K5 and K5w: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", EPILOGUES)
def test_conv2d_plain_matches_pallas_kernel(dname, epilogue):
    """conv2d_hwnc_plain (and the wrapper, which takes it on the CPU) with
    each epilogue against pallas_conv2d._wc_conv2d_padded in interpret
    mode, ci != co, batch 3: y, and z where emitted."""
    d = _inputs(np.random.default_rng(1), (8, 8, 3, 384), 256)
    jdt, tdt = JDT[dname], TDT[dname]
    jkw = _epilogue_kwargs(epilogue, d, lambda a: jnp.asarray(a, jdt))
    obufs = 2 if jkw.get("emit_pre") or "res" in jkw else 1
    want = pc._wc_conv2d_padded(pc._pad_hw(jnp.asarray(d["x"], jdt)), jnp.asarray(d["w"], jdt),
                                jdt, obufs=obufs, **jkw)
    tkw = _epilogue_kwargs(epilogue, d, lambda a: torch.from_numpy(a).to(tdt))
    xt, wt = torch.from_numpy(d["x"]).to(tdt), torch.from_numpy(d["w"]).to(tdt)
    before = tc.launches
    got = tc.conv2d_hwnc(xt, wt, **tkw)
    assert tc.launches == before  # the CPU path launches nothing
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    plain = tc.conv2d_hwnc_plain(xt, wt, **tkw)
    plain = plain if isinstance(plain, tuple) else (plain,)
    assert len(got) == len(want) == (2 if epilogue == "prelu+pre" else 1)
    for g, p, wnt in zip(got, plain, want):
        assert g.dtype == tdt
        assert torch.equal(g, p)
        _rel_close(g.float().numpy(), _f32(wnt), TOL[dname])


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,co", [((8, 8, 3, 256), 384), ((6, 16, 2, 256), 256)])
def test_conv2d_wgrad_plain_matches_pallas_kernel(dname, shape, co):
    """conv2d_wgrad_plain (and the wrapper) against pallas_conv2d._wgrad in
    interpret mode: fp32 [3, 3, C, co] from either dtype, 1e-4."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape).astype(np.float32)
    gz = rng.standard_normal(shape[:3] + (co,)).astype(np.float32)
    jdt, tdt = JDT[dname], TDT[dname]
    want = pc._wgrad(pc._pad_hw(jnp.asarray(x, jdt)), jnp.asarray(gz, jdt), co)
    got = tc.conv2d_wgrad(torch.from_numpy(x).to(tdt), torch.from_numpy(gz).to(tdt))
    assert got.dtype == torch.float32
    _rel_close(got.numpy(), np.asarray(want), 1e-4)


# ---------------------------------------------------------------------------
# the autograd Functions against jax.vjp
# ---------------------------------------------------------------------------
def _planted(rng, shape, co):
    """Inputs whose pre-activation z = conv(x, w) + b is exactly 0 at some
    (pixel, channel) pairs: x is zero on rows 0-2 (so conv(x, w) is 0 on
    rows 0-1, whose 3x3 windows see only zero rows) and b is zero on the
    even channels. The tie masks decide those gradients."""
    d = _inputs(rng, shape, co)
    d["x"][:3] = 0.0
    d["b"][::2] = 0.0
    return d


def _ops(mod, variant):
    """(function of the op's arguments, argument names) for a variant."""
    if variant == "conv":
        return mod.wc_conv2d_hwnc, ("x", "w")
    if variant == "nhwc":
        return mod.wc_conv2d, ("xn", "w")
    if variant == "prelu":
        return mod.wc_conv2d_prelu_hwnc, ("x", "w", "b", "al")
    if variant == "relu":
        return mod.wc_conv2d_relu_hwnc, ("x", "w", "b")
    return mod.wc_conv2d_res_hwnc, ("x", "w", "b", "r")


@pytest.mark.parametrize("variant,save_pre", [
    ("conv", True), ("nhwc", True), ("prelu", True), ("prelu", False), ("relu", True),
    ("res", True)])
def test_ops_match_jax_vjp(monkeypatch, variant, save_pre):
    """Output and every argument's cotangent of each fused op against
    jax.vjp through its pallas_conv2d counterpart (Pallas forward, dgrad and
    wgrad kernels in interpret mode), fp32, with planted zeros in z: the
    ReLU op passes no gradient where y = 0 (``y > 0``), the PReLU op passes
    alpha * gy where z = 0 (``z > 0``) and sums gy * min(z, 0) into alpha;
    torch.maximum would split an exact tie 0.5 / 0.5. PRELU_SAVE_PRE both
    ways on both sides: 2e-4 of max|reference|."""
    monkeypatch.setattr(pc, "PRELU_SAVE_PRE", save_pre)
    monkeypatch.setattr(tc, "PRELU_SAVE_PRE", save_pre)
    d = _planted(np.random.default_rng(3), (6, 8, 3, 256), 256)
    d["xn"] = np.ascontiguousarray(d["x"].transpose(2, 0, 1, 3))
    cot = d["cot"] if variant != "nhwc" else np.ascontiguousarray(d["cot"].transpose(2, 0, 1, 3))
    z = _f32(pc._wc_conv2d_padded(pc._pad_hw(jnp.asarray(d["x"])), jnp.asarray(d["w"]),
                                  jnp.float32, bias=jnp.asarray(d["b"])))
    assert (z == 0).sum() >= 6 * 8 * 128  # rows 0-1 of the even channels, at least
    jfn, names = _ops(pc, variant)
    tfn, _ = _ops(tc, variant)
    args = [d[n] for n in names]
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    wgrads = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = tfn(*ts)
    tgrads = torch.autograd.grad(out, ts, torch.from_numpy(cot))
    _rel_close(out.detach().numpy(), np.asarray(want), 2e-4)
    for name, g, w in zip(names, tgrads, wgrads):
        assert g.dtype == torch.float32, name
        _rel_close(g.numpy(), np.asarray(w), 2e-4)


def test_prelu_recompute_matches_save_pre():
    """PRELU_SAVE_PRE = False (the backward recomputes z with a bias-only
    K5 call) gives the same gradients as the saved z, bit for bit, and the
    forward emits z only when a gradient is wanted."""
    d = _inputs(np.random.default_rng(4), (6, 8, 3, 256), 256)
    args = [d[n] for n in ("x", "w", "b", "al")]
    cot = torch.from_numpy(d["cot"])
    calls = []
    orig = tc.conv2d_hwnc

    def counted(*a, **kw):
        calls.append(kw.get("emit_pre", False))
        return orig(*a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tc, "conv2d_hwnc", counted)
        grads = {}
        for save_pre in (True, False):
            mp.setattr(tc, "PRELU_SAVE_PRE", save_pre)
            ts = [torch.from_numpy(a).requires_grad_() for a in args]
            calls.clear()
            out = tc.wc_conv2d_prelu_hwnc(*ts)
            grads[save_pre] = torch.autograd.grad(out, ts, cot)
            # forward (+z when saved); the backward's z recompute; one dgrad
            assert calls == ([True, False] if save_pre else [False, False, False])
        with torch.no_grad():
            calls.clear()
            tc.wc_conv2d_prelu_hwnc(*[torch.from_numpy(a) for a in args])
            assert calls == [False]
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)


def test_frozen_weights_skip_the_weight_gradient():
    """With the weights, bias and alpha frozen (the recon nets), the
    backward runs the data gradient only: no K5w call and no gradient for
    the parameters."""
    d = _inputs(np.random.default_rng(5), (4, 8, 2, 256), 256)
    calls = {"k5w": 0}
    orig = tc.conv2d_wgrad

    def counted(*a):
        calls["k5w"] += 1
        return orig(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tc, "conv2d_wgrad", counted)
        x = torch.from_numpy(d["x"]).requires_grad_()
        w, b = torch.from_numpy(d["w"]), torch.from_numpy(d["b"])
        y = tc.wc_conv2d_res_hwnc(tc.wc_conv2d_relu_hwnc(x, w, b), w, b, x)
        (gx,) = torch.autograd.grad(y, [x], torch.from_numpy(d["cot"]))
        assert calls["k5w"] == 0 and torch.isfinite(gx).all()
        w.requires_grad_()
        y = tc.wc_conv2d_relu_hwnc(x, w, b)
        torch.autograd.grad(y, [x, w], torch.from_numpy(d["cot"]))
        assert calls["k5w"] == 1


# ---------------------------------------------------------------------------
# envelope and dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", [1, 3, 5, 8, 24])
def test_envelope_matches_jax(b):
    """wc_conv2d_supported equals JAX's on a grid of batch, H, W, channels
    and obufs (including 3x3 / stride / rank refusals)."""
    n = 0
    for h in (8, 16, 64):
        for wd in (8, 32, 64):
            for c in (128, 256, 384, 512, 1024):
                for co in (128, 256, 512, 1024):
                    for obufs in (1, 2):
                        xs, ws = (b, h, wd, c), (3, 3, c, co)
                        want = pc.wc_conv2d_supported(xs, ws, (1, 1), obufs)
                        assert tc.wc_conv2d_supported(xs, ws, (1, 1), obufs) == want, (xs, ws)
                        n += want
    assert n > 0
    for xs, ws, st in (((b, 8, 8, 256), (3, 3, 256, 256), (2, 1)),
                       ((b, 8, 8, 256), (5, 5, 256, 256), (1, 1)),
                       ((b, 8, 8, 256), (3, 3, 128, 256), (1, 1)), ((8, 8, 256), (3, 3, 256, 256),
                                                                    (1, 1))):
        assert tc.wc_conv2d_supported(xs, ws, st) == pc.wc_conv2d_supported(xs, ws, st) is False


# (shape, conv routed to K5, stack HWNC-resident) in JAX at the model's shapes
ROUTES = [((b, 64, 64, c), c) for b in (1, 5, 8, 24) for c in (1024, 512, 256)] + [
    ((24, 32, 32, 1024), 1024), ((24, 32, 32, 512), 512), ((3, 16, 16, 256), 256),
    ((2, 16, 16, 256), 256), ((5, 16, 16, 256), 256), ((8, 16, 16, 128), 128)]


@pytest.mark.parametrize("shape,c", ROUTES)
def test_dispatch_routes_like_jax(monkeypatch, shape, c):
    """With the flags on, the port sends a 3x3 stride-1 2D conv to K5, and a
    res stack HWNC-resident, exactly where JAX's _conv_op and
    res_block_stack take pallas_conv2d (batch enters through the envelope's
    bb rule); K5 is checked before K3, as in JAX."""
    monkeypatch.setattr(tl, "CUDA_CONV2D", True)
    monkeypatch.setattr(tl, "WINOGRAD_2D", "pallas")
    w = (3, 3, c, c)
    x = torch.empty(shape, device="meta")
    jconv = pc.wc_conv2d_supported(shape, w, (1, 1))
    jstack = pc.wc_conv2d_supported(shape, w, (1, 1), obufs=2)
    route = tl._kernel_for(x, w, (1, 1), 2)
    assert (route == "conv2d") == jconv
    if not jconv:
        assert route == ("wino" if shape[0] >= 8 and c >= 256 else None)
    blk = tl.ResBlock.__new__(tl.ResBlock)
    torch.nn.Module.__init__(blk)
    blk.ndim = 2
    blk.con1_3X3 = torch.nn.Module()
    blk.con1_3X3.weight = torch.nn.Parameter(torch.empty(c, c, 3, 3, device="meta"))
    assert tl._hwnc_stack([blk], x) == jstack
    monkeypatch.setattr(tl, "CUDA_CONV2D", False)
    assert tl._kernel_for(x, w, (1, 1), 2) != "conv2d" and not tl._hwnc_stack([blk], x)


def test_flag_mirrors_jax_default():
    """CUDA_CONV2D is off by default, as PALLAS_CONV2D is."""
    assert tl.CUDA_CONV2D is False and jl.PALLAS_CONV2D is False
