"""The exact conv rewrites and the conv routes against JAX's, on the CPU.

The phase-space strided conv (``ops/phase_conv.py``), the depth-packed 3D
conv and the sub-pixel K=4 transposed convs (``nn/layers.py``), forward and
VJP, each against the JAX function it mirrors on the same seeded numpy
inputs; ``WINOGRAD_2D``'s values, route and output against JAX's
``_conv_op``; and a route census: with the flags forced on, every conv and
deconv of the three model families (at reduced widths) takes the route in
the port that JAX's ``_conv_op`` / ``_conv_transpose_op`` take. JAX's side
of the census runs under ``jax.eval_shape`` (routes only, no arithmetic).
fp32 rewrites are exact in real arithmetic (the same products, summed in
other orders): 1e-5 absolute on O(1) outputs; bf16 rounds each output
once in both packages: 2^-7 of the largest value.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.models import decoders as jdec
from rendernet_tpu.models import shader as jshader
from rendernet_tpu.models import texture_face as jtex
from rendernet_tpu.nn import layers as jl
from rendernet_tpu.ops import pallas_conv2d, pallas_conv3d, pallas_winograd
from rendernet_tpu.ops import phase_conv as jphase
from rendernet_tpu.ops import winograd as jwino
from rendernet_tpu_torch.compat.jax_params import load_jax_params
from rendernet_tpu_torch.models import decoders as tdec
from rendernet_tpu_torch.models import shader as tshader
from rendernet_tpu_torch.models import texture_face as ttex
from rendernet_tpu_torch.nn import layers as tl
from rendernet_tpu_torch.ops import phase_conv as tphase

torch.set_num_threads(2)

TOL32 = 1e-5
TOL16 = 2.0 ** -7


def _pair(rng, xs, ws, scale=0.3):
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) * scale).astype(np.float32)
    return x, w


def _jax_vjp(fn, x, w, g):
    def f(x, w, g):
        y, vjp = jax.vjp(fn, x, w)
        return (y,) + vjp(g)

    return tuple(np.asarray(a) for a in jax.jit(f)(jnp.asarray(x), jnp.asarray(w),
                                                   jnp.asarray(g)))


def _port_vjp(fn, x, w, g):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = fn(xt, wt)
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    return y.detach().numpy(), gx.numpy(), gw.numpy()


def _close(got, want, tol):
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=tol * max(1.0, float(np.abs(b).max())), rtol=0)


# (input shape, kernel, stride): the shader's e_conv1 (1 channel), the
# texture's (5 channels), e_conv2's depth-only stride, an odd-sized grid's
PHASE_CASES = [((2, 8, 8, 8, 1), (5, 5, 5), (2, 2, 2), 8),
               ((1, 8, 8, 8, 5), (5, 5, 5), (2, 2, 2), 8),
               ((2, 6, 6, 8, 8), (3, 3, 3), (1, 1, 2), 16),
               ((1, 6, 9, 4, 3), (3, 3, 3), (2, 3, 2), 4)]


@pytest.mark.parametrize("xs,k,s,co", PHASE_CASES)
def test_phase_conv3d_matches_jax(xs, k, s, co):
    """phase_conv3d's forward and VJP (autograd through the phase
    expression) against JAX's; fp32."""
    rng = np.random.default_rng(1)
    x, w = _pair(rng, xs, k + (xs[-1], co))
    assert tphase.phase_conv3d_supported(xs, w.shape, s) == jphase.phase_conv3d_supported(
        xs, w.shape, s) is True
    want_y = jphase.phase_conv3d(jnp.asarray(x), jnp.asarray(w), s)
    g = rng.standard_normal(want_y.shape).astype(np.float32)
    want = _jax_vjp(lambda a, b: jphase.phase_conv3d(a, b, s), x, w, g)
    got = _port_vjp(lambda a, b: tphase.phase_conv3d(a, b, s), x, w, g)
    _close(got, want, TOL32)


@pytest.mark.parametrize("xs,k,s,co", PHASE_CASES[:3])
def test_phase_dgrad_conv3d_matches_jax(xs, k, s, co):
    """phase_dgrad_conv3d: the plain strided forward and weight gradient,
    the data gradient through the phase adjoint; fp32 against JAX's custom
    VJP, and equal to the plain strided conv's own gradients."""
    rng = np.random.default_rng(2)
    x, w = _pair(rng, xs, k + (xs[-1], co))
    y0 = jphase.phase_dgrad_conv3d(jnp.asarray(x), jnp.asarray(w), s)
    g = rng.standard_normal(y0.shape).astype(np.float32)
    want = _jax_vjp(lambda a, b: jphase.phase_dgrad_conv3d(a, b, s), x, w, g)
    got = _port_vjp(lambda a, b: tphase.phase_dgrad_conv3d(a, b, s), x, w, g)
    _close(got, want, TOL32)
    plain = _port_vjp(lambda a, b: tl._plain_conv(a, b, s, 3), x, w, g)
    _close(got, plain, TOL32)


def test_phase_conv3d_bf16_matches_jax():
    """The bf16 form: both packages round each output once; 2^-7 of max."""
    rng = np.random.default_rng(3)
    x, w = _pair(rng, (2, 8, 8, 8, 1), (5, 5, 5, 1, 8))
    want = np.asarray(jphase.phase_conv3d(jnp.asarray(x, jnp.bfloat16),
                                          jnp.asarray(w, jnp.bfloat16), (2, 2, 2)), np.float32)
    got = tphase.phase_conv3d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                              (2, 2, 2)).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL16 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("xs,ks,co", [((2, 6, 6, 16, 8), (3, 3, 3), 16),
                                      ((1, 4, 5, 8, 16), (3, 3, 3), 32),
                                      ((2, 4, 4, 12, 4), (1, 3, 5), 8)])
def test_depth_packed_conv_matches_jax(monkeypatch, xs, ks, co):
    """The depth-packed conv (f from _depth_pack_factor, as JAX's) forward
    and VJP against JAX's _depth_packed_conv custom VJP, fp32; with
    DEPTH_PACK on, conv_weight_grad (act_conv's) takes its weight
    gradient."""
    rng = np.random.default_rng(4)
    x, w = _pair(rng, xs, ks + (xs[-1], co))
    f = tl._depth_pack_factor(xs, w.shape, (1, 1, 1))
    assert f == jl._depth_pack_factor(jnp.zeros(xs), jnp.zeros(w.shape), (1, 1, 1)) > 1
    g = rng.standard_normal(xs[:-1] + (co,)).astype(np.float32)
    want = _jax_vjp(lambda a, b: jl._depth_packed_conv(a, b, f), x, w, g)
    got = _port_vjp(lambda a, b: tl._depth_packed_conv(a, b, f), x, w, g)
    _close(got, want, TOL32)
    monkeypatch.setattr(tl, "DEPTH_PACK", True)
    wgrad = tl.conv_weight_grad(torch.from_numpy(x), torch.from_numpy(g), w.shape, 3)
    np.testing.assert_allclose(wgrad.numpy(), tl._depth_packed_wgrad(
        torch.from_numpy(x), torch.from_numpy(g), w.shape, f).numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("ndim,stride", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_subpixel_deconvs_match_jax(ndim, stride):
    """_deconv_s1_k4 / _deconv_s2_k4 (what conv_transpose_op takes for K=4)
    against JAX's, forward and VJP, fp32; and against the port's
    _plain_conv_transpose, the cuDNN form they replace."""
    rng = np.random.default_rng(5 + ndim + stride)
    xs = (2,) + (5,) * ndim + (6,)
    x, w = _pair(rng, xs, (4,) * ndim + (3, 6))
    jfn = jl._deconv_s1_k4 if stride == 1 else jl._deconv_s2_k4
    tfn = tl._deconv_s1_k4 if stride == 1 else tl._deconv_s2_k4
    g = rng.standard_normal((2,) + (5 * stride,) * ndim + (3,)).astype(np.float32)
    want = _jax_vjp(lambda a, b: jfn(a, b, ndim), x, w, g)
    got = _port_vjp(lambda a, b: tfn(a, b, ndim), x, w, g)
    _close(got, want, TOL32)
    oracle = _port_vjp(lambda a, b: tl._plain_conv_transpose(a, b, (stride,) * ndim, ndim),
                       x, w, g)
    _close(got, oracle, TOL32)
    assert tl._deconv_route((4,) * ndim, (stride,) * ndim) == f"s{stride}_k4"


def test_subpixel_deconv_bf16_matches_jax():
    """The 512^2 heads' form in bf16: each output rounded once in both."""
    rng = np.random.default_rng(9)
    x, w = _pair(rng, (2, 8, 8, 32), (4, 4, 16, 32), scale=0.1)
    want = np.asarray(jl._deconv_s2_k4(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(w, jnp.bfloat16), 2), np.float32)
    got = tl._deconv_s2_k4(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(),
                           2).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL16 * np.abs(want).max(), rtol=0)


# ---------------------------------------------------------------------------
# routes
# ---------------------------------------------------------------------------
_JAX_ROUTES = [(pallas_conv3d, "nc_conv3d", "conv3d"), (jphase, "phase_conv3d", "phase"),
               (jl, "_depth_packed_conv", "depth_pack"), (pallas_conv2d, "wc_conv2d", "conv2d"),
               (pallas_winograd, "wino_conv2d", "wino"), (jwino, "winograd3x3", "wino_xla"),
               (jl, "_deconv_s1_k4", "s1_k4"), (jl, "_deconv_s2_k4", "s2_k4")]


def _record_jax(monkeypatch):
    """Log every JAX ``_conv_op`` / ``_conv_transpose_op`` call as [kind,
    input shape, kernel shape, stride, route]: the route is the first route
    function the call reaches (None: the plain conv)."""
    log = []
    for name, kind in (("_conv_op", "conv"), ("_conv_transpose_op", "deconv")):
        orig = getattr(jl, name)

        def entry(x, w, stride, ndim, _orig=orig, _kind=kind):
            log.append([_kind, tuple(x.shape), tuple(w.shape), tuple(stride), None])
            return _orig(x, w, stride, ndim)

        monkeypatch.setattr(jl, name, entry)
    for mod, name, route in _JAX_ROUTES:
        orig = getattr(mod, name)

        def hit(*a, _orig=orig, _route=route, **k):
            if log and log[-1][4] is None:
                log[-1][4] = _route
            return _orig(*a, **k)

        monkeypatch.setattr(mod, name, hit)
    return log


def _record_port(monkeypatch):
    log = []
    kernel_for, deconv_route = tl._kernel_for, tl._deconv_route

    def conv_route(x, w_shape, stride, ndim):
        route = kernel_for(x, w_shape, stride, ndim)
        log.append(["conv", tuple(x.shape), tuple(w_shape), tuple(stride), route])
        return route

    monkeypatch.setattr(tl, "_kernel_for", conv_route)

    def deconv(x, w, stride, ndim):
        log.append(["deconv", tuple(x.shape), tuple(w.shape), tuple(stride),
                    deconv_route(w.shape[:ndim], tuple(stride))])
        return orig_op(x, w, stride, ndim)

    orig_op = tl.conv_transpose_op
    monkeypatch.setattr(tl, "conv_transpose_op", deconv)
    return log


# The flags forced on, three ways: (JAX's flags, the port's).
FLAG_SETS = {
    "pallas": (dict(PALLAS_CONV3D=True, PHASE_CONV3D=True, DEPTH_PACK=True, WINOGRAD_2D="pallas",
                    PALLAS_CONV2D=False),
               dict(CUDA_CONV3D=True, PHASE_CONV3D=True, DEPTH_PACK=True, WINOGRAD_2D="pallas",
                    CUDA_CONV2D=False)),
    "xla_all_no_k2": (dict(PALLAS_CONV3D=False, PHASE_CONV3D="all", DEPTH_PACK=True,
                           WINOGRAD_2D="xla", PALLAS_CONV2D=False),
                      dict(CUDA_CONV3D=False, PHASE_CONV3D="all", DEPTH_PACK=True,
                           WINOGRAD_2D="xla", CUDA_CONV2D=False)),
    "conv2d": (dict(PALLAS_CONV3D=True, PHASE_CONV3D=True, DEPTH_PACK=True, WINOGRAD_2D=True,
                    PALLAS_CONV2D=True),
               dict(CUDA_CONV3D=True, PHASE_CONV3D=True, DEPTH_PACK=True, WINOGRAD_2D=True,
                    CUDA_CONV2D=True)),
}

SHADER_KW = dict(new_size=32, res1_blocks=1, res2_blocks=1, res3_blocks=1, base=16)
TEX_KW = dict(tex_base=8, tex_grid=16, enc_channels=(8, 16, 32), new_size=32, res1_blocks=1,
              res2_blocks=1, res3_blocks=1, base=32)


def _families():
    """(name, JAX forward on abstract params and inputs, JAX param init,
    port module and forward, input shapes) per model family."""
    jcfg, tcfg = jshader.ShaderConfig(**SHADER_KW), tshader.ShaderConfig(**SHADER_KW)
    jt, tt = jtex.TextureFaceConfig(**TEX_KW), ttex.TextureFaceConfig(**TEX_KW)

    def jshader_fwd(m, cam):
        return jshader.shader_rendernet(m, cam, jcfg)

    def jtex_fwd(m, z, cam):
        return (jtex.texture_decoder(m, z, tex_base=jt.tex_base, tex_grid=jt.tex_grid),
                jtex.texture_face_rendernet(m, cam, jt))

    def jrecon_fwd(m, zs, zt, cam):
        return jdec.shape_decoder_3d(m, zs), jdec.recon_texture_decoder(m, zt), \
            jdec.recon_rendernet(m, cam)

    return {
        "shader": (jshader_fwd, lambda k: jshader.init_shader_params(k, jcfg),
                   lambda: tshader.init_shader_params(0, tcfg, device="cpu"),
                   lambda net, cam: net(cam), [(8, 32, 32, 32, 1)]),
        "texture": (jtex_fwd, lambda k: jtex.init_texture_face_params(k, jt),
                    lambda: ttex.init_texture_face_params(0, tt, device="cpu"),
                    lambda net, z, cam: (ttex.texture_decoder(net, z), net(cam)),
                    [(8, 199), (8, 32, 32, 32, 5)]),
        "recon": (jrecon_fwd,
                  lambda k: {**jdec.init_shape_decoder_params(k),
                             **jdec.init_recon_texture_decoder_params(k),
                             **jdec.init_recon_rendernet_params(k, new_size=32)},
                  lambda: torch.nn.ModuleList([tdec.init_shape_decoder_params(0, device="cpu"),
                                               tdec.init_recon_texture_decoder_params(
                                                   0, device="cpu"),
                                               tdec.init_recon_rendernet_params(
                                                   0, new_size=32, device="cpu")]),
                  lambda nets, zs, zt, cam: (nets[0](zs), nets[1](zt), nets[2](cam)),
                  [(1, 200), (1, 199), (2, 32, 32, 32, 5)]),
    }


def _runs(log):
    """``log`` with each run of identical entries kept once."""
    return [r for i, r in enumerate(log) if i == 0 or r != log[i - 1]]


@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
@pytest.mark.parametrize("family", ["shader", "texture", "recon"])
def test_route_census_matches_jax(monkeypatch, family, flags):
    """Every conv and deconv of the family's forward, in order: the same
    input and kernel shapes, stride and route in both packages. The port
    runs its forward on the CPU (the kernels' plain versions); JAX's
    routes come from jax.eval_shape. JAX's recon renderer runs its res
    stacks as a lax.scan, traced once, so runs of identical calls count
    once on both sides."""
    jfwd, jinit, tnet, tfwd, shapes = _families()[family]
    jflags, tflags = FLAG_SETS[flags]
    pshapes = jax.eval_shape(jinit, jax.random.PRNGKey(0))
    for k, v in jflags.items():
        monkeypatch.setattr(jl, k, v)
    jlog = _record_jax(monkeypatch)
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    jax.eval_shape(lambda p, *a: jfwd(jl.Module(params=p), *a), pshapes, *specs)

    for k, v in tflags.items():
        monkeypatch.setattr(tl, k, v)
    net = tnet()
    tlog = _record_port(monkeypatch)
    rng = np.random.default_rng(0)
    with torch.no_grad():
        tfwd(net, *(torch.from_numpy(rng.random(s).astype(np.float32)) for s in shapes))
    tlog, jlog = _runs(tlog), _runs(jlog)
    assert [r[:4] for r in tlog] == [r[:4] for r in jlog]
    assert [r[4] for r in tlog] == [r[4] for r in jlog]
    routes = {r[4] for r in jlog}
    assert {"s2_k4", "s1_k4"} & routes  # every family has K=4 deconvs
    if family != "recon":
        assert "phase" in routes


# WINOGRAD_2D: (x shape, the route JAX's _conv_op takes) per value
WINO_CASES = [(False, (8, 4, 4, 256), None), (True, (8, 4, 4, 256), "wino_xla"),
              ("xla", (1, 4, 4, 256), "wino_xla"), ("pallas", (8, 4, 4, 256), "wino"),
              ("pallas", (1, 4, 4, 256), None), (True, (8, 4, 4, 128), None)]


@pytest.mark.parametrize("value,xs,route", WINO_CASES)
def test_winograd_values_route_and_output_like_jax(monkeypatch, value, xs, route):
    """Each value of WINOGRAD_2D: the port's route equals the one JAX's
    _conv_op takes (True / "xla": the plain Winograd expression inside
    winograd3x3_supported, any batch; "pallas": K3 inside its envelope),
    and the outputs and VJPs agree; fp32, Winograd's transforms add
    roundoff to 9*256-term sums: 1e-4."""
    monkeypatch.setattr(jl, "WINOGRAD_2D", value)
    monkeypatch.setattr(tl, "WINOGRAD_2D", value)
    rng = np.random.default_rng(6)
    x, w = _pair(rng, xs, (3, 3, xs[-1], xs[-1]), scale=0.05)
    jlog = _record_jax(monkeypatch)
    g = rng.standard_normal(xs).astype(np.float32)
    want = _jax_vjp(lambda a, b: jl._conv_op(a, b, (1, 1), 2), x, w, g)
    assert jlog[0][4] == route
    assert tl._kernel_for(torch.from_numpy(x), w.shape, (1, 1), 2) == route
    got = _port_vjp(lambda a, b: tl.conv_op(a, b, (1, 1), 2), x, w, g)
    _close(got, want, 1e-4)
    gw = tl.conv_weight_grad(torch.from_numpy(x), torch.from_numpy(g), w.shape, 2)
    np.testing.assert_allclose(gw.numpy(), want[2], atol=1e-4 * np.abs(want[2]).max(), rtol=0)


def test_phase_route_gate_and_cpu_auto(monkeypatch):
    """PHASE_CONV3D: "auto" is off for CPU tensors (JAX's off the TPU);
    True gates on the phase-folded fan-in (<= PHASE_MAX_FANIN), "all"
    does not; the phase route is checked after K2 and before depth
    packing, as JAX's _conv_op does."""
    x1, x5 = torch.zeros(1, 8, 8, 8, 1), torch.zeros(1, 8, 8, 8, 5)
    w1, w5 = (5, 5, 5, 1, 8), (5, 5, 5, 5, 8)
    assert tl._kernel_for(x1, w1, (2, 2, 2), 3) is None
    monkeypatch.setattr(tl, "PHASE_CONV3D", True)
    assert tl._kernel_for(x1, w1, (2, 2, 2), 3) == "phase"
    assert tl._kernel_for(x5, w5, (2, 2, 2), 3) is None  # fan-in 40
    monkeypatch.setattr(tl, "PHASE_CONV3D", "all")
    assert tl._kernel_for(x5, w5, (2, 2, 2), 3) == "phase"
    monkeypatch.setattr(tl, "DEPTH_PACK", True)
    x3 = torch.zeros(1, 8, 8, 16, 16)
    assert tl._kernel_for(x3, (3, 3, 3, 16, 32), (1, 1, 1), 3) == "depth_pack"
    monkeypatch.setattr(tl, "CUDA_CONV3D", True)
    assert tl._kernel_for(x3, (3, 3, 3, 16, 32), (1, 1, 1), 3) == "conv3d"


def test_shader_forward_with_rewrites_matches_jax(monkeypatch):
    """A reduced shader's forward with the phase and depth-pack routes on
    in both packages (K2 off, so depth packing takes the 3D stacks):
    images within 2e-5 of JAX's (fp32 through ~20 convs)."""
    for mod, name, v in ((jl, "PALLAS_CONV3D", False), (jl, "PHASE_CONV3D", True),
                         (jl, "DEPTH_PACK", True), (tl, "CUDA_CONV3D", False),
                         (tl, "PHASE_CONV3D", True), (tl, "DEPTH_PACK", True)):
        monkeypatch.setattr(mod, name, v)
    kw = dict(new_size=32, res1_blocks=1, res2_blocks=1, res3_blocks=1, base=4)
    jcfg = jshader.ShaderConfig(**kw)
    rng = np.random.default_rng(7)
    shapes = jax.eval_shape(lambda k: jshader.init_shader_params(k, jcfg), jax.random.PRNGKey(0))
    jparams = {k: (rng.uniform(0.05, 0.3, v.shape) if k.endswith("alpha")
                   else np.full(v.shape, 0.001) if k.endswith("biases")  # JAX's init
                   else rng.standard_normal(v.shape) / np.prod(v.shape[:-1]) ** 0.5
                   ).astype(np.float32) for k, v in sorted(shapes.items())}
    cam = (rng.random((2, 32, 32, 32, 1)) > 0.6).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, c: jshader.shader_rendernet(jl.Module(params=p), c, jcfg))(
        {k: jnp.asarray(v) for k, v in jparams.items()}, jnp.asarray(cam)))
    net = load_jax_params(tshader.init_shader_params(0, tshader.ShaderConfig(**kw),
                                                     device="cpu"), jparams)
    with torch.no_grad():
        got = net(torch.from_numpy(cam)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
