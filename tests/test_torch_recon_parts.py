"""The inverse renderer's pieces against the JAX package's, on the CPU:
differentiable Phong shading (ties included), the fully connected layer and
the relu res block, the strict loader's key sets, the reference weight
directory reader, the PNG decoder, and the pose-hypothesis helpers.
Inputs come from numpy seeds; tolerances are stated per test.
"""
from __future__ import annotations

import math
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.compat import tf_import as jtf
from rendernet_tpu.models import decoders as jdec
from rendernet_tpu.nn import layers as jlayers
from rendernet_tpu.ops import phong as jphong
from rendernet_tpu.recon import inverse as jinv
from rendernet_tpu_torch.compat import tf_import as ttf
from rendernet_tpu_torch.compat.jax_params import jax_params_from_module, load_jax_params
from rendernet_tpu_torch.models import decoders as tdec
from rendernet_tpu_torch.nn import layers as tlayers
from rendernet_tpu_torch.ops import phong as tphong
from rendernet_tpu_torch.recon import inverse as tinv
from rendernet_tpu_torch.utils.image import decode_image, encode_png

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# Phong
# ---------------------------------------------------------------------------
def _phong_inputs(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0.05, 0.95, (2, 6, 5, 3)).astype(np.float32)
    imgs[0, 1, 2] = (1.0, 0.5, 0.5)  # normal (1, 0, 0): N.L = 0 under a light at the zenith
    imgs[1, 3, 1] = (1.0, 1.0, 1.0)  # white: the composite rounds to exactly 1.0
    az = rng.uniform(3.5, 5.5, (2, 1)).astype(np.float32)
    return imgs, az


@pytest.mark.parametrize("elevation", [0.0, (90 - 105) * math.pi / 180.0, 1.1])
def test_phong_composite_and_gradients_match_jax(elevation):
    """phong_composite(generate_light_pos(azimuth)) on a white background,
    values and gradients w.r.t. the normal image and the light azimuth
    against jax.grad, fp32. At elevation 0 the light is the zenith, so the
    pixel with normal (1, 0, 0) has N.L = 0 exactly: both max(N.L, 0) and
    the shading's clip at 0 sit on their ties, where jnp.maximum and
    jnp.clip pass half the gradient each, as torch.maximum / torch.minimum
    do (torch.clamp would pass all of it, torch.relu none). The white
    pixel's composite rounds to exactly 1.0, on the final clip's tie (its
    gradient underflows to 0 in the mask's sigmoid on both sides). Same
    fp32 ops: values 1e-6 absolute; gradients 1e-5 of their max (the soft
    mask's slope is up to 64), and 1e-5 relative at the two tie pixels."""
    imgs, az = _phong_inputs(4)
    w = np.random.default_rng(5).standard_normal(imgs.shape).astype(np.float32)

    def jf(im, a):
        light = jphong.generate_light_pos(a, elevation, 2)
        return jphong.phong_composite(im, light, jnp.ones((2, 3)), 0.1, 0.9,
                                      black_background=False, with_mask=True)

    want = np.asarray(jf(jnp.asarray(imgs), jnp.asarray(az)))
    jgi, jga = jax.grad(lambda im, a: jnp.sum(jf(im, a) * w), argnums=(0, 1))(
        jnp.asarray(imgs), jnp.asarray(az))
    ti = torch.from_numpy(imgs).requires_grad_()
    ta = torch.from_numpy(az).requires_grad_()
    light = tphong.generate_light_pos(ta, elevation, 2)
    got = tphong.phong_composite(ti, light, torch.ones(2, 3), 0.1, 0.9,
                                 black_background=False, with_mask=True)
    tgi, tga = torch.autograd.grad((got * torch.from_numpy(w)).sum(), (ti, ta))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=0)
    assert want[1, 3, 1].tolist() == [1.0, 1.0, 1.0]
    jgi, jga = np.asarray(jgi), np.asarray(jga)
    np.testing.assert_allclose(tgi.numpy(), jgi, atol=1e-5 * np.abs(jgi).max(), rtol=0)
    np.testing.assert_allclose(tga.numpy(), jga, atol=1e-5 * np.abs(jga).max() + 1e-12, rtol=0)
    np.testing.assert_allclose(tgi[1, 3, 1].numpy(), jgi[1, 3, 1], rtol=1e-5, atol=0)
    if elevation == 0.0:
        np.testing.assert_allclose(want[0, 1, 2], np.float32(0.1), rtol=0, atol=0)
        np.testing.assert_allclose(tgi[0, 1, 2].numpy(), jgi[0, 1, 2], rtol=1e-5, atol=0)
        assert jgi[0, 1, 2, 2] != 0


def test_phong_masks_and_shading_match_jax():
    """The two soft masks and the clipped diffuse term, and the black
    background composite, fp32: 1e-6 absolute."""
    imgs, _ = _phong_inputs(6)
    light = np.array([[0.3, -0.5, 0.8], [-0.6, 0.2, 0.7]], np.float32)
    col = np.array([[1.0, 0.9, 0.8], [0.7, 1.0, 1.0]], np.float32)
    ji, jl, jc = jnp.asarray(imgs), jnp.asarray(light), jnp.asarray(col)
    ti, tl, tc = torch.from_numpy(imgs), torch.from_numpy(light), torch.from_numpy(col)
    pairs = [
        (jphong.mask_black_background(ji), tphong.mask_black_background(ti)),
        (jphong.mask_white_background(ji), tphong.mask_white_background(ti)),
        (jphong.phong_shading(ji, jl, jc, 1.3), tphong.phong_shading(ti, tl, tc, 1.3)),
        (jphong.phong_composite(ji, jl, jc, 0.2, 0.8, black_background=True),
         tphong.phong_composite(ti, tl, tc, 0.2, 0.8, black_background=True)),
        (jphong.phong_composite(ji, jl, jc, 0.2, 0.8, with_mask=False),
         tphong.phong_composite(ti, tl, tc, 0.2, 0.8, with_mask=False)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("background", ["white", "black"])
def test_np_phong_composite_matches_jax(background):
    """The CLIs' host-side composite, both backgrounds: the same float64
    numpy on both sides."""
    imgs, _ = _phong_inputs(7)
    light = np.array([[0.2, 0.4, 0.9]])
    col = np.array([[1.0, 1.0, 1.0]])
    for with_mask in (True, False):
        np.testing.assert_allclose(
            tphong.np_phong_composite(imgs, light, col, 0.0, 1.0, background, with_mask),
            jphong.np_phong_composite(imgs, light, col, 0.0, 1.0, background, with_mask),
            rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def test_fully_connected_matches_jax():
    """x @ W + b with JAX's (in, out) weights carried into the port's (out,
    in) layout; value and input gradient, fp32 sums of 7 products: 1e-6."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 7)).astype(np.float32)
    params = {"fc/weights": rng.standard_normal((7, 5)).astype(np.float32),
              "fc/biases": rng.standard_normal(5).astype(np.float32)}

    def jf(xx):
        return jlayers.fully_connected(jlayers.Module(params=params), xx, 5, scope="fc")

    fc = tlayers.FullyConnected(7, 5, torch.Generator().manual_seed(0))
    assert tuple(fc.weight.shape) == (5, 7)
    net = torch.nn.ModuleDict({"fc": fc})
    load_jax_params(net, params)
    tx = torch.from_numpy(x).requires_grad_()
    y = net["fc"](tx)
    (gx,) = torch.autograd.grad(y.sum(), tx)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jf(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jax.grad(lambda v: jnp.sum(jf(v)))(
        jnp.asarray(x))), atol=1e-6)
    out = jax_params_from_module(net)
    np.testing.assert_array_equal(out["fc/weights"], params["fc/weights"])


@pytest.mark.parametrize("ndim", [2, 3])
def test_relu_res_block_matches_jax(ndim):
    """The pretrained-weights res block (conv, ReLU, conv, + skip; no alpha):
    value and the gradients of input and every parameter against jax.grad,
    fp32. The first conv's kernel and bias are zero, so its output is exactly
    0 everywhere and the ReLU sits on its tie: jnp.maximum passes half the
    gradient there, and so must the port (torch.relu would pass none).
    Sums of 9 or 27 x 8 products in other orders: 1e-5 of each max."""
    rng = np.random.default_rng(9 + ndim)
    c = 8
    xs = (2, 6, 5, c) if ndim == 2 else (2, 4, 5, 3, c)
    k = (3,) * ndim
    x = rng.standard_normal(xs).astype(np.float32)
    params = {
        "blk/con1_3X3/weights": np.zeros(k + (c, c), np.float32),
        "blk/con1_3X3/biases": np.zeros(c, np.float32),
        "blk/conv2_3x3/weights": (0.2 * rng.standard_normal(k + (c, c))).astype(np.float32),
        "blk/conv2_3x3/biases": rng.standard_normal(c).astype(np.float32),
    }
    cot = rng.standard_normal(xs).astype(np.float32)
    block_fn = jlayers.res_block_2d if ndim == 2 else jlayers.res_block_3d

    def jloss(p, xx):
        y = block_fn(jlayers.Module(params=p), xx, c, "blk", activation="relu")
        return jnp.sum(y * cot), y

    (_, want), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        {n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x))
    blk = tlayers.ResBlock(c, ndim, torch.Generator().manual_seed(0), activation="relu")
    assert not hasattr(blk, "alpha")
    net = load_jax_params(torch.nn.ModuleDict({"blk": blk}), params)
    tx = torch.from_numpy(x).requires_grad_()
    y = net["blk"](tx)
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                [tx] + [p for _, p in net.named_parameters()])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               atol=1e-5 * np.abs(np.asarray(want)).max())
    got = {"x": grads[0].numpy()}
    got.update({n: g for n, g in zip(names, grads[1:])})
    tflat = jax_params_from_module(torch.nn.ModuleDict(
        {"blk": tlayers.ResBlock(c, ndim, torch.Generator(), activation="relu")}))
    for path in params:  # parameter gradients, carried to JAX layout
        tname = path.replace("/", ".").replace("weights", "weight").replace("biases", "bias")
        g = got[tname]
        g = tlayers.to_jax_layout(g).numpy() if g.dim() >= 2 else g.numpy()
        assert g.shape == tflat[path].shape
        ref = np.asarray(jgp[path])
        np.testing.assert_allclose(g, ref, atol=1e-5 * np.abs(ref).max(), err_msg=path)
    assert np.abs(np.asarray(jgp["blk/con1_3X3/biases"])).max() > 0
    np.testing.assert_allclose(got["x"], np.asarray(jgx), atol=1e-5 * np.abs(jgx).max())


# ---------------------------------------------------------------------------
# parameter carry-over
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("net", ["decoder", "texture", "renderer"])
def test_loader_accepts_exactly_jax_key_sets(net):
    """Each port network's parameters, in JAX paths and layouts, are exactly
    the JAX init function's (keys and shapes, from jax.eval_shape) at the
    full default sizes; the strict loader refuses a dict with a key missing
    or one too many."""
    key = jax.random.PRNGKey(0)
    if net == "decoder":
        tree = jax.eval_shape(jdec.init_shape_decoder_params, key)
        module = tdec.init_shape_decoder_params(0, device="cpu")
    elif net == "texture":
        tree = jax.eval_shape(jdec.init_recon_texture_decoder_params, key)
        module = tdec.init_recon_texture_decoder_params(0, device="cpu")
    else:
        tree = jax.eval_shape(jdec.init_recon_rendernet_params, key)
        module = tdec.init_recon_rendernet_params(0, device="cpu")
    flat = jax_params_from_module(module)
    assert {p: v.shape for p, v in flat.items()} == {p: tuple(s.shape) for p, s in tree.items()}
    load_jax_params(module, flat)
    first = sorted(flat)[0]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(module, {k: v for k, v in flat.items() if k != first})
    with pytest.raises(KeyError, match="unexpected"):
        load_jax_params(module, {**flat, "encoder/extra/weights": flat[first]})


def test_reference_weight_dir_reads_jax_export(tmp_path):
    """A directory written by JAX's export_reference_weight_dir reads back
    into the same flat dict through the port's reader, with the JAX
    reader's keys, values and non-strict fill of a missing key."""
    rng = np.random.default_rng(11)
    tree = jax.eval_shape(lambda k: jdec.init_shape_decoder_params(k, z_dim=16),
                          jax.random.PRNGKey(0))
    params = {p: rng.standard_normal(s.shape).astype(np.float32) for p, s in tree.items()}
    jtf.export_reference_weight_dir(params, str(tmp_path))
    wd = ttf.load_reference_weight_dir(str(tmp_path))
    jwd = jtf.load_reference_weight_dir(str(tmp_path))
    assert sorted(wd) == sorted(jwd) == sorted(jtf.npz_key_for_path(p) for p in params)
    assert "g_zP_g_gc1_weights" in wd
    got = ttf.params_from_weight_dict(params, wd)
    for p, v in params.items():
        np.testing.assert_array_equal(got[p], v)
    template = {p: np.zeros_like(v) for p, v in params.items()}
    drop = sorted(wd)[0]
    partial = {k: v for k, v in wd.items() if k != drop}
    got = ttf.params_from_weight_dict(template, partial, strict=False)
    want = jtf.params_from_weight_dict(template, partial, strict=False)
    assert sorted(got) == sorted(want)
    for p in got:
        np.testing.assert_array_equal(got[p], np.asarray(want[p]))
    with pytest.raises(KeyError):
        ttf.params_from_weight_dict(template, partial)
    assert ttf.npz_key_for_path("encoder/Image/e_conv6_1/alpha") == "Image_e_conv6_1_alpha"


# ---------------------------------------------------------------------------
# PNG decoding
# ---------------------------------------------------------------------------
def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_all_filters(img: np.ndarray) -> bytes:
    """An 8-bit PNG whose row y uses filter type y % 5 (none, sub, up,
    average, Paeth), each applied as the PNG specification defines it."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * ch).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        ft, cur = y % 5, rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        out = []
        for x in range(w * ch):
            a = cur[x - ch] if x >= ch else 0
            c = up[x - ch] if x >= ch else 0
            pred = [0, a, up[x], (a + up[x]) // 2, _paeth(a, up[x], c)][ft]
            out.append((cur[x] - pred) % 256)
        raw += bytes([ft] + out)
    color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(9, 7), (9, 7, 2), (11, 6, 3), (10, 5, 4)])
def test_decode_image_round_trips(shape):
    """decode_image inverts encode_png (grey, RGB, RGBA) and a PNG that uses
    all five filter types (grey+alpha too), exactly."""
    img = np.random.default_rng(12).integers(0, 256, shape).astype(np.uint8)
    if len(shape) == 2 or shape[2] != 2:
        np.testing.assert_array_equal(decode_image(encode_png(img)), img)
    np.testing.assert_array_equal(decode_image(_png_all_filters(img)), img)
    with pytest.raises(ValueError):
        decode_image(b"GIF89a" + bytes(20))


# ---------------------------------------------------------------------------
# pose hypotheses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", ["corners", "cross"])
def test_pose_hypotheses_match_jax(shape):
    """create_param_center, initial_latents (the same numpy RNG, so the same
    texture codes) and subdivided_latents: identical float32 values."""
    for args in ((270, 60, 90, 30), (350, 60, 75, 30), (10, 7.5, 100, 0.0)):
        np.testing.assert_array_equal(
            tinv.create_param_center(*args, batch_size=5, shape=shape),
            jinv.create_param_center(*args, batch_size=5, shape=shape))
    kw = dict(z_dim=16, batch_size=5, grid_shape=shape)
    jlat = jinv.initial_latents(jinv.ReconConfig(**kw), seed=3)
    tlat = tinv.initial_latents(tinv.ReconConfig(**kw), seed=3, device="cpu")
    for t, j in zip(tlat, jlat):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    rng = np.random.default_rng(13)
    best = [rng.standard_normal(np.shape(x)).astype(np.float32) for x in jlat]
    jsub = jinv.subdivided_latents(jinv.Latents(*(jnp.asarray(b) for b in best)), 3, 30.0, 15.0,
                                   jinv.ReconConfig(**kw))
    tsub = tinv.subdivided_latents(tinv.Latents(*(torch.from_numpy(b) for b in best)), 3, 30.0,
                                   15.0, tinv.ReconConfig(**kw))
    for t, j in zip(tsub, jsub):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
