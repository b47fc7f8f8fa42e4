"""The CUDA kernels against their plain versions, on the card.

These need a CUDA card and the CUDA toolkit (the kernels build with nvcc at
first use); without a card each test skips with that reason. On the card
they run with ``python -m pytest tests/test_torch_cuda.py -q``;
``chip_smoke.py`` covers the same kernels at the serving and training
paths' shapes. Tolerances: fp32 results may differ by summation order (1e-4
of max|y|); bf16 results by one output rounding (2^-7 of max|y|, two bf16
ulps); the weight gradients (K2w, K6, K5w) are fp32 sums of exact
products in either dtype (1e-4 of max|gw|). The fused Adam update repeats
the per-tensor form's arithmetic and is held to it bit for bit.
"""
from __future__ import annotations

import math

import pytest
import torch

from rendernet_tpu_torch.ops import (
    cuda_adam,
    cuda_conv2d,
    cuda_conv3d,
    cuda_resample,
    cuda_winograd,
)
from rendernet_tpu_torch.models import param_shapes
from rendernet_tpu_torch.models.shader import ShaderConfig
from rendernet_tpu_torch.models.texture_face import TextureFaceConfig
from rendernet_tpu_torch.train import optim

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resample_pass_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    vol = torch.randn(3, 1000, 100, generator=g, device=cuda).to(dtype)
    u = torch.rand(3, 4, generator=g, device=cuda) * 2 - 1
    params = torch.stack([1 + 0.4 * u[:, 0], 0.4 * u[:, 1], 0.4 * u[:, 2], 20 * u[:, 3]], -1)
    before = cuda_resample.launches
    before_shape = cuda_resample.launches_by_shape[(3, 1000, 100, 37)]
    before_path = cuda_resample.launches_by_path["scalar"]
    got = cuda_resample.apply_interp_pass(vol, params, 40, 37)
    assert cuda_resample.launches == before + 1
    assert cuda_resample.launches_by_shape[(3, 1000, 100, 37)] == before_shape + 1
    assert cuda_resample.launches_by_path["scalar"] == before_path + 1  # rows of 100 values
    _close(got, cuda_resample.interp_pass_plain(vol, params, 40, 37), dtype)


# K2 / K2w cases: every (C, co) of C in {16, 24, 32} and co in {16, 32, 64};
# batches 1, 5 and 24 (24 at the res1 training shape); W and D that are not
# multiples of the bf16 kernels' 8 x 32 tile (or fp32's 4 x 32); C % 8 != 0
# (the bf16 planes staged element by element); C = 8 and C > 32 (K2's
# CUDA-core kernel in either dtype, K2w's two channel slices).
CONV3D_CASES = [((1, 4, 8, 32, c), co) for c in (16, 24, 32) for co in (16, 32, 64)] + [
    ((5, 8, 8, 32, 32), 32), ((24, 64, 64, 32, 32), 32), ((2, 5, 10, 24, 24), 64),
    ((2, 4, 8, 20, 32), 32), ((2, 4, 8, 16, 20), 32), ((1, 4, 8, 8, 16), 16),
    ((2, 3, 4, 8, 8), 32), ((2, 3, 8, 32, 48), 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xs,co", CONV3D_CASES)
def test_conv3d_kernel(cuda, dtype, xs, co):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(*xs, generator=g, device=cuda).to(dtype)
    w = (torch.randn(3, 3, 3, xs[-1], co, generator=g, device=cuda) * 0.1).to(dtype)
    before = cuda_conv3d.launches_by_shape[tuple(xs), co]
    got = cuda_conv3d.nc_conv3d(x, w)
    assert cuda_conv3d.launches_by_shape[tuple(xs), co] == before + 1
    _close(got, cuda_conv3d.nc_conv3d_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xs,co", [
    ((8, 6, 70, 256), 128),     # ragged: 840 tiles, 35 per row (odd), K = 128 != C
    ((8, 10, 14, 384), 256),    # 280 tiles: not a multiple of 128, blocks span images
    ((8, 4, 8, 256), 512),      # K > C, 64 tiles: one partial tile block
    ((24, 8, 8, 512), 384),     # batch 24, 384 tiles: three whole tile blocks
    ((8, 16, 16, 1024), 1024),  # the res2 width: 16 channel stages per frequency
])
def test_winograd_kernel(cuda, dtype, xs, co):
    """K3 against its plain version, one launch counted per call."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(*xs, generator=g, device=cuda).to(dtype)
    w = (torch.randn(3, 3, xs[-1], co, generator=g, device=cuda) * 0.05).to(dtype)
    before = cuda_winograd.launches_by_shape[tuple(xs), co]
    got = cuda_winograd.wino_conv2d(x, w)
    assert cuda_winograd.launches_by_shape[tuple(xs), co] == before + 1
    _close(got, cuda_winograd.wino_conv2d_plain(x, w), dtype)


@pytest.mark.parametrize("op,xs,co", [
    ("wino", (8, 6, 10, 48), 64),      # C % 32 != 0 (half a stage), K % 128 != 0
    ("wino", (8, 4, 8, 272), 192),     # both again: 3 channel blocks, the pair's 4th past K
    ("wino", (8, 6, 70, 256), 320),    # K % 128 != 0 at a ragged tile count
    ("conv3d", (2, 3, 10, 16, 18), 32),  # C % 4 != 0 (element-wise staging), W and D partial rows
    ("conv3d", (2, 3, 10, 16, 18), 64),  # the same in two slices of 32 output channels
    ("conv3d", (3, 2, 8, 40, 12), 16),   # C % 4 == 0 below 16, a partial second D tile, H = 2
])
def test_fp32_tensor_core_edges(cuda, op, xs, co):
    """The fp32 forms of K3 and K2 (three TF32 passes) at their tiles'
    edges, against their plain versions at 1e-4 of max|y|, one launch each.
    The K3 shapes lie outside the Winograd envelope (which keeps C and K
    multiples of 128): the forward wrapper takes what the kernel takes."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(*xs, generator=g, device=cuda)
    c = xs[-1]
    if op == "wino":
        w = torch.randn(3, 3, c, co, generator=g, device=cuda) / (3 * c ** 0.5)
        counts, fwd, plain = (cuda_winograd.launches_by_shape, cuda_winograd.wino_conv2d_forward,
                              cuda_winograd.wino_conv2d_plain)
    else:
        w = torch.randn(3, 3, 3, c, co, generator=g, device=cuda) / (27 * c) ** 0.5
        counts, fwd, plain = (cuda_conv3d.launches_by_shape, cuda_conv3d.nc_conv3d_forward,
                              cuda_conv3d.nc_conv3d_plain)
    before = counts[tuple(xs), co]
    got = fwd(x, w)
    assert counts[tuple(xs), co] == before + 1
    _close(got, plain(x, w), torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "recon"])
def test_resample_pass_adjoint_kernel(cuda, dtype, case):
    """K4 against its plain version: a ragged pass ([3,1000,100], a 37-lane
    window, 4 taps, negative alpha: a deferred flip) and a recon-shaped one
    ([5,16384,128], 6 taps); gv in the volume's dtype, gp in fp32."""
    bc, r, lanes, ol, db, taps, sign = ((3, 1000, 100, 37, 40, 4, -1) if case == "ragged"
                                        else (5, 16384, 128, 128, 128, 6, 1))
    g = torch.Generator(device=cuda).manual_seed(6)
    vol = torch.randn(bc, r, lanes, generator=g, device=cuda).to(dtype)
    u = torch.rand(bc, 4, generator=g, device=cuda) * 2 - 1
    alpha = sign * (1 + 0.4 * u[:, 0])
    delta = 20 * u[:, 3] if sign > 0 else lanes - 1 - 20 * u[:, 3]
    params = torch.stack([alpha, 0.4 * u[:, 1], 0.4 * u[:, 2], delta], -1)
    cot = torch.randn(bc, r, ol, generator=g, device=cuda).to(dtype)
    key = (bc, r, lanes, ol, taps)
    path = "scalar" if case == "ragged" else "bulk"
    before = cuda_resample.bwd_launches_by_shape[key]
    before_path = cuda_resample.bwd_launches_by_path[path]
    gv, gp = cuda_resample.interp_pass_bwd(vol, params, cot, db, taps, ol)
    assert cuda_resample.bwd_launches_by_shape[key] == before + 1
    assert cuda_resample.bwd_launches_by_path[path] == before_path + 1
    want_gv, want_gp = cuda_resample.interp_pass_bwd_plain(vol, params, cot, db, taps, ol)
    _close(gv, want_gv, dtype)
    _close(gp, want_gp, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ol", [128, 64])
@pytest.mark.parametrize("sign", [1, -1])
def test_resample_bulk_path(cuda, dtype, ol, sign):
    """K1 and K4 (the compiled 3- and 6-tap bands and a 4-tap band read at
    run time) on their bulk path, rows of 128 values with a full and a
    64-lane window, alpha of both signs (negative: a folded quarter-turn
    flip): equal to their plain versions bit for bit, each launch counted on
    the bulk path."""
    bc, r, lanes, db = 4, 256, 128, 16
    g = torch.Generator(device=cuda).manual_seed(9)
    vol = torch.randn(bc, r, lanes, generator=g, device=cuda).to(dtype)
    u = torch.rand(bc, 4, generator=g, device=cuda) * 2 - 1
    delta = 20 * u[:, 3] if sign > 0 else lanes - 1 - 20 * u[:, 3]
    params = torch.stack([sign * (1 + 0.4 * u[:, 0]), 0.4 * u[:, 1], 0.4 * u[:, 2], delta], -1)
    cot = torch.randn(bc, r, ol, generator=g, device=cuda).to(dtype)
    assert cuda_resample.pass_plan(bc, r, lanes, ol, dtype, 132).path == "bulk"
    before = cuda_resample.launches_by_path["bulk"]
    got = cuda_resample.interp_pass_fwd(vol, params, db, ol)
    assert cuda_resample.launches_by_path["bulk"] == before + 1
    assert torch.equal(got, cuda_resample.interp_pass_plain(vol, params, db, ol))
    for taps in (3, 4, 6):
        before = cuda_resample.bwd_launches_by_path["bulk"]
        gv, gp = cuda_resample.interp_pass_bwd(vol, params, cot, db, taps, ol)
        assert cuda_resample.bwd_launches_by_path["bulk"] == before + 1
        want_gv, want_gp = cuda_resample.interp_pass_bwd_plain(vol, params, cot, db, taps, ol)
        assert torch.equal(gv, want_gv) and torch.equal(gp, want_gp)


def test_multipass_gradients_match_plain(cuda, monkeypatch):
    """Voxel and pose gradients of the multipass warp (K1 forward, K4
    backward) against the same warp with both wrappers swapped for their
    plain versions, fp32: 1e-4 of max|grad|."""
    g = torch.Generator(device=cuda).manual_seed(7)
    vox = torch.rand(2, 32, 32, 32, 2, generator=g, device=cuda)
    pose = torch.tensor([[0.91731, 0.26117, 1.03291], [4.1927, 1.3371, 0.9213]], device=cuda)
    cot = torch.randn(2, 64, 64, 64, 2, generator=g, device=cuda)

    def grads():
        v, p = vox.clone().requires_grad_(), pose.clone().requires_grad_()
        out = cuda_resample.rotate_resample_multipass(v, p, new_size=64)
        return torch.autograd.grad(out, (v, p), cot)

    before = cuda_resample.bwd_launches
    got = grads()
    assert cuda_resample.bwd_launches == before + 8
    monkeypatch.setattr(cuda_resample, "interp_pass_fwd", cuda_resample.interp_pass_plain)
    monkeypatch.setattr(cuda_resample, "interp_pass_bwd", cuda_resample.interp_pass_bwd_plain)
    for a, b in zip(got, grads()):
        _close(a, b, torch.float32)


def test_wrappers_raise_outside_the_envelope(cuda):
    x = torch.zeros(1, 4, 8, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="envelope"):
        cuda_conv3d.nc_conv3d(x, torch.zeros(3, 3, 3, 16, 8, device=cuda))
    with pytest.raises(ValueError, match="envelope"):
        cuda_winograd.wino_conv2d(torch.zeros(1, 4, 4, 256, device=cuda),
                                  torch.zeros(3, 3, 256, 256, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xs,co", CONV3D_CASES + [((1, 4, 8, 8, 32), 32)])
def test_conv3d_wgrad_kernel(cuda, dtype, xs, co):
    """K2w against its plain version, and run twice: the same bits (its
    partial sums are added in a fixed order, with no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(*xs, generator=g, device=cuda).to(dtype)
    gy = torch.randn(*xs[:-1], co, generator=g, device=cuda).to(dtype)
    before = cuda_conv3d.wgrad_launches_by_shape[tuple(xs), co]
    got = cuda_conv3d.nc_conv3d_wgrad(x, gy)
    again = cuda_conv3d.nc_conv3d_wgrad(x, gy)
    assert cuda_conv3d.wgrad_launches_by_shape[tuple(xs), co] == before + 2
    assert torch.equal(got, again)
    _close(got, cuda_conv3d.nc_conv3d_wgrad_plain(x, gy), torch.float32)


# fp32 K2w at its TF32 kernel's edges: W and D not whole 4 x 32 rows, C = 24
# (a 32-channel slice, 8 of it zero) and 48 (two slices), co = 64 (two
# slices), C % 4 != 0 (planes staged element by element); with the kernel's
# accumulator chains and with chains of one row.
@pytest.mark.parametrize("chain", [None, 1])
@pytest.mark.parametrize("xs,co", [((2, 5, 6, 40, 24), 64), ((3, 7, 10, 24, 24), 64),
                                   ((2, 3, 6, 48, 48), 32), ((1, 4, 8, 32, 18), 32)])
def test_conv3d_wgrad_f32_edges(cuda, xs, co, chain, monkeypatch):
    """fp32 K2w against its plain version, twice for the same bits."""
    if chain is not None:
        monkeypatch.setattr(cuda_conv3d, "WGRAD_CHAIN_ROWS_F32", chain)
    assert cuda_conv3d.nc_conv3d_supported(xs, (3, 3, 3, xs[-1], co), (1, 1, 1))
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(*xs, generator=g, device=cuda)
    gy = torch.randn(*xs[:-1], co, generator=g, device=cuda)
    before = cuda_conv3d.wgrad_launches_by_shape[tuple(xs), co]
    got = cuda_conv3d.nc_conv3d_wgrad(x, gy)
    again = cuda_conv3d.nc_conv3d_wgrad(x, gy)
    assert cuda_conv3d.wgrad_launches_by_shape[tuple(xs), co] == before + 2
    assert torch.equal(got, again)
    _close(got, cuda_conv3d.nc_conv3d_wgrad_plain(x, gy), torch.float32)


# K6 cases: batches 8, 16 and 24 with K = 128 (one 128-channel output tile)
# and 384 (three), T = B * 3 * 35 tiles (not a multiple of either step's
# 64 or 32 tiles); C = 384 (an odd count of 128-channel C blocks) with K =
# 256 (the 256-wide tile). Forms: fp32 storage, bf16 operands, bf16 storage
# with fp32 operands (the hi / lo planes).
K6_CASES = [((b, 6, 70, 256), k) for b in (8, 16, 24) for k in (128, 384)] + [
    ((8, 6, 70, 384), 256)]


@pytest.mark.parametrize("dtype,fp32_ops", [(torch.float32, False), (torch.bfloat16, False),
                                            (torch.bfloat16, True)])
@pytest.mark.parametrize("xs,k", K6_CASES)
def test_winograd_wgrad_kernel(cuda, dtype, fp32_ops, xs, k):
    """K6 against its plain version, and run twice: the same bits (its parts
    are added in a fixed order, its chains from the same threads)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(*xs, generator=g, device=cuda).to(dtype)
    gy = torch.randn(*xs[:-1], k, generator=g, device=cuda).to(dtype)
    before = cuda_winograd.wgrad_launches_by_shape[tuple(xs), k]
    got = cuda_winograd.wino_wgrad(x, gy, fp32_ops)
    again = cuda_winograd.wino_wgrad(x, gy, fp32_ops)
    assert cuda_winograd.wgrad_launches_by_shape[tuple(xs), k] == before + 2
    assert torch.equal(got, again)
    _close(got, cuda_winograd.wino_wgrad_plain(x, gy, fp32_ops), torch.float32)


@pytest.mark.parametrize("wgrad", [False, True])
def test_kernel_gradients_match_plain(cuda, wgrad, monkeypatch):
    """nc_conv3d and wino_conv2d backward on the card (K2 data gradient
    including co = 16, K2w, K3 data gradient, K6) against autograd through
    the plain versions, fp32 (TF32 off): 1e-4 of max|grad|."""
    monkeypatch.setattr(cuda_winograd, "WGRAD", wgrad)
    g = torch.Generator(device=cuda).manual_seed(5)
    for op, plain, xs, ws in (
            (cuda_conv3d.nc_conv3d, cuda_conv3d.nc_conv3d_plain, (2, 4, 8, 16, 16),
             (3, 3, 3, 16, 32)),
            (cuda_winograd.wino_conv2d, cuda_winograd.wino_conv2d_plain, (8, 6, 10, 256),
             (3, 3, 256, 256))):
        x = torch.randn(*xs, generator=g, device=cuda).requires_grad_()
        w = (torch.randn(*ws, generator=g, device=cuda) * 0.05).requires_grad_()
        y = op(x, w)
        cot = torch.randn(y.shape, generator=g, device=cuda)
        got = torch.autograd.grad(y, (x, w), cot)
        want = torch.autograd.grad(plain(x, w), (x, w), cot)
        for a, b in zip(got, want):
            _close(a, b.detach(), torch.float32)


K5_EPILOGUES = ["none", "bias", "prelu", "prelu+pre", "relu", "res"]


def _k5_args(g, cuda, dtype, shape, co, epilogue):
    """HWNC input, weights and the epilogue's keyword arguments."""
    h, wd, b, c = shape
    x = torch.randn(h, wd, b, c, generator=g, device=cuda).to(dtype)
    w = (torch.randn(3, 3, c, co, generator=g, device=cuda) / (3 * c ** 0.5)).to(dtype)
    kw = {}
    if epilogue != "none":
        kw["bias"] = (torch.randn(co, generator=g, device=cuda) * 0.1).to(dtype)
    if epilogue.startswith("prelu"):
        kw.update(act="prelu", alpha=(torch.rand(co, generator=g, device=cuda) * 0.3).to(dtype),
                  emit_pre=epilogue.endswith("pre"))
    if epilogue == "relu":
        kw["act"] = "relu"
    if epilogue == "res":
        kw["res"] = torch.randn(h, wd, b, co, generator=g, device=cuda).to(dtype)
    return x, w, kw


# K5 shapes: ragged (odd H, batch 3, ci != co, W * B = 24 of a 128-pixel
# tile); batch 5 (W * B = 80; 200 over two tiles with 128-channel tiles);
# C = 96 (a 64-channel chunk half past C, zero-filled); 192 tiles (more than
# one per SM on the persistent walk); batch 8 with W * B = 256.
K5_SHAPES = [((7, 8, 3, 384), 256), ((16, 16, 5, 256), 256), ((8, 40, 5, 256), 384),
             ((5, 9, 3, 96), 128), ((64, 64, 5, 256), 256), ((16, 32, 8, 256), 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("epilogue", K5_EPILOGUES)
@pytest.mark.parametrize("shape,co", K5_SHAPES)
def test_conv2d_kernel(cuda, dtype, epilogue, shape, co):
    """K5 with each epilogue against its plain version (K5_SHAPES)."""
    g = torch.Generator(device=cuda).manual_seed(8)
    x, w, kw = _k5_args(g, cuda, dtype, shape, co, epilogue)
    before = cuda_conv2d.launches
    got = cuda_conv2d.conv2d_hwnc(x, w, **kw)
    assert cuda_conv2d.launches == before + 1
    want = cuda_conv2d.conv2d_hwnc_plain(x, w, **kw)
    for a, b in zip(*((t,) if torch.is_tensor(t) else t for t in (got, want))):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,co", [((7, 8, 3, 384), 256), ((64, 64, 5, 256), 256),
                                      ((8, 8, 2, 128), 384), ((8, 40, 5, 256), 256),
                                      ((6, 36, 5, 128), 384), ((130, 2, 4, 128), 128),
                                      ((32, 32, 24, 512), 512)])
def test_conv2d_wgrad_kernel(cuda, dtype, shape, co):
    """K5w against its plain version, one part and several; batch 5 with W *
    B not a multiple of the 64-pixel step, 384 output channels (128-wide
    tiles), an image of 130 steps (two accumulator chains in one part), the
    res3 patch-64 training shape. Run twice: the same bits (the parts are
    added in a fixed order, with no atomics)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(*shape, generator=g, device=cuda).to(dtype)
    gz = torch.randn(*shape[:3], co, generator=g, device=cuda).to(dtype)
    before = cuda_conv2d.wgrad_launches_by_shape[tuple(shape), co]
    got = cuda_conv2d.conv2d_wgrad(x, gz)
    again = cuda_conv2d.conv2d_wgrad(x, gz)
    assert cuda_conv2d.wgrad_launches_by_shape[tuple(shape), co] == before + 2
    assert torch.equal(got, again)
    _close(got, cuda_conv2d.conv2d_wgrad_plain(x, gz), torch.float32)


# The fp32 forms' edges (TF32 wgmma on split planes): K5 with W * B not a
# multiple of the 128-pixel tile, C % 64 == 32 (C = 96, 160: whole
# 32-channel stages), co % 256 != 0 (three 128-channel tiles), its data
# gradient (flipped weights, K-major as they lie); K5w with a ragged last
# 32-pixel step (W * Bp = 36, 104, 200), batches padded to a multiple of 4
# (3 -> 4) and not (8), 384 output channels (128-wide tiles), and one part
# of several chains of one step each.
K5_F32_EDGES = [((3, 50, 3, 96), 384), ((4, 33, 5, 160), 128), ((6, 20, 7, 256), 384)]
K5W_F32_EDGES = [((5, 9, 3, 128), 256), ((4, 13, 8, 128), 128), ((3, 50, 3, 256), 384)]


@pytest.mark.parametrize("epilogue", ["none", "prelu+pre", "res"])
@pytest.mark.parametrize("shape,co", K5_F32_EDGES)
def test_conv2d_fp32_edges(cuda, epilogue, shape, co):
    """K5 fp32 at the TF32 kernel's edges against its plain version (1e-4
    of max|y|), and, where C % 128 == 0 (the data gradient's output
    channels), its data gradient's form (flipped, io-swapped weights)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    x, w, kw = _k5_args(g, cuda, torch.float32, shape, co, epilogue)
    got = cuda_conv2d.conv2d_hwnc(x, w, **kw)
    want = cuda_conv2d.conv2d_hwnc_plain(x, w, **kw)
    for a, b in zip(*((t,) if torch.is_tensor(t) else t for t in (got, want))):
        _close(a, b, torch.float32)
    if shape[-1] % 128 == 0:
        gz = torch.randn(*shape[:3], co, generator=g, device=cuda)
        wf = torch.flip(w, (0, 1)).transpose(2, 3)
        _close(cuda_conv2d.conv2d_hwnc(gz, wf), cuda_conv2d.conv2d_hwnc_plain(gz, wf),
               torch.float32)


@pytest.mark.parametrize("chain", [None, 1])
@pytest.mark.parametrize("shape,co", K5W_F32_EDGES)
def test_conv2d_wgrad_fp32_edges(cuda, shape, co, chain, monkeypatch):
    """K5w fp32 at the TF32 kernel's edges against its plain version (1e-4
    of max|gw|), with its own chains and with chains of one step; run twice
    for the same bits."""
    if chain is not None:
        monkeypatch.setattr(cuda_conv2d, "MAX_CHAIN_STEPS_F32", chain)
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(*shape, generator=g, device=cuda)
    gz = torch.randn(*shape[:3], co, generator=g, device=cuda)
    got = cuda_conv2d.conv2d_wgrad(x, gz)
    assert torch.equal(got, cuda_conv2d.conv2d_wgrad(x, gz))
    _close(got, cuda_conv2d.conv2d_wgrad_plain(x, gz), torch.float32)


def test_conv2d_wrappers_raise_outside_the_envelope(cuda):
    x = torch.zeros(4, 8, 2, 256, device=cuda)
    with pytest.raises(ValueError, match="envelope"):
        cuda_conv2d.conv2d_hwnc(x, torch.zeros(3, 3, 256, 192, device=cuda))
    with pytest.raises(ValueError, match="envelope"):
        cuda_conv2d.conv2d_hwnc(torch.zeros(4, 8, 2, 200, device=cuda),
                                torch.zeros(3, 3, 200, 256, device=cuda))
    with pytest.raises(ValueError, match="envelope"):
        cuda_conv2d.conv2d_wgrad(torch.zeros(4, 8, 2, 192, device=cuda),
                                 torch.zeros(4, 8, 2, 256, device=cuda))
    with pytest.raises(ValueError, match="envelope"):  # batch 1 at W 4: no TPU tiling
        cuda_conv2d.wc_conv2d(torch.zeros(1, 4, 4, 256, device=cuda),
                              torch.zeros(3, 3, 256, 256, device=cuda))


@pytest.mark.parametrize("save_pre", [True, False])
def test_conv2d_ops_gradients_match_plain(cuda, save_pre, monkeypatch):
    """The fused ops' backward on the card (K5 data gradient, K5w, the
    recomputed pre-activation) against the same ops with both wrappers
    swapped for their plain versions, fp32 (TF32 off): 1e-4 of max|grad|."""
    monkeypatch.setattr(cuda_conv2d, "PRELU_SAVE_PRE", save_pre)
    g = torch.Generator(device=cuda).manual_seed(10)
    c = 256
    xh = torch.randn(8, 8, 3, c, generator=g, device=cuda)
    leaves = [xh, torch.randn(3, 3, c, c, generator=g, device=cuda) * 0.03,
              torch.randn(c, generator=g, device=cuda) * 0.1,
              torch.rand(c, generator=g, device=cuda) * 0.3,
              torch.randn(3, 3, c, c, generator=g, device=cuda) * 0.03,
              torch.randn(c, generator=g, device=cuda) * 0.1]
    cot = torch.randn(8, 8, 3, c, generator=g, device=cuda)

    def grads():
        ts = [t.clone().requires_grad_() for t in leaves]
        x, w1, b1, al, w2, b2 = ts
        y = cuda_conv2d.wc_conv2d_res_hwnc(cuda_conv2d.wc_conv2d_prelu_hwnc(x, w1, b1, al),
                                           w2, b2, x)
        y = cuda_conv2d.wc_conv2d_relu_hwnc(y, w2, b2)
        return torch.autograd.grad(y, ts, cot)

    got = grads()
    monkeypatch.setattr(cuda_conv2d, "conv2d_hwnc", cuda_conv2d.conv2d_hwnc_plain)
    monkeypatch.setattr(cuda_conv2d, "conv2d_wgrad", cuda_conv2d.conv2d_wgrad_plain)
    for a, b in zip(got, grads()):
        _close(a, b, torch.float32)


# Tensors of 1, 3, 5 and 4097 elements and larger ones, laid out as views
# into one flat buffer, tensor i at (phase0 + i) % 4 elements past a
# multiple of four: parameters (phase0 1) and gradients (phase0 3) lie at
# every 16-byte phase, and differ from each other tensor by tensor.
RAGGED = {"a": (1,), "b": (3,), "c": (5,), "d": (4097,), "e": (17, 31), "f": (3, 3, 64, 33)}


def _views(shapes, phase0, g, dev, dtype=torch.float32):
    numels = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(numels) + 8 * len(numels), generator=g, device=dev).to(dtype)
    out, end = {}, 0
    for i, ((k, s), n) in enumerate(zip(shapes.items(), numels)):
        off = -(-end // 4) * 4 + (phase0 + i) % 4
        out[k] = flat[off:off + n].view(s)
        end = off + n
    return out


@pytest.mark.parametrize("case,gdt,mdt", [
    ("shader", torch.float32, torch.float32), ("texface", torch.float32, torch.float32),
    ("shader", torch.float32, torch.bfloat16), ("ragged", torch.float32, torch.float32),
    ("ragged", torch.bfloat16, torch.float32), ("ragged", torch.float32, torch.bfloat16),
    ("ragged", torch.bfloat16, torch.bfloat16)])
def test_adam_kernel_bit_equal(cuda, case, gdt, mdt):
    """optim.update_and_apply on the card (one launch of the fused kernel a
    step) against tx.update + apply_updates: parameters, both moments and
    both counts bit for bit over 6 steps, with a staircase that halves the
    learning rate every 2 steps; at the shader's and texface's parameter
    shapes and on a ragged set of views at odd offsets into flat buffers."""
    g = torch.Generator(device=cuda).manual_seed(12)
    tx = optim.make_optimizer(1e-3, 2, 0.5, b1=0.5, b2=0.999, eps=1e-8,
                              moment_dtype=str(mdt).split(".")[-1])
    if case == "ragged":
        shapes = RAGGED
        fused = _views(shapes, 1, g, cuda)
        ref = {k: t.clone() for k, t in fused.items()}
    else:
        shapes = param_shapes(ShaderConfig() if case == "shader" else TextureFaceConfig())
        fused = {k: torch.randn(s, generator=g, device=cuda) for k, s in shapes.items()}
        ref = {k: t.clone() for k, t in fused.items()}
    sf, sr = tx.init(fused), tx.init(ref)
    for step in range(6):
        if case == "ragged":
            grads = _views(shapes, 3, g, cuda, gdt)
        else:
            grads = {k: torch.randn(s, generator=g, device=cuda).to(gdt)
                     for k, s in shapes.items()}
        before = cuda_adam.launches, cuda_adam.tensors
        sf = optim.update_and_apply(tx, grads, sf, fused)
        assert (cuda_adam.launches, cuda_adam.tensors) == (before[0] + 1,
                                                           before[1] + len(shapes))
        updates, sr = tx.update(grads, sr, ref)
        optim.apply_updates(ref, updates)
        torch.cuda.synchronize()
        for k in shapes:
            for a, b in ((fused[k], ref[k]), (sf[0].mu[k], sr[0].mu[k]),
                         (sf[0].nu[k], sr[0].nu[k])):
                assert a.dtype == b.dtype and torch.equal(a, b), (step, k)
        assert int(sf[0].count) == int(sr[0].count) == step + 1
        assert int(sf[1].count) == int(sr[1].count) == step + 1


def test_adam_wrapper_raises_outside_the_envelope(cuda):
    """fp16 gradients, bf16 parameters, non-contiguous tensors and scalars
    off the card raise before any launch."""
    p = [torch.zeros(8, 4, device=cuda)]
    grads = [torch.zeros(8, 4, device=cuda)]
    m, v = [torch.zeros(8, 4, device=cuda)], [torch.zeros(8, 4, device=cuda)]
    one = torch.ones((), device=cuda)
    before = cuda_adam.launches
    hyper = dict(b1=0.5, b2=0.999, eps=1e-8)
    with pytest.raises(TypeError):
        cuda_adam.adam_(p, [grads[0].half()], m, v, one, one, one, **hyper)
    with pytest.raises(TypeError):
        cuda_adam.adam_([p[0].bfloat16()], grads, m, v, one, one, one, **hyper)
    with pytest.raises(ValueError):
        cuda_adam.adam_(p, [torch.zeros(4, 8, device=cuda).t()], m, v, one, one, one, **hyper)
    with pytest.raises(ValueError):
        cuda_adam.adam_([torch.zeros(4, 8, device=cuda).t()], grads, m, v, one, one, one,
                        **hyper)
    with pytest.raises(ValueError):
        cuda_adam.adam_(p, grads, m, v, one.cpu(), one, one, **hyper)
    assert cuda_adam.launches == before
    cuda_adam.adam_(p, grads, m, v, one, one, -one, **hyper)
    assert cuda_adam.launches == before + 1
