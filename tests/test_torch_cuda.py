"""The CUDA kernels against their plain versions, on the card.

These need a CUDA card and the CUDA toolkit (the kernels build with nvcc at
first use); without a card each test skips with that reason. On the card
they run with ``python -m pytest tests/test_torch_cuda.py -q``;
``chip_smoke.py`` covers the same kernels at the serving and training
paths' shapes. Tolerances: fp32 results may differ by summation order (1e-4
of max|y|); bf16 results by one output rounding (2^-7 of max|y|, two bf16
ulps); the weight gradients (K2w, K6) are fp32 sums of exact products in
either dtype (1e-4 of max|gw|).
"""
from __future__ import annotations

import pytest
import torch

from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd

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
    got = cuda_resample.apply_interp_pass(vol, params, 40, 37)
    assert cuda_resample.launches == before + 1
    assert cuda_resample.launches_by_shape[(3, 1000, 100, 37)] == before_shape + 1
    _close(got, cuda_resample.interp_pass_plain(vol, params, 40, 37), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xs,co", [((2, 5, 10, 24, 24), 64), ((1, 4, 8, 8, 16), 16),
                                   ((2, 3, 4, 8, 8), 32)])
def test_conv3d_kernel(cuda, dtype, xs, co):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(*xs, generator=g, device=cuda).to(dtype)
    w = (torch.randn(3, 3, 3, xs[-1], co, generator=g, device=cuda) * 0.1).to(dtype)
    _close(cuda_conv3d.nc_conv3d(x, w), cuda_conv3d.nc_conv3d_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_winograd_kernel(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(8, 6, 70, 256, generator=g, device=cuda).to(dtype)
    w = (torch.randn(3, 3, 256, 128, generator=g, device=cuda) * 0.05).to(dtype)
    _close(cuda_winograd.wino_conv2d(x, w), cuda_winograd.wino_conv2d_plain(x, w), dtype)


def test_wrappers_raise_outside_the_envelope(cuda):
    x = torch.zeros(1, 4, 8, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="envelope"):
        cuda_conv3d.nc_conv3d(x, torch.zeros(3, 3, 3, 16, 8, device=cuda))
    with pytest.raises(ValueError, match="envelope"):
        cuda_winograd.wino_conv2d(torch.zeros(1, 4, 4, 256, device=cuda),
                                  torch.zeros(3, 3, 256, 256, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xs,co", [((2, 5, 10, 24, 24), 64), ((1, 4, 8, 8, 16), 16),
                                   ((2, 3, 4, 8, 8), 32), ((1, 4, 8, 8, 32), 32)])
def test_conv3d_wgrad_kernel(cuda, dtype, xs, co):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(*xs, generator=g, device=cuda).to(dtype)
    gy = torch.randn(*xs[:-1], co, generator=g, device=cuda).to(dtype)
    before = cuda_conv3d.wgrad_launches
    got = cuda_conv3d.nc_conv3d_wgrad(x, gy)
    assert cuda_conv3d.wgrad_launches == before + 1
    _close(got, cuda_conv3d.nc_conv3d_wgrad_plain(x, gy), torch.float32)


@pytest.mark.parametrize("dtype,fp32_ops", [(torch.float32, False), (torch.bfloat16, False),
                                            (torch.bfloat16, True)])
def test_winograd_wgrad_kernel(cuda, dtype, fp32_ops):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(8, 6, 70, 256, generator=g, device=cuda).to(dtype)
    gy = torch.randn(8, 6, 70, 128, generator=g, device=cuda).to(dtype)
    before = cuda_winograd.wgrad_launches_by_shape[(8, 6, 70, 256), 128]
    got = cuda_winograd.wino_wgrad(x, gy, fp32_ops)
    assert cuda_winograd.wgrad_launches_by_shape[(8, 6, 70, 256), 128] == before + 1
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
