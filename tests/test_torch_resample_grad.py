"""The gradients of the port's voxel warps against the JAX package's, on the
CPU.

K4's plain version (``interp_pass_bwd_plain``, through the pass's autograd
Function) is held against ``pallas_resample.apply_interp_pass``'s custom VJP
with the Pallas backward kernel in interpret mode; the whole multipass warp's
voxel and pose gradients against ``jax.vjp``; the exact trilinear warp's
against ``jax.grad``. Inputs come from numpy seeds. Tolerances are stated
per test.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rendernet_tpu.ops import pallas_resample as jmp
from rendernet_tpu.ops import resample as jresample
from rendernet_tpu_torch.ops import cuda_resample
from rendernet_tpu_torch.ops import resample as tresample
from rendernet_tpu_torch.ops.crops import crop_voxel

torch.set_num_threads(2)

S, N = 16, 32  # tests/test_pallas_resample.py's sizes
# Irrational-ish poses keep sample positions off the interpolation kinks,
# where one-sided derivatives may pick either side.
POSES = np.array([[0.91731, 0.26117, 1.03291], [2.51373, -0.80919, 0.87113],
                  [4.1927, 1.3371, 1.1213]], np.float32)


def _blob(rng, b=3, c=1):
    vol = rng.random((b, S, S, S, c)).astype(np.float32)
    vol[:, :2] = vol[:, -2:] = 0
    vol[:, :, :2] = vol[:, :, -2:] = 0
    vol[:, :, :, :2] = vol[:, :, :, -2:] = 0
    return vol


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# K4: one pass's adjoint
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("taps", [3, 4, 6])
@pytest.mark.parametrize("out_lanes", [32, 20])
@pytest.mark.parametrize("sign", [1, -1])
def test_pass_adjoint_matches_pallas_vjp(dtype, taps, out_lanes, sign):
    """gv and gparams of one pass against JAX's custom VJP (Pallas
    ``_bwd_kernel`` in interpret mode), with a window (out_lanes 20 of 32),
    negative alpha (a deferred flip), positions off both ends and, at taps 4
    with |alpha| down to 0.6, a band too narrow to hold every tap: both
    sides drop the same taps. fp32: the same fp32 sums in the same order;
    1e-5 of max|g| covers XLA's own reassociation. bf16: gv rounds once to
    bf16 from fp32 sums that may differ in the last fp32 bit, so one bf16
    ulp (2^-7 of max|gv|, two ulps at the max); gparams are fp32 sums of
    ~6e3 terms: 1e-5 relative."""
    rng = np.random.default_rng(10 + taps)
    bc, r, lanes, db = 3, 64, 32, 8
    vol = rng.standard_normal((bc, r, lanes)).astype(np.float32)
    u = rng.uniform(-1, 1, (bc, 4)).astype(np.float32)
    alpha = sign * (np.ones(bc, np.float32) if taps == 3 else 1 + 0.4 * u[:, 0])
    delta = 20 * u[:, 3] if sign > 0 else lanes - 1 - 20 * u[:, 3]
    params = np.stack([alpha, 0.4 * u[:, 1], 0.4 * u[:, 2], delta], -1).astype(np.float32)
    g = rng.standard_normal((bc, r, out_lanes)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    _, vjp = jax.vjp(lambda v, p: jmp.apply_interp_pass(v, p, db, taps, out_lanes),
                     jnp.asarray(vol).astype(jdt), jnp.asarray(params))
    jgv, jgp = (np.asarray(x.astype(jnp.float32)) for x in vjp(jnp.asarray(g).astype(jdt)))

    tv, tp = _t(vol).to(tdt).requires_grad_(), _t(params, True)
    y = cuda_resample.apply_interp_pass(tv, tp, db, out_lanes, taps=taps)
    assert y.shape == (bc, r, out_lanes) and y.dtype == tdt
    tgv, tgp = torch.autograd.grad(y, (tv, tp), _t(g).to(tdt))
    assert tgv.dtype == tdt and tgp.dtype == torch.float32
    gv_tol = (1e-5 if dtype == "float32" else 2.0 ** -7) * np.abs(jgv).max()
    np.testing.assert_allclose(tgv.float().numpy(), jgv, atol=gv_tol, rtol=0)
    np.testing.assert_allclose(tgp.numpy(), jgp, atol=1e-5 * np.abs(jgp).max(), rtol=0)


def test_pass_adjoint_plain_returns_the_position_cotangent():
    """The plain K4 on its own: gp has out_lanes lanes in fp32, gv the
    volume's shape and dtype, and summing gp against (lane, d_a, d_b, 1)
    gives the pass's parameter gradient that autograd returns (same sums,
    1e-6 relative)."""
    rng = np.random.default_rng(3)
    vol = _t(rng.standard_normal((2, 48, 40)).astype(np.float32)).to(torch.bfloat16)
    params = _t(np.array([[0.9, 0.2, -0.3, 3.0], [-1.1, 0.1, 0.25, 35.0]], np.float32))
    g = _t(rng.standard_normal((2, 48, 24)).astype(np.float32)).to(torch.bfloat16)
    gv, gp = cuda_resample.interp_pass_bwd_plain(vol, params, g, 6, 4, 24)
    assert gv.shape == vol.shape and gv.dtype == torch.bfloat16
    assert gp.shape == (2, 48, 24) and gp.dtype == torch.float32
    p = params.clone().requires_grad_()
    y = cuda_resample.apply_interp_pass(vol, p, 6, 24, taps=4)
    (want,) = torch.autograd.grad(y, p, g)
    got = cuda_resample.pass_param_grad(gp, 6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_scale", [None, 1.0, 1.2, 1.25, 2.0, 2.6])
def test_plan_taps_match_jax(max_scale):
    """Each pass's static band (3 for the shears, the scale passes' from
    max_scale, a merged pass the wider of its parts) equals JAX's plan."""
    poses = POSES.copy()
    poses[:, 2] = np.minimum(poses[:, 2], max_scale or 2.0)
    steps = cuda_resample.build_pass_plan(_t(poses), size=S, new_size=N, max_scale=max_scale)
    jsteps = jmp.build_pass_plan(jnp.asarray(poses), size=S, new_size=N, max_scale=max_scale)
    taps = [s[3] for s in steps if s[0] == "interp"]
    assert taps == [s[3] for s in jsteps if s[0] == "interp"]
    assert cuda_resample._taps_for_scale(max_scale) == jmp._taps_for_scale(max_scale)
    assert taps[:3] == [3, 3, 3]


# ---------------------------------------------------------------------------
# the whole multipass warp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("channels", [1, 2])
def test_multipass_vjp_matches_jax(channels):
    """Voxel and pose VJPs of the multipass warp (plain K1/K4 passes) against
    jax.vjp (Pallas passes in interpret mode), fp32. Voxel cotangent: 1e-4
    of its max (plan coefficients carry solve roundoff into positions).
    Pose: the position cotangents are summed over ~3e4 lanes per pass and
    pulled back through the plan; 1e-4 of max|grad| per pose component."""
    rng = np.random.default_rng(20 + channels)
    vol = _blob(rng, c=channels)
    cot = rng.standard_normal((3, N, N, N, channels)).astype(np.float32)
    _, vjp = jax.vjp(lambda v, p: jmp.rotate_resample_multipass(v, p, new_size=N),
                     jnp.asarray(vol), jnp.asarray(POSES))
    jgv, jgp = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
    tv, tp = _t(vol, True), _t(POSES, True)
    out = cuda_resample.rotate_resample_multipass(tv, tp, new_size=N)
    tgv, tgp = torch.autograd.grad(out, (tv, tp), _t(cot))
    np.testing.assert_allclose(tgv.numpy(), jgv, atol=1e-4 * np.abs(jgv).max(), rtol=0)
    np.testing.assert_allclose(tgp.numpy(), jgp, atol=1e-4 * np.abs(jgp).max(), rtol=0)
    assert np.abs(jgp).min() > 0


def test_multipass_bf16_gradients_match_jax():
    """bf16 data through the passes (geometry fp32) on both sides: every pass
    rounds its output and its voxel cotangent to bf16 (2^-8 relative) from
    slightly different positions, over 8 passes: 2^-5 of max|gv|; the pose
    gradient sums fp32 products of bf16 values: 2e-2 of max|gp|."""
    rng = np.random.default_rng(24)
    vol = _blob(rng)
    cot = rng.random((3, N, N, N, 1)).astype(np.float32)
    _, vjp = jax.vjp(lambda v, p: jmp.rotate_resample_multipass(
        v, p, new_size=N, compute_dtype=jnp.bfloat16).astype(jnp.float32),
        jnp.asarray(vol), jnp.asarray(POSES))
    jgv, jgp = (np.asarray(x) for x in vjp(jnp.asarray(cot)))
    tv, tp = _t(vol, True), _t(POSES, True)
    out = cuda_resample.rotate_resample_multipass(tv, tp, new_size=N,
                                                  compute_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16
    tgv, tgp = torch.autograd.grad(out.float(), (tv, tp), _t(cot))
    np.testing.assert_allclose(tgv.numpy(), jgv, atol=2.0 ** -5 * np.abs(jgv).max(), rtol=0)
    np.testing.assert_allclose(tgp.numpy(), jgp, atol=2e-2 * np.abs(jgp).max(), rtol=0)


def test_crop_fused_patch_gradients_match_jax():
    """The crop-fused patch (window-emitting last passes, the window start
    folded into the deltas) against JAX's, fp32, and against the port's own
    full warp then crop: tolerances as in test_multipass_vjp_matches_jax."""
    rng = np.random.default_rng(25)
    vol = _blob(rng, b=1)
    pose = POSES[:1]
    offsets, p = (7, 4), 16
    cot = rng.standard_normal((1, p, p, N, 1)).astype(np.float32)
    _, vjp = jax.vjp(lambda v, q: jmp.rotate_resample_camera_patch_multipass(
        v, q, jnp.asarray(offsets, jnp.int32), p, new_size=N),
        jnp.asarray(vol), jnp.asarray(pose))
    jgv, jgp = (np.asarray(x) for x in vjp(jnp.asarray(cot)))

    def grads(fused):
        tv, tp = _t(vol, True), _t(pose, True)
        if fused:
            out = cuda_resample.rotate_resample_camera_patch_multipass(tv, tp, offsets, p,
                                                                       new_size=N)
        else:
            out = crop_voxel(cuda_resample.rotate_resample_to_camera_multipass(
                tv, tp, new_size=N), offsets, p)
        return [g.numpy() for g in torch.autograd.grad(out, (tv, tp), _t(cot))]

    for tgv, tgp in (grads(True), grads(False)):
        np.testing.assert_allclose(tgv, jgv, atol=1e-4 * np.abs(jgv).max(), rtol=0)
        np.testing.assert_allclose(tgp, jgp, atol=1e-4 * np.abs(jgp).max(), rtol=0)


def test_multipass_vjp_is_the_adjoint():
    """<A v, g> = <v, A^T g> for the port's warp (linear in the voxels):
    the voxel gradient is the true adjoint of the forward; fp32 sums of
    ~3e4 products, 1e-4 relative (JAX's own test's bound)."""
    rng = np.random.default_rng(2)
    v = _t(rng.random((1, S, S, S, 1)).astype(np.float32), True)
    g = _t(rng.random((1, N, N, N, 1)).astype(np.float32))
    out = cuda_resample.rotate_resample_multipass(v, _t(POSES[2:3]), new_size=N)
    (vt,) = torch.autograd.grad(out, v, g)
    lhs = float((out.detach().double() * g.double()).sum())
    rhs = float((v.detach().double() * vt.double()).sum())
    assert lhs == pytest.approx(rhs, rel=1e-4)


def test_multipass_pose_gradient_matches_finite_differences():
    """The port's pose gradient against central differences of its own
    forward (eps 1e-3), with JAX's test's bounds (5% or 0.5 absolute)."""
    vol = _t(_blob(np.random.default_rng(0), b=1))
    pose0 = _t(POSES[:1])

    def loss(p):
        out = cuda_resample.rotate_resample_multipass(vol, p, new_size=N)
        return (out.double() * out.double()).sum()

    p = pose0.clone().requires_grad_()
    (grad,) = torch.autograd.grad(loss(p), p)
    eps = 1e-3
    for axis in range(3):
        dp = torch.zeros(1, 3)
        dp[0, axis] = eps
        fd = (float(loss(pose0 + dp)) - float(loss(pose0 - dp))) / (2 * eps)
        assert float(grad[0, axis]) == pytest.approx(fd, rel=0.05, abs=0.5), (axis, grad, fd)


def test_reduced_taps_gradients_match_default():
    """A scale bound narrows the scale passes' band (6 -> 4 taps) with the
    same gradients for in-bound poses, a scale at the bound included: the
    dropped taps are all out of band (JAX's test's tolerances)."""
    rng = np.random.default_rng(7)
    poses = np.array([[0.7, 0.3, 1.1], [2.5, -0.8, 0.85], [5.9, -1.3, 1.25]], np.float32)
    v = rng.random((3, S, S, S, 1)).astype(np.float32)
    g = _t(rng.random((3, N, N, N, 1)).astype(np.float32))

    def grads(max_scale):
        tv, tp = _t(v, True), _t(poses, True)
        out = cuda_resample.rotate_resample_multipass(tv, tp, new_size=N, max_scale=max_scale)
        return [x.numpy() for x in torch.autograd.grad(out, (tv, tp), g)]

    gv_ref, gp_ref = grads(None)
    gv_fast, gp_fast = grads(1.25)
    np.testing.assert_allclose(gv_fast, gv_ref, rtol=1e-6)
    np.testing.assert_allclose(gp_fast, gp_ref, rtol=1e-4)


# ---------------------------------------------------------------------------
# the exact trilinear warp
# ---------------------------------------------------------------------------
def test_exact_warp_gradients_match_jax():
    """Autograd through the port's exact warp (gather / lerp tree, floor's
    zero derivative) against jax.grad, voxels and pose, fp32, at poses off
    the lattice: the same lerp tree on both sides; 1e-4 of max|grad| covers
    one-ulp differences in the source coordinates."""
    rng = np.random.default_rng(30)
    vol = _blob(rng, c=2)
    cot = rng.standard_normal((3, N, N, N, 2)).astype(np.float32)

    def jloss(v, p):
        return jnp.sum(jresample.rotate_resample_to_camera(v, p, new_size=N) * cot)

    jgv, jgp = (np.asarray(x) for x in jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(vol), jnp.asarray(POSES)))
    tv, tp = _t(vol, True), _t(POSES, True)
    out = tresample.rotate_resample_to_camera(tv, tp, new_size=N)
    tgv, tgp = torch.autograd.grad((out * _t(cot)).sum(), (tv, tp))
    np.testing.assert_allclose(tgv.numpy(), jgv, atol=1e-4 * np.abs(jgv).max(), rtol=0)
    np.testing.assert_allclose(tgp.numpy(), jgp, atol=1e-4 * np.abs(jgp).max(), rtol=0)
    assert np.all(np.abs(jgp[:, :2]) > 0)
    assert math.isfinite(float(tgp.abs().max()))
