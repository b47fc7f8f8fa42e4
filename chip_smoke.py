#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``rendernet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, all of them on every run:
  1. build every CUDA kernel from ``rendernet_tpu_torch/csrc`` (one nvcc per
     source, in parallel) and print the card's name and power limit;
  2. kernels: call each kernel's wrapper (K1 resample pass, K2 conv3d, K2w
     its weight gradient, K3 Winograd, K6 the Winograd weight gradient) at
     the shapes the serving path (batch 8) and the training step (bf16 at
     batch 24; fp32 at batch 8, the gradient check's) give it, and at the
     data-gradient shapes, plus one ragged shape each; hold it against its
     plain PyTorch version in the working dtype; time kernel, plain version
     and the cuDNN yardstick with CUDA events;
  3. serving: run the render CLI (fp32, ``--fast --resample multipass
     --rotate --sweep_batch 8``: 72 frames, 9 batch-8 forwards) on a
     procedural voxel, then one bf16 ``shader_forward`` at batch 8, both at
     the full default width; compare one full forward per dtype, on the
     logits, with the forward whose kernels are replaced by their plain
     versions;
  4. training, at the full default width with ``preact_policy`` and the
     Winograd convs on: (a) one step's gradients at batch 8 in fp32 and
     bf16, at patch 128 (the full grid) and at patch 64 (at fixed crop
     offsets, through K1's window-emitting passes), with the kernels and
     with every kernel replaced by its plain version, compared parameter
     by parameter; (b) ``bench.py``'s two
     configurations (batch 24, bf16, bf16 Adam moments, patch 128 and 64):
     a warm-up step, then 8 timed steps on one fixed batch; (c) one step
     each with ``WGRAD=True``, ``WGRAD="fp32"`` and ``remat=True``; (d) a
     profile of one patch-128 step.
The kernels' launch counters are zeroed just before each run of phases 3
and 4 and read just after; every run's counts are checked, shape by shape,
against the counts its graph implies.

Prints a ``{"kernels": [...]}`` line with one row per kernel, dtype and
main-path shape: a serving row's ``launches`` is per batch-8 forward of that
dtype's serving run (the fp32 CLI's counts divided by its 9 forwards, after
checking they are exact multiples); a training row's is per training step
of the run named in the row (the bf16 patch-128 or patch-64 steps, the
fp32 patch-128 gradient check, or the WGRAD steps for K6). The ragged shapes and the fp32
batch-24 checks are printed on ``ragged`` and ``check`` lines of their own.
The last line is ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, when there is no CUDA card, when the port is missing,
or when any check fails.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# Kernel vs plain version, in the working dtype, as a fraction of max|plain|.
# fp32: both sum in fp32 in different orders (~1e-6 relative per sum of
# ~1e4 terms). bf16: both round an fp32 result once to bf16, so they may
# differ by one bf16 ulp of a value (2^-8 relative); two ulps of the max.
# The weight gradients (K2w, K6) return fp32 sums of exact products of the
# stored values in either dtype, summed over up to 3e6 positions in other
# orders (at most 3e-5 of max|plain| on an H100): 1e-4.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
WGRAD_TOL = 1e-4

# Full forward with kernels vs full forward with their plain versions: max
# abs difference of the logits (the head's output, before the sigmoid) as a
# fraction of the plain forward's logit spread (max - min). fp32: sums
# reordered in 62 convs, carried through the residual stacks. bf16: a
# one-ulp difference in any bf16 activation can flip later roundings, which
# the 25 residual blocks carry to the output. Each limit is about 4x (fp32)
# and 2.4x (bf16) the reading on an H100 (5.1e-6 and 2.05e-2 of a logit
# spread of 1.14).
FORWARD_TOL = {"float32": 2e-5, "bfloat16": 0.05}
# The plain forward's sigmoid output must spread at least this far
# (max - min; 0.278 on an H100), so that a wrong kernel cannot hide in a
# flat image.
MIN_SPREAD = 0.1

# One training step's gradients with kernels vs with their plain versions:
# for each parameter, max |g - g_plain| / max |g_plain|; the worst parameter
# must stay under this. fp32 (TF32 off): the kernels sum in other orders,
# and the step's fp32 conditioning amplifies that through the residual
# stacks. bf16: every bf16 rounding of an activation or a gradient can land
# on the other side between the two runs. Readings on an H100, patch 128 /
# patch 64: fp32 7.21e-4 (res3_4's first conv weights) / 1.13e-3 (res2_7's);
# bf16 3.14e-2 (res1_5's) / 4.08e-2 (e_conv2's alpha). Each limit is 2.7-4.2x
# the readings.
GRAD_TOL = {"float32": 3e-3, "bfloat16": 0.125}

REPO_SOURCES = {
    "K1": ("rendernet_tpu_torch/csrc/resample.cu",
           "rendernet_tpu/ops/pallas_resample.py:320 (_fwd_kernel)"),
    "K2": ("rendernet_tpu_torch/csrc/conv3d.cu",
           "rendernet_tpu/ops/pallas_conv3d.py:165 (_fwd_kernel)"),
    "K2w": ("rendernet_tpu_torch/csrc/conv3d_wgrad.cu",
            "rendernet_tpu/ops/pallas_conv3d.py:186 (_wgrad_kernel)"),
    "K3": ("rendernet_tpu_torch/csrc/winograd.cu",
           "rendernet_tpu/ops/pallas_winograd.py:147 (_kernel)"),
    "K6": ("rendernet_tpu_torch/csrc/winograd_wgrad.cu",
           "rendernet_tpu/ops/pallas_winograd.py:342 (_wgrad_kernel)"),
}

# The launch counter of each kernel: (module, attribute prefix).
COUNTERS = {"K1": ("cuda_resample", ""), "K2": ("cuda_conv3d", ""),
            "K2w": ("cuda_conv3d", "wgrad_"), "K3": ("cuda_winograd", ""),
            "K6": ("cuda_winograd", "wgrad_")}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int) -> float:
    """ms per call over ``reps`` calls, or fewer for a call slower than
    ~20 ms (at least 3), after warming up."""
    for _ in range(2):  # warm up (first-call setup, clocks)
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(3, min(reps, int(400 / max(start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
# A case: (kernel id, label, op, spec, dtype names, run). ``op`` names the
# wrapper (see make_case); ``run`` names the main-path run whose counts give
# the row's launches ("serve": per batch-8 forward of phase 3; "train" and
# "train64": per bf16 patch-128 / patch-64 step; "grad32": per fp32
# patch-128 gradient-check step; "wgrad_bf16"
# and "wgrad_fp32": per step with WGRAD=True or "fp32"), "check" for a
# checked and timed shape no run launches, None for a ragged shape.
# Specs: pass (BC, R, L, out_lanes, db), where out_lanes < L is a pass
# that emits a crop window (the patch-64 step's last pass on each cropped
# axis); conv3d / conv3d_wgrad / wino /
# wino_wgrad (input shape, output channels); conv3d_dgrad / wino_dgrad
# (cotangent shape, channels of the data gradient), which run the forward
# kernel on the flipped, io-swapped weights of the conv, as the backward
# does (a strided view the wrapper copies).
F32, BF16, BOTH = ("float32",), ("bfloat16",), ("float32", "bfloat16")
X3 = {8: (8, 64, 64, 32, 32), 24: (24, 64, 64, 32, 32)}
X3P = (24, 32, 32, 32, 32)  # res1 at patch 64
CASES = [
    ("K1", "pass [8,16384,128]", "pass", (8, 16384, 128, 128, 128), BOTH, "serve"),
    ("K1", "train pass [24,16384,128]", "pass", (24, 16384, 128, 128, 128), BF16, "train"),
    ("K1", "train64 pass [24,16384,128]", "pass", (24, 16384, 128, 128, 128), BF16, "train64"),
    ("K1", "train64 window pass [24,16384,128]->64", "pass", (24, 16384, 128, 64, 128), BF16,
     "train64"),
    ("K1", "train64 window pass [24,8192,128]->64", "pass", (24, 8192, 128, 64, 128), BF16,
     "train64"),
    ("K1", "ragged pass [3,1000,100]->37", "pass", (3, 1000, 100, 37, 40), BOTH, None),
    ("K2", "e_conv3 [8,64,64,32,16]->32", "conv3d", ((8, 64, 64, 32, 16), 32), BOTH, "serve"),
    ("K2", "res1 [8,64,64,32,32]->32", "conv3d", (X3[8], 32), BOTH, "serve"),
    ("K2", "train e_conv3 [24,64,64,32,16]->32", "conv3d", ((24, 64, 64, 32, 16), 32), BF16,
     "train"),
    ("K2", "train res1 fwd+dgrad [24,64,64,32,32]->32", "conv3d", (X3[24], 32), BF16, "train"),
    ("K2", "train dgrad e_conv3 [24,64,64,32,32]->16", "conv3d_dgrad", (X3[24], 16), BF16,
     "train"),
    ("K2", "train dgrad e_conv3 [8,64,64,32,32]->16", "conv3d_dgrad", (X3[8], 16), F32, "grad32"),
    ("K2", "check dgrad e_conv3 [24,64,64,32,32]->16", "conv3d_dgrad", (X3[24], 16), F32,
     "check"),
    ("K2", "train64 e_conv3 [24,32,32,32,16]->32", "conv3d", ((24, 32, 32, 32, 16), 32), BF16,
     "train64"),
    ("K2", "train64 res1 fwd+dgrad [24,32,32,32,32]->32", "conv3d", (X3P, 32), BF16, "train64"),
    ("K2", "train64 dgrad e_conv3 [24,32,32,32,32]->16", "conv3d_dgrad", (X3P, 16), BF16,
     "train64"),
    ("K2", "ragged [2,5,10,24,24]->64", "conv3d", ((2, 5, 10, 24, 24), 64), BOTH, None),
    ("K2w", "train e_conv3 [24,64,64,32,16]->32", "conv3d_wgrad", ((24, 64, 64, 32, 16), 32),
     BF16, "train"),
    ("K2w", "train res1 [24,64,64,32,32]->32", "conv3d_wgrad", (X3[24], 32), BF16, "train"),
    ("K2w", "train e_conv3 [8,64,64,32,16]->32", "conv3d_wgrad", ((8, 64, 64, 32, 16), 32), F32,
     "grad32"),
    ("K2w", "train res1 [8,64,64,32,32]->32", "conv3d_wgrad", (X3[8], 32), F32, "grad32"),
    ("K2w", "check e_conv3 [24,64,64,32,16]->32", "conv3d_wgrad", ((24, 64, 64, 32, 16), 32),
     F32, "check"),
    ("K2w", "check res1 [24,64,64,32,32]->32", "conv3d_wgrad", (X3[24], 32), F32, "check"),
    ("K2w", "train64 e_conv3 [24,32,32,32,16]->32", "conv3d_wgrad",
     ((24, 32, 32, 32, 16), 32), BF16, "train64"),
    ("K2w", "train64 res1 [24,32,32,32,32]->32", "conv3d_wgrad", (X3P, 32), BF16, "train64"),
    ("K2w", "ragged [2,5,10,24,24]->64", "conv3d_wgrad", ((2, 5, 10, 24, 24), 64), BOTH, None),
    ("K3", "res2 [8,64,64,1024]->1024", "wino", ((8, 64, 64, 1024), 1024), BOTH, "serve"),
    ("K3", "res3 [8,64,64,512]->512", "wino", ((8, 64, 64, 512), 512), BOTH, "serve"),
    ("K3", "train res2 fwd+dgrad [24,64,64,1024]->1024", "wino_dgrad",
     ((24, 64, 64, 1024), 1024), BF16, "train"),
    ("K3", "train res3 fwd+dgrad [24,64,64,512]->512", "wino_dgrad", ((24, 64, 64, 512), 512),
     BF16, "train"),
    ("K3", "train res2 fwd+dgrad [8,64,64,1024]->1024", "wino_dgrad",
     ((8, 64, 64, 1024), 1024), F32, "grad32"),
    ("K3", "train res3 fwd+dgrad [8,64,64,512]->512", "wino_dgrad", ((8, 64, 64, 512), 512),
     F32, "grad32"),
    ("K3", "check res2 dgrad [24,64,64,1024]->1024", "wino_dgrad", ((24, 64, 64, 1024), 1024),
     F32, "check"),
    ("K3", "train64 res2 fwd+dgrad [24,32,32,1024]->1024", "wino_dgrad",
     ((24, 32, 32, 1024), 1024), BF16, "train64"),
    ("K3", "train64 res3 fwd+dgrad [24,32,32,512]->512", "wino_dgrad",
     ((24, 32, 32, 512), 512), BF16, "train64"),
    ("K3", "ragged [8,6,70,256]->128", "wino", ((8, 6, 70, 256), 128), BOTH, None),
    ("K6", "train res2 [24,64,64,1024]->1024 WGRAD=True", "wino_wgrad",
     ((24, 64, 64, 1024), 1024, False), BF16, "wgrad_bf16"),
    ("K6", "train res3 [24,64,64,512]->512 WGRAD=True", "wino_wgrad",
     ((24, 64, 64, 512), 512, False), BF16, "wgrad_bf16"),
    ("K6", "train res2 [24,64,64,1024]->1024 WGRAD=fp32", "wino_wgrad",
     ((24, 64, 64, 1024), 1024, True), BF16, "wgrad_fp32"),
    ("K6", "train res3 [24,64,64,512]->512 WGRAD=fp32", "wino_wgrad",
     ((24, 64, 64, 512), 512, True), BF16, "wgrad_fp32"),
    ("K6", "check res2 [24,64,64,1024]->1024 fp32 storage", "wino_wgrad",
     ((24, 64, 64, 1024), 1024, True), F32, "check"),
    ("K6", "check res3 [24,64,64,512]->512 fp32 storage", "wino_wgrad",
     ((24, 64, 64, 512), 512, True), F32, "check"),
    ("K6", "ragged [8,6,70,256]->128", "wino_wgrad", ((8, 6, 70, 256), 128, False), BOTH, None),
    ("K6", "ragged [8,6,70,256]->128 fp32 operands", "wino_wgrad",
     ((8, 6, 70, 256), 128, True), BF16, None),
]

# Serving launches per batch-8 forward at each serving shape (phase 3).
SERVE_LAUNCHES = {("K1", "pass [8,16384,128]"): 8,
                  ("K2", "e_conv3 [8,64,64,32,16]->32"): 1,
                  ("K2", "res1 [8,64,64,32,32]->32"): 21,
                  ("K3", "res2 [8,64,64,1024]->1024"): 21,
                  ("K3", "res3 [8,64,64,512]->512"): 11}


def case_key(op, spec):
    """The wrapper's launch-counter key of a case."""
    if op == "pass":
        return tuple(spec[:4])
    return tuple(spec[0]), spec[1]


def make_case(torch, op, spec, dtype, gen):
    """(kernel fn, plain fn, library fn or None, flops, bytes, output is fp32)."""
    from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd

    dev = torch.device("cuda")
    item = torch.tensor([], dtype=dtype).element_size()
    grad = torch.nn.grad

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def cf(t):  # channels last -> channels first (a view)
        return t.movedim(-1, 1)

    if op == "pass":
        bc, r, lanes, ol, db = spec
        vol = rnd(bc, r, lanes)
        u = torch.rand(bc, 4, generator=gen, device=dev) * 2 - 1
        params = torch.stack([1 + 0.4 * u[:, 0], 0.4 * u[:, 1], 0.4 * u[:, 2],
                              20 * u[:, 3]], dim=-1)
        return (lambda: cuda_resample.apply_interp_pass(vol, params, db, ol),
                lambda: cuda_resample.interp_pass_plain(vol, params, db, ol),
                None, 10.0 * bc * r * ol, item * bc * (r * lanes + r * ol) + 16 * bc, False)
    xs, co = spec[0], spec[1]
    m = math.prod(xs[:-1])
    c = xs[-1]
    if op == "conv3d":
        x = rnd(*xs)
        w = rnd(3, 3, 3, c, co, scale=1.0 / math.sqrt(27 * c))
        return (lambda: cuda_conv3d.nc_conv3d_forward(x, w),
                lambda: cuda_conv3d.nc_conv3d_plain(x, w),
                lambda: torch.nn.functional.conv3d(cf(x), w.permute(4, 3, 0, 1, 2), padding=1),
                2.0 * m * co * 27 * c, item * (x.numel() + w.numel() + m * co), False)
    if op == "conv3d_dgrad":  # gy [.., c] of a conv co -> c; the data gradient has co channels
        gy = rnd(*xs)
        w = rnd(3, 3, 3, co, c, scale=1.0 / math.sqrt(27 * co))
        wf = torch.flip(w, (0, 1, 2)).transpose(3, 4)
        size = (xs[0], co) + tuple(xs[1:4])
        return (lambda: cuda_conv3d.nc_conv3d_forward(gy, wf),
                lambda: cuda_conv3d.nc_conv3d_plain(gy, wf),
                lambda: grad.conv3d_input(size, w.permute(4, 3, 0, 1, 2), cf(gy), padding=1),
                2.0 * m * co * 27 * c, item * (gy.numel() + w.numel() + m * co), False)
    if op == "conv3d_wgrad":
        x = rnd(*xs)
        gy = rnd(*xs[:-1], co)
        return (lambda: cuda_conv3d.nc_conv3d_wgrad(x, gy),
                lambda: cuda_conv3d.nc_conv3d_wgrad_plain(x, gy),
                lambda: grad.conv3d_weight(cf(x), (co, c, 3, 3, 3), cf(gy), padding=1),
                2.0 * m * 27 * c * co, item * (x.numel() + gy.numel()) + 4 * 27 * c * co, True)
    tiles = xs[0] * (xs[1] // 2) * (xs[2] // 2)
    if op == "wino":
        x = rnd(*xs)
        w = rnd(3, 3, c, co, scale=1.0 / math.sqrt(9 * c))
        return (lambda: cuda_winograd.wino_conv2d_forward(x, w),
                lambda: cuda_winograd.wino_conv2d_plain(x, w),
                lambda: torch.nn.functional.conv2d(cf(x), w.permute(3, 2, 0, 1), padding=1),
                2.0 * 16 * tiles * c * co, item * (x.numel() + 16 * c * co + m * co), False)
    if op == "wino_dgrad":  # gy [.., c] of a conv co -> c; the data gradient has co channels
        gy = rnd(*xs)
        w = rnd(3, 3, co, c, scale=1.0 / math.sqrt(9 * co))
        wf = torch.flip(w, (0, 1)).transpose(2, 3)
        size = (xs[0], co) + tuple(xs[1:3])
        return (lambda: cuda_winograd.wino_conv2d_forward(gy, wf),
                lambda: cuda_winograd.wino_conv2d_plain(gy, wf),
                lambda: grad.conv2d_input(size, w.permute(3, 2, 0, 1), cf(gy), padding=1),
                2.0 * 16 * tiles * c * co, item * (gy.numel() + 16 * c * co + m * co), False)
    if op == "wino_wgrad":
        fp32_ops = spec[2]
        x = rnd(*xs)
        gy = rnd(*xs[:-1], co)
        return (lambda: cuda_winograd.wino_wgrad(x, gy, fp32_ops),
                lambda: cuda_winograd.wino_wgrad_plain(x, gy, fp32_ops),
                lambda: grad.conv2d_weight(cf(x), (co, c, 3, 3), cf(gy), padding=1),
                2.0 * 16 * tiles * c * co, item * (x.numel() + gy.numel()) + 4 * 9 * c * co, True)
    raise ValueError(op)


def run_kernel_checks(torch, failures):
    """Checks and times every case; returns the rows, keyed by kernel id,
    label and dtype name."""
    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kid, label, op, spec, dnames, run in CASES:
        for dname in dnames:
            dtype = getattr(torch, dname)
            kern, plain, lib, flops, nbytes, f32_out = make_case(torch, op, spec, dtype, gen)
            got = kern()
            ref = plain()
            torch.cuda.synchronize()
            scale = max(float(ref.float().abs().max()), 1e-30)
            err = float((got.float() - ref.float()).abs().max())
            tol = (WGRAD_TOL if f32_out else KERNEL_TOL[dname]) * scale
            ok = bool(torch.isfinite(got.float()).all()) and err <= tol
            del got, ref
            kms = time_ms(torch, kern, 20)
            pms = time_ms(torch, plain, 5)
            lms = time_ms(torch, lib, 20) if lib is not None else None
            bms, by = bound(flops, nbytes, "float32" if op == "wino_wgrad" and spec[2]
                            else dname)
            row = dict(kernel=kid, shape=label, dtype=dname, max_abs_err=err,
                       max_abs_ref=scale, tol=tol, ok=ok, ms=kms, plain_ms=pms,
                       library_ms=lms, bound_ms=bms, bound_by=by, run=run,
                       key=case_key(op, spec))
            rows[kid, label, dname] = row
            tag = {None: "ragged", "check": "check"}.get(run, "kernel")
            log(f"{tag} " + json.dumps(row))
            if not ok:
                failures.append(f"{kid} {label} {dname}: err {err:.3e} > {tol:.3e}")
            torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------
def _counters():
    from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd

    mods = {"cuda_resample": cuda_resample, "cuda_conv3d": cuda_conv3d,
            "cuda_winograd": cuda_winograd}
    return {kid: (mods[m], p) for kid, (m, p) in COUNTERS.items()}


def reset_counts():
    for mod, p in _counters().values():
        setattr(mod, p + "launches", 0)
        getattr(mod, p + "launches_by_shape").clear()


def read_counts():
    """({kernel id: launches}, {kernel id: {shape key: launches}})."""
    c = _counters()
    return ({k: getattr(m, p + "launches") for k, (m, p) in c.items()},
            {k: dict(getattr(m, p + "launches_by_shape")) for k, (m, p) in c.items()})


def check_counts(failures, what, by_shape, n_fwd):
    """Launches per batch-8 forward at each serving shape, from a run of
    ``n_fwd`` forwards; fails on any other count or shape."""
    per_fwd = {}
    for kid in ("K1", "K2", "K3"):
        seen = dict(by_shape[kid])
        for (k, label), n in SERVE_LAUNCHES.items():
            if k != kid:
                continue
            spec = next(c[3] for c in CASES if c[0] == kid and c[1] == label)
            op = next(c[2] for c in CASES if c[0] == kid and c[1] == label)
            got = seen.pop(case_key(op, spec), 0)
            per_fwd[kid, label] = got // n_fwd
            if got != n * n_fwd:
                failures.append(f"{what}: {kid} launched {got} times at {label}, "
                                f"expected {n} x {n_fwd} forwards")
        if seen:
            failures.append(f"{what}: {kid} launched at unexpected shapes {seen}")
    for kid in ("K2w", "K6"):
        if by_shape[kid]:
            failures.append(f"{what}: {kid} launched in a forward: {by_shape[kid]}")
    return per_fwd


# ---------------------------------------------------------------------------
# phase 3: the serving path end to end
# ---------------------------------------------------------------------------
def procedural_voxel(n: int = 64):
    """A sphere plus a box in a 64^3 grid, as a bool [x, y, z] array."""
    import numpy as np

    g = np.arange(n, dtype=np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    sphere = (x - 26) ** 2 + (y - 34) ** 2 + (z - 30) ** 2 <= 14.0 ** 2
    box = (np.abs(x - 40) <= 9) & (np.abs(y - 22) <= 12) & (np.abs(z - 38) <= 7)
    return sphere | box


def run_main_path(torch, failures, tmp):
    import numpy as np

    from rendernet_tpu_torch.cli import demo
    from rendernet_tpu_torch.io.binvox import save_binvox
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward
    from rendernet_tpu_torch.nn import layers

    out = {}
    vox_path = os.path.join(tmp, "sphere_box.binvox")
    save_binvox(procedural_voxel(), vox_path)
    render_dir = os.path.join(tmp, "render")

    # (a) the render CLI in fp32, as a user runs it
    argv = ["--voxel_path", vox_path, "--render_dir", render_dir, "--fast",
            "--resample", "multipass", "--rotate", "--sweep_batch", "8"]
    reset_counts()
    t0 = time.perf_counter()
    demo.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    counts, by_shape = read_counts()
    n_fwd = 72 // 8
    pngs = sorted(f for f in os.listdir(render_dir) if f.endswith(".png"))
    log(f"cli: {len(pngs)} PNGs in {render_dir} in {cli_s:.3f} s, launches {counts} "
        f"over {n_fwd} batch-8 forwards")
    per_fwd = {"float32": check_counts(failures, "fp32 cli", by_shape, n_fwd)}
    out["float32"] = {"launches": counts, "forwards": n_fwd, "cli_s": cli_s,
                      "pngs": len(pngs)}
    if len(pngs) != 72:
        failures.append(f"cli wrote {len(pngs)} PNGs, expected 72")

    # (b) one bf16 shader_forward at batch 8, the serving-bench form
    cfg = ShaderConfig()
    net = init_shader_params(0, cfg, device="cuda")
    rng = np.random.default_rng(0)
    vox = torch.from_numpy(np.repeat(
        procedural_voxel().astype(np.float32)[None, :, :, :, None], 8, axis=0)).cuda()
    pose = torch.from_numpy(np.stack(
        [rng.uniform(0, 6.28, 8), rng.uniform(-1, 1, 8), np.ones(8)], axis=1
    ).astype(np.float32)).cuda()
    layers.WINOGRAD_2D = True
    with torch.no_grad():
        reset_counts()
        img = shader_forward(net, vox, pose, compute_dtype=torch.bfloat16, resample="multipass")
        torch.cuda.synchronize()
        counts, by_shape = read_counts()
        log(f"bf16 shader_forward: out {tuple(img.shape)} {img.dtype}, launches {counts}")
        per_fwd["bfloat16"] = check_counts(failures, "bf16 forward", by_shape, 1)
        out["bfloat16"] = {"launches": counts, "forwards": 1}
        if tuple(img.shape) != (8, 512, 512, 1) or not bool(torch.isfinite(img).all()):
            failures.append(f"bf16 forward: shape {tuple(img.shape)} or non-finite values")

        # (c) each dtype: one forward with kernels vs with their plain
        # versions, compared on the logits (the head's output).
        logits = []
        hook = net.encoder["e_conv11"].register_forward_hook(
            lambda mod, args, y: logits.append(y.float()))
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            fwd = lambda: shader_forward(net, vox, pose, compute_dtype=dtype,  # noqa: E731
                                         resample="multipass")
            logits.clear()
            fwd()
            got = logits.pop()
            with plain_kernels():
                reset_counts()
                img = fwd().float()
                ref = logits.pop()
                if any(read_counts()[0].values()):
                    failures.append(f"{dname} plain forward launched a kernel")
            spread = float(img.max() - img.min())
            logit_spread = float(ref.max() - ref.min())
            err = float((got - ref).abs().max())
            res = {"logit_max_abs_err": err, "logit_spread": logit_spread,
                   "rel_err": err / logit_spread, "output_spread": spread}
            out[dname]["vs_plain"] = res
            log(f"{dname} forward vs all-plain forward: {json.dumps(res)} "
                f"(tol {FORWARD_TOL[dname]} of the logit spread; spread >= {MIN_SPREAD})")
            if not err <= FORWARD_TOL[dname] * logit_spread:
                failures.append(f"{dname} forward's logits differ from the plain "
                                f"forward's by {err:.3e} of spread {logit_spread:.3e}")
            if not spread >= MIN_SPREAD:
                failures.append(f"{dname} plain forward's output spreads only {spread:.3e}")
            logits.clear()
            out[dname]["forward_ms"] = time_ms(torch, fwd, 3)
            with plain_kernels():
                out[dname]["plain_forward_ms"] = time_ms(torch, fwd, 2)
            logits.clear()
            log(f"{dname}: {out[dname]['forward_ms']:.3f} ms vs "
                f"{out[dname]['plain_forward_ms']:.3f} ms (all plain) per batch-8 forward")
        hook.remove()

        # (d) where the time of one bf16 forward goes, by device kernel
        out["bfloat16"]["profile"] = profile_run(
            torch, lambda: shader_forward(net, vox, pose, compute_dtype=torch.bfloat16,
                                          resample="multipass"))
    return out, per_fwd


# ---------------------------------------------------------------------------
# phase 4: the shader training step
# ---------------------------------------------------------------------------
def step_launches(b, patch, wgrad=False, remat=False):
    """Launches per training step, by kernel and shape key, that the graph
    implies at full width with preact_policy: the resample's 8 K1 passes on
    the 128^3 grid (at a patch, the last pass on each cropped axis, y then
    z, emits the window, and the z pass runs on the y-cropped rows);
    e_conv3 and the 21 res1 /
    res1_skip convs run K2 forward and again for their data gradients (e_conv3's
    at 16 output channels) and K2w once each; the 32 Winograd convs (21 at
    res2, 11 at res3) run K3 forward and for their data gradients, and K6
    once each with WGRAD; remat recomputes the 20 + 30 block convs."""
    n = 128
    if patch == n:
        k1 = {(b, n * n, n, n): 8}
    else:
        k1 = {(b, n * n, n, n): 6, (b, n * n, n, patch): 1, (b, n * patch, n, patch): 1}
    s = patch // 2
    x16, x32 = (b, s, s, 32, 16), (b, s, s, 32, 32)
    r2, r3 = (b, s, s, 1024), (b, s, s, 512)
    rc = 1 if remat else 0
    return {
        "K1": k1,
        "K2": {(x16, 32): 1, (x32, 32): 42 + 20 * rc, (x32, 16): 1},
        "K2w": {(x16, 32): 1, (x32, 32): 21},
        "K3": {(r2, 1024): 42 + 20 * rc, (r3, 512): 22 + 10 * rc},
        "K6": {(r2, 1024): 21, (r3, 512): 11} if wgrad else {},
    }


def check_step_counts(failures, what, by_shape, n_steps, expected):
    """Every kernel's launches over ``n_steps`` steps at each shape equal the
    per-step expectation times ``n_steps``; returns the launches per step
    by kernel and shape key."""
    per_step = {}
    for kid, exp in expected.items():
        want = {k: n * n_steps for k, n in exp.items()}
        if by_shape[kid] != want:
            failures.append(f"{what}: {kid} launched {by_shape[kid]}, expected {want}")
        per_step[kid] = {k: v // n_steps for k, v in by_shape[kid].items()}
    return per_step


def disc_images(np, b, size, seed):
    """Targets for the gradient check: a disc per image (1 inside, 0.1
    outside), so the loss gradient is not a cancelling sum of noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size] / size
    cy, cx, r = rng.uniform(0.3, 0.7, (3, b, 1, 1)) * np.array([1, 1, 0.6])[:, None, None, None]
    img = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r ** 2, 1.0, 0.1)
    return img[..., None].astype(np.float32)


def bench_batch(torch, np, b, seed=0):
    """bench.py's inputs: random occupancy, random images, random poses."""
    rng = np.random.default_rng(seed)
    vox = (rng.random((b, 64, 64, 64, 1)) > 0.7).astype(np.float32)
    img = rng.random((b, 512, 512, 1)).astype(np.float32)
    pose = np.stack([rng.uniform(0, 6.28, b), rng.uniform(-1, 1, b), np.ones(b)],
                    axis=1).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (vox, img, pose))


# Crop offsets (u0, v0), in grid cells, of the patch-64 gradient check:
# the window covers the middle of the image, where the disc targets' edges
# are.
GRAD_OFFSETS = (32, 24)


def gradient_check(torch, np, failures):
    """One step's gradients at batch 8, full width, with the kernels and
    with every kernel swapped for its plain version, in fp32 and bf16, at
    patch 128 (the full grid) and at patch 64 (at GRAD_OFFSETS)."""
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward
    from rendernet_tpu_torch.ops.crops import crop_image
    from rendernet_tpu_torch.ops.cuda_resample import rotate_resample_camera_patch_multipass
    from rendernet_tpu_torch.train.steps import shader_loss_from_images

    net = init_shader_params(0, ShaderConfig(preact_policy=True), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():  # PReLU alphas away from 0, so the negative slope counts
        for name, p in net.named_parameters():
            if name.endswith("alpha"):
                p.uniform_(0.05, 0.3, generator=gen)
    rng = np.random.default_rng(1)
    vox = torch.from_numpy(np.repeat(
        procedural_voxel().astype(np.float32)[None, :, :, :, None], 8, axis=0)).cuda()
    pose = torch.from_numpy(np.stack(
        [rng.uniform(0, 6.28, 8), rng.uniform(-1, 1, 8), np.ones(8)], axis=1
    ).astype(np.float32)).cuda()
    images = torch.from_numpy(disc_images(np, 8, 512, 2)).cuda()
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]

    def grads(dtype, patch):
        if patch == 128:
            pred = shader_forward(net, vox, pose, compute_dtype=dtype, resample="multipass")
            target = images
        else:
            with torch.no_grad():
                cam = rotate_resample_camera_patch_multipass(
                    vox, pose, GRAD_OFFSETS, patch, new_size=128, compute_dtype=dtype)
            pred = net(cam.to(dtype))
            target = crop_image(images, GRAD_OFFSETS, patch, 4)
        loss = shader_loss_from_images(pred, target, True)
        return float(loss.detach()), torch.autograd.grad(loss, params)

    out = {}
    for patch in (128, 64):
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            what = f"{dname} patch {patch} gradient check"
            reset_counts()
            loss, g = grads(dtype, patch)
            torch.cuda.synchronize()
            totals, by_shape = read_counts()
            per_step = check_step_counts(failures, what, by_shape, 1, step_launches(8, patch))
            with plain_kernels():
                reset_counts()
                loss_p, gp = grads(dtype, patch)
                if any(read_counts()[0].values()):
                    failures.append(f"{what}: the plain step launched a kernel")
            errs = {}
            for n, a, b in zip(names, g, gp):
                ref = float(b.float().abs().max())
                if not (ref > 0 and math.isfinite(ref)) or not bool(torch.isfinite(a).all()):
                    failures.append(f"{what}: gradient of {n}: plain max {ref}, or non-finite")
                    continue
                errs[n] = float((a.float() - b.float()).abs().max()) / ref
            worst = max(errs, key=errs.get)
            res = {"patch": patch, "loss": loss, "plain_loss": loss_p, "worst_param": worst,
                   "worst_rel_err": errs[worst], "tol": GRAD_TOL[dname],
                   "median_rel_err": sorted(errs.values())[len(errs) // 2],
                   "params": len(names), "launches": totals}
            out[dname, patch] = {"result": res, "per_step": per_step}
            log(f"grad {dname} " + json.dumps(res))
            if not errs[worst] <= GRAD_TOL[dname]:
                failures.append(f"{what}: gradients differ from the all-plain step's: {worst} "
                                f"{errs[worst]:.3e} > {GRAD_TOL[dname]}")
            del g, gp
    del net
    torch.cuda.empty_cache()
    return out


def run_training(torch, failures):
    """bench.py's two configurations, the extra modes and a profile."""
    import numpy as np

    from rendernet_tpu_torch.models.shader import ShaderConfig
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.ops import cuda_winograd
    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.train.steps import create_shader_state, make_shader_train_step

    layers.WINOGRAD_2D = True  # bench.py's configuration: the 2D stacks on K3
    out, per_step = {}, {}
    g = gradient_check(torch, np, failures)
    out["gradient_check"] = [v["result"] for v in g.values()]
    per_step["grad32"] = g["float32", 128]["per_step"]

    b = 24
    cfg = TrainConfig(batch_size=b, img_res=512, new_size=128, compute_dtype="bfloat16",
                      is_greyscale=True, e_eta=1e-5, moment_dtype="bfloat16")
    mcfg = ShaderConfig(preact_policy=True)
    vox, img, pose = bench_batch(torch, np, b)
    state, tx = create_shader_state(0, mcfg, cfg, device="cuda")
    train = {}
    for patch in (128, 64):
        step = make_shader_train_step(mcfg, cfg, tx, patch)
        before = {n: p.detach().clone() for n, p in state.params.named_parameters()}
        torch.cuda.reset_peak_memory_stats()
        state, loss = step(state, vox, img, pose, 1)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        losses = []
        for _ in range(8):
            state, loss = step(state, vox, img, pose, 1)
            losses.append(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        totals, by_shape = read_counts()
        ps = check_step_counts(failures, f"patch {patch} steps", by_shape, 8,
                               step_launches(b, patch))
        per_step["train" if patch == 128 else "train64"] = ps
        losses = [float(x) for x in losses]
        moved = [n for n, p in state.params.named_parameters() if not torch.equal(p, before[n])]
        finite = all(bool(torch.isfinite(p).all()) for p in state.params.parameters())
        res = {"patch": patch, "batch": b, "dtype": "bfloat16", "steps": 8,
               "ms_per_step": dt / 8 * 1e3, "frames_per_s": b * 8 / dt, "losses": losses,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "params_moved": len(moved), "params": len(before), "launches_per_step": {
                   k: v // 8 for k, v in totals.items()}}
        train[patch] = res
        log("train " + json.dumps(res))
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"patch {patch}: non-finite loss {losses}")
        if len(moved) != len(before) or not finite:
            failures.append(f"patch {patch}: {len(before) - len(moved)} parameters did not "
                            f"move, or a parameter is not finite")
        del before
    out["train"] = train

    # extra modes, one step each at patch 128
    extra = {}
    for mode, wgrad, remat in (("wgrad_bf16", True, False), ("wgrad_fp32", "fp32", False),
                               ("remat", False, True)):
        cuda_winograd.WGRAD = wgrad
        step = make_shader_train_step(ShaderConfig(preact_policy=True, remat=remat), cfg, tx, 128)
        reset_counts()
        t0 = time.perf_counter()
        state, loss = step(state, vox, img, pose, 1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        totals, by_shape = read_counts()
        ps = check_step_counts(failures, f"{mode} step", by_shape, 1,
                               step_launches(b, 128, wgrad=bool(wgrad), remat=remat))
        if wgrad:
            per_step[mode] = ps
        extra[mode] = {"ms": dt * 1e3, "loss": float(loss), "launches": totals}
        log(f"extra {mode} " + json.dumps(extra[mode]))
        if not math.isfinite(float(loss)):
            failures.append(f"{mode} step: non-finite loss")
    cuda_winograd.WGRAD = False
    out["extra_modes"] = extra

    step = make_shader_train_step(mcfg, cfg, tx, 128)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], vox, img, pose, 1)

    out["profile"] = profile_run(torch, one_step)
    return out, per_step


def profile_run(torch, fn, top: int = 12):
    """Device time by kernel name over one call of ``fn`` (torch.profiler),
    and the device's busy share of its wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for evt in prof.key_averages():  # device kernels only, not the host ops above them
        if "CUDA" not in str(getattr(evt, "device_type", "")):
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((evt.key, evt.count, dev_us))
    rows.sort(key=lambda r: -r[2])
    busy_us = sum(r[2] for r in rows)
    res = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us if wall_us else None,
           "top": [{"kernel": k[:90], "count": c, "ms": us / 1e3} for k, c, us in rows[:top]]}
    log("profile " + json.dumps(res))
    return res


class plain_kernels:
    """Route every kernel wrapper to its plain version (on the card)."""

    def __enter__(self):
        from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd

        swaps = [(cuda_resample, "apply_interp_pass", cuda_resample.interp_pass_plain),
                 (cuda_conv3d, "nc_conv3d_forward", cuda_conv3d.nc_conv3d_plain),
                 (cuda_conv3d, "nc_conv3d_wgrad", cuda_conv3d.nc_conv3d_wgrad_plain),
                 (cuda_winograd, "wino_conv2d_forward", cuda_winograd.wino_conv2d_plain),
                 (cuda_winograd, "wino_wgrad", cuda_winograd.wino_wgrad_plain)]
        self.saved = [(m, n, getattr(m, n), p) for m, n, p in swaps]
        for m, n, _, p in self.saved:
            setattr(m, n, p)

    def __exit__(self, *exc):
        for m, n, orig, _ in self.saved:
            setattr(m, n, orig)


def main() -> int:
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    try:
        from rendernet_tpu_torch.ops import _native
    except ImportError as e:
        print(f"chip_smoke: the port is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    logs = _native.build_all()
    log(f"built {len(logs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  [{name}] {line.strip()}")

    failures: list = []
    t0 = time.perf_counter()
    rows = run_kernel_checks(torch, failures)
    log(f"phase 2 (kernels) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        main_out, per_fwd = run_main_path(torch, failures, tmp)
    log(f"phase 3 (serving) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_out["training"], per_step = run_training(torch, failures)
    log(f"phase 4 (training) took {time.perf_counter() - t0:.1f} s")

    kernels = []
    for (kid, label, dname), r in rows.items():
        if r["run"] in (None, "check"):
            continue
        if r["run"] == "serve":
            launches = per_fwd[dname][kid, label]
        else:
            launches = per_step[r["run"]].get(kid, {}).get(r["key"], 0)
            if launches == 0:
                failures.append(f"{kid} {label}: not launched in its run ({r['run']})")
        src, replaces = REPO_SOURCES[kid]
        kernels.append({
            "name": f"{kid} {label} {dname}", "route": "cuda",
            "source": src, "replaces": replaces, "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(smi)
    print("main_path " + json.dumps(main_out))
    if failures:
        for f in failures:
            print(f"FAIL: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
