#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``rendernet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, all of them on every run:
  1. build every CUDA kernel from ``rendernet_tpu_torch/csrc`` (one nvcc per
     source, in parallel), print the card's name and power limit, and count
     the tensor-core, TMA and bulk-copy instructions in the SASS of K3's,
     K6's, K2's, K2w's, K5's, K5w's, K1's and K4's libraries (K3, K6, K5 or
     K5w without wgmma or without TMA loads, K2 / K2w without mma.sync or
     wgmma, or K1 / K4 without bulk copies, is a failure, as is a ptxas
     line saying it serializes K6's, K2's, K2w's, K5's or K5w's tensor-core
     code);
  2. kernels: call each kernel's wrapper (K1 resample pass, K4 its adjoint,
     K2 conv3d, K2w its weight gradient, K3 Winograd, K6 the Winograd weight
     gradient, K5 the fused wide conv, K5w its weight gradient) at the shapes the serving path (batch 8), the training step
     (bf16 at batch 24; fp32 at batch 8, the gradient check's) and the
     inverse-rendering step (5 hypotheses; fp32 and bf16) give it, and at
     the data-gradient shapes, plus one ragged shape each; hold it against
     its plain PyTorch version in the working dtype; time kernel, plain
     version and the library yardstick with CUDA events (cuDNN for the
     convolutions; ``F.grid_sample``'s kernel ``grid_sampler_2d`` for K1
     and its backward ``grid_sampler_2d_backward`` for K4, whose errors
     against the plain version are printed, not gated: bf16 grids round
     the positions);
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
     a warm-up step, then 8 timed steps on one fixed batch; (c) the
     patch-128 step with ``WGRAD=True`` (K6, bf16 operands), ``WGRAD="fp32"``
     (K6, fp32 products) and ``remat=True``: a warm-up step, then 3 timed
     steps each (median, peak memory), and a profile of one ``WGRAD=True``
     step; (d) a profile of one patch-128 step;
  5. inverse rendering at ``ReconConfig()`` (5 pose hypotheses, 64^3
     shape and texture grids, a 128^3 camera grid, the 512^2 two-head
     renderer, Phong composite, per-sample MSE), random weights from seeds:
     (a) one step's latent gradients in fp32 (TF32 off) and bf16 on a
     target the port renders at a known pose, with the kernels and with
     every kernel (K4 included) replaced by its plain version, compared
     group by group (RECON_GRAD_TOL), with three planted faults that the
     comparison must reject; (b)
     ``make_recon_step`` in fp32 and bf16 on a fixed random 512^2 target:
     a warm-up step, then 5 timed steps; (c) the ``reconstruct`` CLI with
     ``--random-weights --dump-every 2`` (2 epochs of 4 steps) on albedo
     and normal targets that the port renders at a known pose; (d) a
     profile of one bf16 step; (e) one profiled call of the resample warp
     alone, at serving (bf16, batch 8, forward) and at recon (bf16 shape
     and texture grids, forward and backward), its device time split into
     K1, K4, the copies around them, the matmuls and reductions (the plan's
     and ``pass_param_grad``'s) and the rest (``warp_profile`` lines).
  6. the fused wide-conv route (``layers.CUDA_CONV2D`` on, with
     ``WINOGRAD_2D``, which it takes precedence over): (a) is part of phase
     2: K5 (each epilogue: none, bias, bias+PReLU with and without the
     pre-activation, bias+ReLU, bias+residual) and K5w at the serving
     (batch 8, fp32 and bf16), training (bf16 at batch 24, patch 128 and
     64; fp32 at batch 8) and recon shapes, the data-gradient calls and a
     ragged shape; (b) one batch-8 forward per dtype, its logits against
     the all-plain forward's (phase 3's limits), timed; (c) the gradient
     check at patch 128 (phase 4's limits), bench.py's two configurations
     (a warm-up and 8 timed steps each, peak memory), one step with
     ``PRELU_SAVE_PRE`` off and one with remat; (d) the recon latent
     gradients with phase 5's limits and controls, then 5 timed
     ``make_recon_step``s per dtype; (e) a profiled bf16 patch-128 step.
The kernels' launch counters are zeroed just before each run of phases 3,
4, 5 and 6 and read just after; every run's counts are checked, shape by
shape, against the counts its graph implies. K1's and K4's phase 2 rows
name the path each launch took (``bulk`` or ``scalar``, from the
wrappers' path counters); K3's carry the bytes of its bf16 V scratch; the
serving, training and recon profiles print K1's, K4's, K2's, K2w's, K3's,
K6's, K5's and K5w's device time and share of busy time; a
``train_memory`` line gives K3's V scratch and K6's scratch per training
call and each training run's peak memory.

Prints a ``{"kernels": [...]}`` line with one row per kernel, dtype and
main-path shape: a serving row's ``launches`` is per batch-8 forward of that
dtype's serving run (the fp32 CLI's counts divided by its 9 forwards, after
checking they are exact multiples); a training row's is per training step
of the run named in the row (the bf16 patch-128 or patch-64 steps, the
fp32 patch-128 gradient check, or the WGRAD steps for K6); a recon row's is
per inverse-rendering step of its dtype; phase 6's K5 / K5w rows count the
flag-on run named in the row the same way (per forward, step or recon step;
the z-recompute row per step with PRELU_SAVE_PRE off). The ragged shapes and the fp32
batch-24 checks are printed on ``ragged`` and ``check`` lines of their own.
The last line is ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, when there is no CUDA card, when the port is missing,
or when any check fails.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
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
    "K4": ("rendernet_tpu_torch/csrc/resample_bwd.cu",
           "rendernet_tpu/ops/pallas_resample.py:347 (_bwd_kernel)"),
    "K2": ("rendernet_tpu_torch/csrc/conv3d.cu",
           "rendernet_tpu/ops/pallas_conv3d.py:165 (_fwd_kernel)"),
    "K2w": ("rendernet_tpu_torch/csrc/conv3d_wgrad.cu",
            "rendernet_tpu/ops/pallas_conv3d.py:186 (_wgrad_kernel)"),
    "K3": ("rendernet_tpu_torch/csrc/winograd.cu",
           "rendernet_tpu/ops/pallas_winograd.py:147 (_kernel)"),
    "K6": ("rendernet_tpu_torch/csrc/winograd_wgrad.cu",
           "rendernet_tpu/ops/pallas_winograd.py:342 (_wgrad_kernel)"),
    "K5": ("rendernet_tpu_torch/csrc/conv2d.cu",
           "rendernet_tpu/ops/pallas_conv2d.py:252 (_fwd_kernel)"),
    "K5w": ("rendernet_tpu_torch/csrc/conv2d_wgrad.cu",
            "rendernet_tpu/ops/pallas_conv2d.py:304 (_wgrad_kernel)"),
}

# The launch counter of each kernel: (module, attribute prefix).
COUNTERS = {"K1": ("cuda_resample", ""), "K4": ("cuda_resample", "bwd_"),
            "K2": ("cuda_conv3d", ""),
            "K2w": ("cuda_conv3d", "wgrad_"), "K3": ("cuda_winograd", ""),
            "K6": ("cuda_winograd", "wgrad_"), "K5": ("cuda_conv2d", ""),
            "K5w": ("cuda_conv2d", "wgrad_")}


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


def bound_dtype(op: str, dname: str) -> str:
    """The peak rate that bounds a case's operations: K4's fp32 CUDA-core
    math, K6's bf16 tensor-core passes (three for fp32 products), else the
    storage dtype's."""
    return {"pass_bwd": "float32", "wino_wgrad": "bfloat16"}.get(op, dname)


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
# and "wgrad_fp32": per step with WGRAD=True or "fp32"; "recon32" and
# "recon16": per fp32 / bf16 inverse-rendering step of phase 5), "check"
# for a checked and timed shape no run launches, None for a ragged shape.
# Specs: pass (BC, R, L, out_lanes, db[, alpha sign]), where out_lanes < L
# is a pass that emits a crop window (the patch-64 step's last pass on each
# cropped axis) and alpha < 0 a pass that folds a deferred quarter-turn
# flip; pass_bwd (BC, R, L, out_lanes, db, taps, alpha sign), K4 on the
# pass's cotangent (K1's and K4's launches count their shape, either
# sign); conv3d / conv3d_wgrad / wino / wino_wgrad (input shape, output
# channels); conv3d_dgrad / wino_dgrad
# (cotangent shape, channels of the data gradient), which run the forward
# kernel on the flipped, io-swapped weights of the conv, as the backward
# does (a strided view the wrapper copies).
F32, BF16, BOTH = ("float32",), ("bfloat16",), ("float32", "bfloat16")


def _conv2d_cases():
    """Phase 6's K5 / K5w cases, HWNC shapes: "conv2d" (input, co, epilogue)
    keyed as the wrapper counts them; "conv2d_dgrad" (cotangent, channels of
    the data gradient), whose key is a plain conv's (epilogue "none", shared
    with the skip conv's forward at square shapes); "conv2d_wgrad" (input,
    co). Runs: "serve2d16"/"serve2d32" per bf16 / fp32 batch-8 forward with
    the flag on; "train2d"/"train2d64" per bf16 step at batch 24, patch 128
    / 64; "grad2d32" per fp32 gradient-check step (batch 8); "nosave2d" per
    step with PRELU_SAVE_PRE off; "recon2d32"/"recon2d16" per
    inverse-rendering step."""
    cases = []
    for c, stack in ((1024, "res2"), (512, "res3")):
        x8, x24, x24p = (64, 64, 8, c), (64, 64, 24, c), (32, 32, 24, c)
        for dn, run in (("float32", "serve2d32"), ("bfloat16", "serve2d16")):
            cases += [("K5", f"{stack} prelu {list(x8)}->{c}", "conv2d", (x8, c, "bias+prelu"),
                       (dn,), run),
                      ("K5", f"{stack} res {list(x8)}->{c}", "conv2d", (x8, c, "bias+res"),
                       (dn,), run),
                      ("K5", f"{stack}_skip {list(x8)}->{c}", "conv2d", (x8, c, "none"),
                       (dn,), run)]
        for xs, run, tag in ((x24, "train2d", "train"), (x24p, "train2d64", "train64")):
            cases += [("K5", f"{tag} {stack} prelu+pre {list(xs)}->{c}", "conv2d",
                       (xs, c, "bias+prelu+pre"), BF16, run),
                      ("K5", f"{tag} {stack} res {list(xs)}->{c}", "conv2d", (xs, c, "bias+res"),
                       BF16, run),
                      ("K5", f"{tag} {stack}_skip fwd + dgrad {list(xs)}->{c}", "conv2d_dgrad",
                       (xs, c), BF16, run),
                      ("K5w", f"{tag} {stack} {list(xs)}->{c}", "conv2d_wgrad", (xs, c), BF16,
                       run)]
        cases += [("K5", f"train {stack} prelu+pre {list(x8)}->{c}", "conv2d",
                   (x8, c, "bias+prelu+pre"), F32, "grad2d32"),
                  ("K5", f"train {stack}_skip fwd + dgrad {list(x8)}->{c}", "conv2d_dgrad",
                   (x8, c), F32, "grad2d32"),
                  ("K5w", f"train {stack} {list(x8)}->{c}", "conv2d_wgrad", (x8, c), F32,
                   "grad2d32"),
                  ("K5", f"train {stack} z recompute {list(x24)}->{c}", "conv2d",
                   (x24, c, "bias"), BF16, "nosave2d")]
    for c, stack in ((512, "res2"), (256, "res3")):
        xr = (64, 64, 5, c)
        for dn, run in (("float32", "recon2d32"), ("bfloat16", "recon2d16")):
            cases += [("K5", f"recon {stack} relu {list(xr)}->{c}", "conv2d",
                       (xr, c, "bias+relu"), (dn,), run),
                      ("K5", f"recon {stack} res {list(xr)}->{c}", "conv2d", (xr, c, "bias+res"),
                       (dn,), run),
                      ("K5", f"recon {stack}_skip fwd + dgrad {list(xr)}->{c}", "conv2d_dgrad",
                       (xr, c), (dn,), run)]
    xg = (7, 8, 3, 384)  # odd H, batch 3, 384 -> 256 channels: 168 pixels
    cases += [("K5", f"ragged {list(xg)}->256 {epi}", "conv2d", (xg, 256, epi), BOTH, None)
              for epi in ("none", "bias+prelu+pre", "bias+relu", "bias+res")]
    cases += [("K5", "ragged dgrad [7,8,3,256]->384", "conv2d_dgrad", ((7, 8, 3, 256), 384),
               BOTH, None),
              ("K5w", f"ragged {list(xg)}->256", "conv2d_wgrad", (xg, 256), BOTH, None)]
    return cases


CONV2D_CASES = _conv2d_cases()
X3 = {8: (8, 64, 64, 32, 32), 24: (24, 64, 64, 32, 32)}
X3P = (24, 32, 32, 32, 32)  # res1 at patch 64
XR = (5, 64, 64, 32, 16)  # the inverse renderer's e_conv3 and res1 input
CASES = [
    ("K1", "pass [8,16384,128]", "pass", (8, 16384, 128, 128, 128), BOTH, "serve"),
    ("K1", "train pass [24,16384,128]", "pass", (24, 16384, 128, 128, 128), BF16, "train"),
    ("K1", "train64 pass [24,16384,128]", "pass", (24, 16384, 128, 128, 128), BF16, "train64"),
    ("K1", "train64 window pass [24,16384,128]->64", "pass", (24, 16384, 128, 64, 128), BF16,
     "train64"),
    ("K1", "train64 window pass [24,8192,128]->64", "pass", (24, 8192, 128, 64, 128), BF16,
     "train64"),
    ("K1", "ragged pass [3,1000,100]->37", "pass", (3, 1000, 100, 37, 40), BOTH, None),
    ("K1", "recon shape pass [5,16384,128]", "pass", (5, 16384, 128, 128, 128), F32, "recon32"),
    ("K1", "recon shape pass [5,16384,128]", "pass", (5, 16384, 128, 128, 128), BF16, "recon16"),
    ("K1", "recon texture pass [20,16384,128]", "pass", (20, 16384, 128, 128, 128), F32,
     "recon32"),
    ("K1", "recon texture pass [20,16384,128]", "pass", (20, 16384, 128, 128, 128), BF16,
     "recon16"),
    ("K1", "recon texture pass [20,16384,128] alpha<0", "pass",
     (20, 16384, 128, 128, 128, -1), F32, "recon32"),
    ("K1", "recon texture pass [20,16384,128] alpha<0", "pass",
     (20, 16384, 128, 128, 128, -1), BF16, "recon16"),
    *[("K4", f"recon {what} adjoint [{bc},16384,128] taps {taps}", "pass_bwd",
       (bc, 16384, 128, 128, 128, taps, 1), (dn,), run)
      for what, bc in (("shape", 5), ("texture", 20)) for taps in (3, 6)
      for dn, run in (("float32", "recon32"), ("bfloat16", "recon16"))],
    *[("K4", f"recon texture adjoint [20,16384,128] taps {taps} alpha<0", "pass_bwd",
       (20, 16384, 128, 128, 128, taps, -1), (dn,), run)
      for taps in (3, 6) for dn, run in (("float32", "recon32"), ("bfloat16", "recon16"))],
    ("K4", "ragged adjoint [3,1000,100]->37 taps 4 alpha<0", "pass_bwd",
     (3, 1000, 100, 37, 40, 4, -1), BOTH, None),
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
    ("K2", "recon e_conv3/res1 fwd+dgrad [5,64,64,32,16]->16", "conv3d", (XR, 16), F32,
     "recon32"),
    ("K2", "recon e_conv3/res1 fwd+dgrad [5,64,64,32,16]->16", "conv3d", (XR, 16), BF16,
     "recon16"),
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
    *CONV2D_CASES,
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
    if op == "pass_bwd":
        return tuple(spec[:4]) + (spec[5],)
    if op == "conv2d":
        return tuple(spec[0]), spec[1], spec[2]
    if op == "conv2d_dgrad":
        return tuple(spec[0]), spec[1], "none"
    return tuple(spec[0]), spec[1]


def make_case(torch, op, spec, dtype, gen):
    """(kernel fn, plain fn, library fn or None, flops, bytes, output is fp32).
    K4's functions return (gv, gp), held part by part."""
    from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd

    dev = torch.device("cuda")
    item = torch.tensor([], dtype=dtype).element_size()
    grad = torch.nn.grad

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def cf(t):  # channels last -> channels first (a view)
        return t.movedim(-1, 1)

    if op == "pass":
        bc, r, lanes, ol, db = spec[:5]
        sign = spec[5] if len(spec) > 5 else 1
        vol = rnd(bc, r, lanes)
        u = torch.rand(bc, 4, generator=gen, device=dev) * 2 - 1
        delta = 20 * u[:, 3] if sign > 0 else lanes - 1 - 20 * u[:, 3]
        params = torch.stack([sign * (1 + 0.4 * u[:, 0]), 0.4 * u[:, 1], 0.4 * u[:, 2],
                              delta], dim=-1)
        inp, grid = _grid_sample_operands(torch, vol, params, db, ol)
        return (lambda: cuda_resample.interp_pass_fwd(vol, params, db, ol),
                lambda: cuda_resample.interp_pass_plain(vol, params, db, ol),
                lambda: torch.grid_sampler_2d(inp, grid, 0, 0, True),
                10.0 * bc * r * ol, item * bc * (r * lanes + r * ol) + 16 * bc, False)
    if op == "pass_bwd":  # reads v and g, writes gv (vol's dtype) and gp (fp32)
        bc, r, lanes, ol, db, taps, sign = spec
        vol = rnd(bc, r, lanes)
        u = torch.rand(bc, 4, generator=gen, device=dev) * 2 - 1
        alpha = sign * (1 + 0.4 * u[:, 0])
        delta = 20 * u[:, 3] if sign > 0 else lanes - 1 - 20 * u[:, 3]
        params = torch.stack([alpha, 0.4 * u[:, 1], 0.4 * u[:, 2], delta], dim=-1)
        g = rnd(bc, r, ol)
        inp, grid = _grid_sample_operands(torch, vol, params, db, ol)
        g4 = g.reshape(bc * r, 1, 1, ol)
        return (lambda: cuda_resample.interp_pass_bwd(vol, params, g, db, taps, ol),
                lambda: cuda_resample.interp_pass_bwd_plain(vol, params, g, db, taps, ol),
                lambda: torch.ops.aten.grid_sampler_2d_backward(g4, inp, grid, 0, 0, True,
                                                                [True, True]),
                bc * r * (10.0 * taps * lanes + 8.0 * ol),
                item * bc * r * (2 * lanes + ol) + 4 * bc * r * ol + 16 * bc, False)
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
    if op.startswith("conv2d"):
        return conv2d_case(torch, op, spec, dtype, rnd, m, c)
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
    if op == "wino_wgrad":  # the split form (fp32 products) does three bf16 passes
        fp32_ops = spec[2]
        passes = 3 if cuda_winograd.wgrad_split(dtype, fp32_ops) else 1
        x = rnd(*xs)
        gy = rnd(*xs[:-1], co)
        return (lambda: cuda_winograd.wino_wgrad(x, gy, fp32_ops),
                lambda: cuda_winograd.wino_wgrad_plain(x, gy, fp32_ops),
                lambda: grad.conv2d_weight(cf(x), (co, c, 3, 3), cf(gy), padding=1),
                passes * 2.0 * 16 * tiles * c * co,
                item * (x.numel() + gy.numel()) + 4 * 9 * c * co, True)
    raise ValueError(op)


def _grid_sample_operands(torch, vol, params, db, ol):
    """K1's pass as ``F.grid_sample`` (bilinear, zeros padding, aligned
    corners; timed as its native kernel ``torch.grid_sampler_2d``, since
    the cuDNN sampler that ``F.grid_sample`` may pick refuses these shapes)
    sees it: each of the BC * R rows an image of height 1 and width L,
    sampled at the pass's positions ``alpha l + c_a d_a + c_b d_b + delta``
    mapped to [-1, 1] (y 0). Zero padding is K1's out-of-range
    rule; its backward gives K4's voxel cotangent and, times 2 / (L - 1),
    its position cotangent. The grid takes the input's dtype (grid_sample
    requires it), so in bf16 its positions round: its results are printed
    beside the kernel's, not gated."""
    bc, r, lanes = vol.shape
    rows = torch.arange(r, device=vol.device)
    d_a = (rows // db).to(torch.float32)[None, :, None]
    d_b = (rows % db).to(torch.float32)[None, :, None]
    ll = torch.arange(ol, device=vol.device, dtype=torch.float32)[None, None, :]
    p = params.to(torch.float32)
    pos = p[:, 0, None, None] * ll + (p[:, 1, None, None] * d_a + p[:, 2, None, None] * d_b
                                      + p[:, 3, None, None])
    x = pos * (2.0 / (lanes - 1)) - 1.0
    grid = torch.stack([x, torch.zeros_like(x)], dim=-1).reshape(bc * r, 1, ol, 2)
    return vol.reshape(bc * r, 1, 1, lanes), grid.to(vol.dtype)


def library_as_plain(op, spec, out):
    """The K1 / K4 library call's result in its plain version's layout:
    K1 [BC, R, out_lanes]; K4 (gv [BC, R, L], gp [BC, R, out_lanes] fp32)."""
    bc, r, lanes, ol = spec[:4]
    if op == "pass":
        return out.reshape(bc, r, ol)
    gv, ggrid = out
    gp = ggrid[..., 0].float() * (2.0 / (lanes - 1))
    return gv.reshape(bc, r, lanes), gp.reshape(bc, r, ol)


def conv2d_case(torch, op, spec, dtype, rnd, m, c):
    """make_case for K5 and K5w on HWNC inputs [H, W, B, C]. The cuDNN
    yardstick runs on channels-last (NHWC) copies, with no epilogue."""
    from rendernet_tpu_torch.ops import cuda_conv2d

    grad = torch.nn.grad
    item = torch.tensor([], dtype=dtype).element_size()
    xs, co = spec[0], spec[1]
    h, wd, b = xs[:3]

    def nchw(t):  # HWNC -> an NCHW view of a channels-last copy
        return t.permute(2, 0, 1, 3).contiguous().permute(0, 3, 1, 2)

    flops = 2.0 * m * 9 * c * co
    if op == "conv2d_wgrad":
        x, gz = rnd(*xs), rnd(h, wd, b, co)
        xl, gl = nchw(x), nchw(gz)
        return (lambda: cuda_conv2d.conv2d_wgrad(x, gz),
                lambda: cuda_conv2d.conv2d_wgrad_plain(x, gz),
                lambda: grad.conv2d_weight(xl, (co, c, 3, 3), gl, padding=1),
                flops, item * (x.numel() + gz.numel()) + 4 * 9 * c * co, True)
    if op == "conv2d_dgrad":  # gz [.., c] of a conv co -> c; the data gradient has co channels
        gz = rnd(*xs)
        w = rnd(3, 3, co, c, scale=1.0 / math.sqrt(9 * co))
        wf = torch.flip(w, (0, 1)).transpose(2, 3)
        gl, wl = nchw(gz), w.permute(3, 2, 0, 1).contiguous()
        return (lambda: cuda_conv2d.conv2d_hwnc(gz, wf),
                lambda: cuda_conv2d.conv2d_hwnc_plain(gz, wf),
                lambda: grad.conv2d_input((b, co, h, wd), wl, gl, padding=1),
                flops, item * (gz.numel() + w.numel() + m * co), False)
    epi = spec[2]
    x = rnd(*xs)
    w = rnd(3, 3, c, co, scale=1.0 / math.sqrt(9 * c))
    kw, extra = {}, 0
    if "bias" in epi:
        kw["bias"], extra = rnd(co, scale=0.1), extra + 4 * co
    if "prelu" in epi:
        kw.update(act="prelu", alpha=rnd(co).abs() * 0.3, emit_pre="pre" in epi)
        extra += 4 * co + item * m * co * ("pre" in epi)
    if "relu" in epi.split("+"):
        kw["act"] = "relu"
    if "res" in epi:
        kw["res"], extra = rnd(h, wd, b, co), extra + item * m * co
    xl, wl = nchw(x), w.permute(3, 2, 0, 1).contiguous()
    return (lambda: cuda_conv2d.conv2d_hwnc(x, w, **kw),
            lambda: cuda_conv2d.conv2d_hwnc_plain(x, w, **kw),
            lambda: torch.nn.functional.conv2d(xl, wl, padding=1),
            flops, item * (x.numel() + w.numel() + m * co) + extra, False)


def run_kernel_checks(torch, failures):
    """Checks and times every case; returns the rows, keyed by kernel id,
    label and dtype name."""
    from rendernet_tpu_torch.ops import cuda_winograd

    rows = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kid, label, op, spec, dnames, run in CASES:
        for dname in dnames:
            dtype = getattr(torch, dname)
            kern, plain, lib, flops, nbytes, f32_out = make_case(torch, op, spec, dtype, gen)
            by_path = path_counter(kid) if kid in ("K1", "K4") else None
            before = dict(by_path or {})
            got = kern()
            # K1's and K4's path ("bulk" or "scalar"), from the launch counter
            path = ",".join(sorted(k for k, n in by_path.items()
                                   if n > before.get(k, 0))) if by_path is not None else None
            ref = plain()
            torch.cuda.synchronize()
            got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
            ok, err, scale, tol = True, 0.0, 0.0, 0.0
            for a, b in zip(got, ref):  # each part within its own tolerance
                part_scale = max(float(b.float().abs().max()), 1e-30)
                part_err = float((a.float() - b.float()).abs().max())
                part_tol = (WGRAD_TOL if f32_out else KERNEL_TOL[dname]) * part_scale
                ok = ok and bool(torch.isfinite(a.float()).all()) and part_err <= part_tol
                err, scale, tol = max(err, part_err), max(scale, part_scale), max(tol, part_tol)
            lib_err = None
            if op in ("pass", "pass_bwd"):  # printed, not gated (library_as_plain)
                lo = library_as_plain(op, spec, lib())
                lo = lo if isinstance(lo, tuple) else (lo,)
                lib_err = [float((a.float() - b.float()).abs().max()) for a, b in zip(lo, ref)]
                del lo
            del got, ref
            kms = time_ms(torch, kern, 20)
            pms = time_ms(torch, plain, 5)
            lms = time_ms(torch, lib, 20) if lib is not None else None
            bms, by = bound(flops, nbytes, bound_dtype(op, dname))
            row = dict(kernel=kid, shape=label, dtype=dname, max_abs_err=err,
                       max_abs_ref=scale, tol=tol, ok=ok, ms=kms, plain_ms=pms,
                       library_ms=lms, bound_ms=bms, bound_by=by, run=run,
                       key=case_key(op, spec))
            if path is not None:
                row["path"] = path
            if lib_err is not None:
                row["library_max_abs_err"] = lib_err
            if kid == "K3":
                row["v_scratch_bytes"] = cuda_winograd.v_scratch_bytes(spec[0], dtype)
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
def path_counter(kid):
    """K1's or K4's launches by path (``cuda_resample.pass_plan``)."""
    from rendernet_tpu_torch.ops import cuda_resample

    return {"K1": cuda_resample.launches_by_path, "K4": cuda_resample.bwd_launches_by_path}[kid]


def _counters():
    from rendernet_tpu_torch.ops import cuda_conv2d, cuda_conv3d, cuda_resample, cuda_winograd

    mods = {"cuda_resample": cuda_resample, "cuda_conv3d": cuda_conv3d,
            "cuda_winograd": cuda_winograd, "cuda_conv2d": cuda_conv2d}
    return {kid: (mods[m], p) for kid, (m, p) in COUNTERS.items()}


def reset_counts():
    for mod, p in _counters().values():
        setattr(mod, p + "launches", 0)
        getattr(mod, p + "launches_by_shape").clear()
    for kid in ("K1", "K4"):
        path_counter(kid).clear()


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
    for kid in ("K4", "K2w", "K6", "K5", "K5w"):
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
def k5_launches(b, s, widths, blocks, act="prelu", grad=True, wgrad=True, save_pre=True,
                remat=False):
    """K5 and K5w launches by key that the fused route implies for 2D res
    stacks of ``blocks`` blocks at ``widths`` channels on [s, s, b, C] HWNC
    inputs, each stack followed by its skip conv: per block a
    prelu/relu op (emitting z for the backward with ``save_pre``) and a res
    op, and the skip conv's plain K5 ("none"); with ``grad`` a data
    gradient per op (also "none"), the z recompute per PReLU op without
    ``save_pre``, the block ops again under ``remat``, and with ``wgrad``
    K5w once per op."""
    k5, k5w = {}, {}
    for c, n in zip(widths, blocks):
        x = (s, s, b, c)
        first = "bias+relu" if act == "relu" else (
            "bias+prelu+pre" if grad and save_pre else "bias+prelu")
        reps = 2 if remat else 1
        k5[(x, c, first)] = n * reps
        k5[(x, c, "bias+res")] = n * reps
        k5[(x, c, "none")] = 1 + ((2 * n + 1) if grad else 0)
        if act == "prelu" and grad and not save_pre:
            k5[(x, c, "bias")] = n
        if grad and wgrad:
            k5w[(x, c)] = 2 * n + 1
    return k5, k5w


def step_launches(b, patch, wgrad=False, remat=False, conv2d=False, save_pre=True):
    """Launches per training step, by kernel and shape key, that the graph
    implies at full width with preact_policy: the resample's 8 K1 passes on
    the 128^3 grid (at a patch, the last pass on each cropped axis, y then
    z, emits the window, and the z pass runs on the y-cropped rows);
    e_conv3 and the 21 res1 /
    res1_skip convs run K2 forward and again for their data gradients (e_conv3's
    at 16 output channels) and K2w once each; the 32 Winograd convs (21 at
    res2, 11 at res3) run K3 forward and for their data gradients, and K6
    once each with WGRAD; remat recomputes the 20 + 30 block convs. With
    ``conv2d`` (phase 6) those 32 convs run the fused route instead
    (k5_launches) and K3 and K6 run none."""
    n = 128
    if patch == n:
        k1 = {(b, n * n, n, n): 8}
    else:
        k1 = {(b, n * n, n, n): 6, (b, n * n, n, patch): 1, (b, n * patch, n, patch): 1}
    s = patch // 2
    x16, x32 = (b, s, s, 32, 16), (b, s, s, 32, 32)
    r2, r3 = (b, s, s, 1024), (b, s, s, 512)
    rc = 1 if remat else 0
    if conv2d:
        k5, k5w = k5_launches(b, s, (1024, 512), (10, 5), save_pre=save_pre, remat=remat)
    else:
        k5, k5w = {}, {}
    return {
        "K1": k1,
        "K4": {},  # the warp runs under no_grad: voxels and pose are data here
        "K2": {(x16, 32): 1, (x32, 32): 42 + 20 * rc, (x32, 16): 1},
        "K2w": {(x16, 32): 1, (x32, 32): 21},
        "K3": {} if conv2d else {(r2, 1024): 42 + 20 * rc, (r3, 512): 22 + 10 * rc},
        "K6": {(r2, 1024): 21, (r3, 512): 11} if wgrad and not conv2d else {},
        "K5": k5, "K5w": k5w,
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


def gradient_check(torch, np, failures, patches=(128, 64), conv2d=False, tag="grad"):
    """One step's gradients at batch 8, full width, with the kernels and
    with every kernel swapped for its plain version, in fp32 and bf16, at
    patch 128 (the full grid) and at patch 64 (at GRAD_OFFSETS); ``conv2d``
    says the fused route is on (the launches it implies)."""
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
    for patch in patches:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).split(".")[-1]
            what = f"{tag} {dname} patch {patch} gradient check"
            reset_counts()
            loss, g = grads(dtype, patch)
            torch.cuda.synchronize()
            totals, by_shape = read_counts()
            per_step = check_step_counts(failures, what, by_shape, 1,
                                         step_launches(8, patch, conv2d=conv2d))
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
            log(f"{tag} {dname} " + json.dumps(res))
            if not errs[worst] <= GRAD_TOL[dname]:
                failures.append(f"{what}: gradients differ from the all-plain step's: {worst} "
                                f"{errs[worst]:.3e} > {GRAD_TOL[dname]}")
            del g, gp
    del net
    torch.cuda.empty_cache()
    return out


TRAIN_STEPS = 8
EXTRA_STEPS = 3  # timed steps of each extra mode (WGRAD=True, WGRAD="fp32", remat)


def timed_steps(torch, failures, state, step, batch, n, expected, what, tag, info):
    """A warm-up step, then ``n`` timed steps of ``step`` on one batch
    (synchronize to synchronize; each step's time, and their median, from
    CUDA events recorded between the steps), with peak memory, launch
    counts checked against ``expected`` per step, every loss finite and
    every parameter finite and moved. Returns (state, result, launches per
    step)."""
    before = {k: p.detach().clone() for k, p in state.params.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    state, loss = step(state, *batch, 1)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    t0 = time.perf_counter()
    marks[0].record()
    losses = []
    for i in range(n):
        state, loss = step(state, *batch, 1)
        marks[i + 1].record()
        losses.append(loss)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    totals, by_shape = read_counts()
    ps = check_step_counts(failures, what, by_shape, n, expected)
    losses = [float(x) for x in losses]
    moved = [k for k, p in state.params.named_parameters() if not torch.equal(p, before[k])]
    finite = all(bool(torch.isfinite(p).all()) for p in state.params.parameters())
    res = dict(info, steps=n, ms_per_step=dt / n * 1e3, step_ms=step_ms,
               median_ms=statistics.median(step_ms), frames_per_s=batch[0].shape[0] * n / dt, losses=losses,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               params_moved=len(moved), params=len(before),
               launches_per_step={k: v // n for k, v in totals.items()})
    log(f"{tag} " + json.dumps(res))
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"{what}: non-finite loss {losses}")
    if len(moved) != len(before) or not finite:
        failures.append(f"{what}: {len(before) - len(moved)} parameters did not move, or a "
                        f"parameter is not finite")
    return state, res, ps


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
        state, train[patch], ps = timed_steps(torch, failures, state, step, (vox, img, pose),
                                              TRAIN_STEPS, step_launches(b, patch),
                                              f"patch {patch} steps", "train",
                                              {"patch": patch, "batch": b, "dtype": "bfloat16"})
        per_step["train" if patch == 128 else "train64"] = ps
    out["train"] = train
    # extra modes at patch 128, each timed as the train lines; a profile of
    # one WGRAD=True step
    extra = {}
    for mode, wgrad, remat in (("wgrad_bf16", True, False), ("wgrad_fp32", "fp32", False),
                               ("remat", False, True)):
        cuda_winograd.WGRAD = wgrad
        step = make_shader_train_step(ShaderConfig(preact_policy=True, remat=remat), cfg, tx, 128)
        state, extra[mode], ps = timed_steps(
            torch, failures, state, step, (vox, img, pose), EXTRA_STEPS,
            step_launches(b, 128, wgrad=bool(wgrad), remat=remat), f"{mode} steps",
            f"extra {mode}", {"mode": mode, "patch": 128, "batch": b, "dtype": "bfloat16"})
        if wgrad:
            per_step[mode] = ps
        if wgrad is True:
            holder = [state]

            def one_wgrad_step():
                holder[0], _ = step(holder[0], vox, img, pose, 1)

            out["profile_wgrad_bf16"] = profile_run(torch, one_wgrad_step, run="wgrad_bf16")
            state = holder[0]
    cuda_winograd.WGRAD = False
    v_bytes = {str((b, s, s, c)): cuda_winograd.v_scratch_bytes((b, s, s, c), torch.bfloat16)
               for s in (64, 32) for c in (1024, 512)}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    k6_bytes = {m: {str((b, 64, 64, c)): cuda_winograd.wgrad_scratch_bytes(
        (b, 64, 64, c), c, torch.bfloat16, m == "wgrad_fp32", n_sm) for c in (1024, 512)}
        for m in ("wgrad_bf16", "wgrad_fp32")}
    log("train_memory " + json.dumps({"k3_v_scratch_bytes_per_call": v_bytes,
                                      "k6_scratch_bytes_per_call": k6_bytes,
                                      "peak_mem_gib": {**{p: train[p]["peak_mem_gib"]
                                                          for p in train},
                                                       **{m: extra[m]["peak_mem_gib"]
                                                          for m in extra}}}))
    out["extra_modes"] = extra

    step = make_shader_train_step(mcfg, cfg, tx, 128)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], vox, img, pose, 1)

    out["profile"] = profile_run(torch, one_step)
    return out, per_step


# ---------------------------------------------------------------------------
# phase 5: inverse rendering
# ---------------------------------------------------------------------------
# One recon step's latent gradients with kernels vs with their plain
# versions, per latent group: ||g - g_plain|| / ||g_plain||, under cuDNN's
# deterministic algorithms (its default fp32 ones are not, and these
# gradients magnify that from run to run). K1 and K4 are bit-identical
# to their plain versions, so the difference is K2's summation order (in
# bf16 also the roundings that follow), carried back through the frozen
# renderer. With the seeded weights the deep relu stacks make the vector
# and texture gradients chaotic: the seeded readings (printed, not gated)
# are ~5e-3 (fp32) and ~0.5 (bf16), in bf16 about as far as a planted K4
# fault. So the gated check runs on the seeded model with each res block's
# second conv scaled by RECON_RES_SCALE (half the residual branch's gain,
# which damps the relu-mask flips) and the normal head's output bias set to
# RECON_NORMAL_BIAS, which keeps Phong's normalisation away from normals
# near 0 (the head's output - 0.5).
# Pose and light are held to the training check's limits (GRAD_TOL). The
# vector and texture gradients are the decoders' residues of sums that
# cancel over the 64^3 grids; their limits sit between the readings on an
# H100 (3.7e-3 / 2.6e-3 fp32, 0.22 / 0.14 bf16) and the controls'. Controls
# (each must fail the gate): K4's gp zeroed (pose 1.0), K4's gv halved on
# each warp's last pass (vector and texture 0.5, pose 0.36), and the
# all-plain bf16 step's gradients held as fp32 ones (vector 0.23, pose
# 1.5e-2).
RECON_GRAD_TOL = {
    "float32": {"vector": 1e-2, "pose": GRAD_TOL["float32"], "texture": 1e-2,
                "light": GRAD_TOL["float32"]},
    "bfloat16": {"vector": 0.35, "pose": GRAD_TOL["bfloat16"], "texture": 0.35,
                 "light": GRAD_TOL["bfloat16"]},
}
RECON_RES_SCALE = 0.5
RECON_NORMAL_BIAS = (1.5, -1.0, 2.0)
RECON_STEPS = 5
# The light's elevation as the reconstruct CLI derives it from the
# reference config's target_elevation_light = 105 degrees: at
# ReconConfig()'s default 0 the light sits at the zenith and its azimuth
# has no gradient. Every other ReconConfig field keeps its default.
RECON_LIGHT_ELEVATION = (90 - 105) * math.pi / 180.0


def recon_launches(forward_only: bool = False, conv2d: bool = False):
    """Launches per inverse-rendering step (or per forward) that the graph
    implies at ``ReconConfig()``: each warp is 8 K1 passes at [BC, 16384,
    128] (the shape at BC = 5, the 4-channel texture at BC = 20) and their
    8 K4 adjoints (five 3-tap shear passes, three 6-tap scale passes, the
    first merged with a shear); e_conv3, the 20 res1 convs and res1_skip
    run K2 at 16 -> 16 channels forward and again for their data gradients;
    the networks are frozen, so no weight gradient runs (K2w 0), and batch 5
    is outside K3's envelope (K3, K6 0). With ``conv2d`` (phase 6) the relu
    stacks at [64, 64, 5, 512 / 256] take the fused route (k5_launches;
    K5w 0)."""
    n = 128
    k4 = {}
    for bc in (5, 20):
        k4[(bc, n * n, n, n, 3)] = 5
        k4[(bc, n * n, n, n, 6)] = 3
    k5 = k5_launches(5, 64, (512, 256), (10, 5), act="relu", grad=not forward_only,
                     wgrad=False)[0] if conv2d else {}
    return {
        "K1": {(5, n * n, n, n): 8, (20, n * n, n, n): 8},
        "K4": {} if forward_only else k4,
        "K2": {(XR, 16): 22 if forward_only else 44},
        "K2w": {}, "K3": {}, "K6": {}, "K5": k5, "K5w": {},
    }


def timed_recon_steps(torch, failures, model, target, per_step, tag, conv2d=False):
    """Per dtype, a warm-up and RECON_STEPS timed make_recon_steps on
    ``target``, their launches checked (runs ``{tag}32`` / ``{tag}16`` in
    ``per_step``), losses and latents finite. Returns {dtype: result}."""
    from rendernet_tpu_torch.recon.inverse import ReconConfig, initial_latents, make_recon_step

    steps = {}
    for dname, bits in (("float32", "32"), ("bfloat16", "16")):
        cfg = ReconConfig(compute_dtype=dname, light_elevation=RECON_LIGHT_ELEVATION)
        step = make_recon_step(model, cfg)
        lat = initial_latents(cfg, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        lat, _ = step(lat, target)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        losses = []
        for _ in range(RECON_STEPS):
            lat, per = step(lat, target)
            losses.append(per)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        totals, by_shape = read_counts()
        per_step[tag + bits] = check_step_counts(failures, f"{tag} {dname} steps", by_shape,
                                                 RECON_STEPS, recon_launches(conv2d=conv2d))
        sums = [float(x.sum()) for x in losses]
        res = {"dtype": dname, "batch": 5, "steps": RECON_STEPS,
               "ms_per_step": dt / RECON_STEPS * 1e3, "loss_sums": sums,
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "launches_per_step": {k: v // RECON_STEPS for k, v in totals.items()}}
        steps[dname] = res
        log(f"{tag} " + json.dumps(res))
        if not all(math.isfinite(x) for x in sums) or not all(
                bool(torch.isfinite(t).all()) for t in lat):
            failures.append(f"{tag} {dname}: non-finite loss {sums} or latents")
    return steps


def recon_model(torch):
    from rendernet_tpu_torch.models.decoders import (
        init_recon_rendernet_params,
        init_recon_texture_decoder_params,
        init_shape_decoder_params,
    )
    from rendernet_tpu_torch.recon.inverse import ReconModel

    model = ReconModel(init_shape_decoder_params(0, device="cuda"),
                       init_recon_texture_decoder_params(1, device="cuda"),
                       init_recon_rendernet_params(2, device="cuda"))
    for net in model:  # frozen, as make_recon_step leaves them
        net.requires_grad_(False)
    return model


def conditioned_recon_model(torch):
    """The seeded model with each res block's second conv scaled by
    RECON_RES_SCALE and the normal head's output bias set to
    RECON_NORMAL_BIAS (the gradient check's model)."""
    model = recon_model(torch)
    with torch.no_grad():
        for name, p in model.renderer.named_parameters():
            if name.endswith("conv2_3x3.weight"):
                p.mul_(RECON_RES_SCALE)
        head = model.renderer.encoder["Normal"]["e_conv11"]["e_conv11_2"]
        head.bias.copy_(torch.tensor(RECON_NORMAL_BIAS))
    return model


class k4_fault:
    """A fault planted in K4's results, which the gradient check must
    reject: "gp0" zeroes every pass's position cotangent; "gv_half" halves
    the voxel cotangent of each warp's last pass (the first adjoint of
    each batch-channel count)."""

    def __init__(self, kind: str):
        self.kind = kind

    def __enter__(self):
        from rendernet_tpu_torch.ops import cuda_resample

        self.orig = orig = cuda_resample.interp_pass_bwd
        seen = set()

        def faulty(vol, params, g, db, taps, out_lanes=None):
            gv, gp = orig(vol, params, g, db, taps, out_lanes)
            if self.kind == "gp0":
                gp = gp * 0.0
            elif vol.shape[0] not in seen:
                seen.add(vol.shape[0])
                gv = gv * 0.5
            return gv, gp

        cuda_resample.interp_pass_bwd = faulty

    def __exit__(self, *exc):
        from rendernet_tpu_torch.ops import cuda_resample

        cuda_resample.interp_pass_bwd = self.orig


def recon_gradient_check(torch, failures, seeded, seeded_target, conv2d=False,
                         tag="recon_grad"):
    """One step's latent gradients at ReconConfig(), kernels vs all plain,
    fp32 (TF32 off) and bf16, under cuDNN's deterministic algorithms: on
    the conditioned model, gated by RECON_GRAD_TOL with three controls
    that must fail it; on the seeded model, printed only."""
    from rendernet_tpu_torch.recon.inverse import (
        Latents,
        ReconConfig,
        initial_latents,
        recon_per_sample_loss,
    )

    def errors(g, ref):
        return {n: float((a.float() - b.float()).norm() / b.float().norm())
                for n, a, b in zip(Latents._fields, g, ref)}

    def over(errs, dname):
        return [n for n, e in errs.items() if not e <= RECON_GRAD_TOL[dname][n]]

    model = conditioned_recon_model(torch)
    target = render_target(torch, model)[0].expand(5, -1, -1, -1).contiguous()
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out, plain = {}, {}
    for dname in ("float32", "bfloat16"):
        cfg = ReconConfig(compute_dtype=dname, light_elevation=RECON_LIGHT_ELEVATION)
        lat = initial_latents(cfg, device="cuda")

        def grads(net=model, tgt=target):
            leaves = [t.clone().requires_grad_() for t in lat]
            loss = recon_per_sample_loss(net, Latents(*leaves), tgt, cfg)
            return loss.detach(), torch.autograd.grad(loss.sum(), leaves)

        what = f"{tag} {dname} gradient check"
        reset_counts()
        loss, g = grads()
        torch.cuda.synchronize()
        check_step_counts(failures, what, read_counts()[1], 1, recon_launches(conv2d=conv2d))
        with plain_kernels():
            reset_counts()
            loss_p, gp = grads()
            if any(read_counts()[0].values()):
                failures.append(f"{what}: the plain step launched a kernel")
            _, g_seeded_plain = grads(seeded, seeded_target)
        _, g_seeded = grads(seeded, seeded_target)
        plain[dname] = gp
        for name, a, b in zip(Latents._fields, g, gp):
            ref = float(b.norm())
            if not (ref > 0 and math.isfinite(ref)) or not bool(torch.isfinite(a).all()):
                failures.append(f"{what}: gradient of {name}: plain norm {ref}, or non-finite")
        errs = errors(g, gp)
        bad = over(errs, dname)
        if bad:
            failures.append(f"{what}: {bad} differ from the all-plain step's by "
                            f"{errs} (limits {RECON_GRAD_TOL[dname]})")
        controls = {}
        for kind in ("gp0", "gv_half"):
            with k4_fault(kind):
                controls[f"k4_{kind}"] = errors(grads()[1], gp)
        for name, c in controls.items():
            if not over(c, dname):
                failures.append(f"{what}: the control {name} passed the gate ({c})")
        res = {"dtype": dname, "rel_err": errs, "tol": RECON_GRAD_TOL[dname],
               "controls": controls, "seeded_rel_err": errors(g_seeded, g_seeded_plain),
               "loss": loss.tolist(), "plain_loss": loss_p.tolist(),
               "grad_norm": {n: float(b.norm()) for n, b in zip(Latents._fields, gp)}}
        out[dname] = res
        log(f"{tag} " + json.dumps(res))
    cross = errors(plain["bfloat16"], plain["float32"])
    out["control_bf16_as_fp32"] = cross
    log(f"{tag}_control " + json.dumps({"bf16_plain_vs_fp32_plain": cross}))
    if not over(cross, "float32"):
        failures.append(f"{tag} check: the bf16 step passed the fp32 gate ({cross})")
    torch.backends.cudnn.deterministic = cudnn_det
    return out


def render_target(torch, model):
    """(composite, albedo, normal) of one render by ``model`` at a known
    pose (azimuth 250, elevation 10 degrees) from seed-1 latents."""
    from rendernet_tpu_torch.recon.inverse import ReconConfig, initial_latents, recon_forward

    cfg = ReconConfig(batch_size=1, light_elevation=RECON_LIGHT_ELEVATION)
    lat = initial_latents(cfg, seed=1, device="cuda")
    lat = lat._replace(pose=torch.tensor([[250 * math.pi / 180, 10 * math.pi / 180, 1.0]],
                                         device="cuda"))
    with torch.no_grad():
        compos, albedo, normal, _ = recon_forward(model, lat, cfg)
    return compos, albedo, normal


def write_recon_targets(torch, model, tmp):
    """Albedo and normal PNGs of :func:`render_target` (the CLI's
    targets), and its composite for 5 hypotheses."""
    from rendernet_tpu_torch.utils.image import save_image, to_uint8

    compos, albedo, normal = render_target(torch, model)
    paths = []
    for name, img in (("albedo", albedo), ("normal", normal)):
        paths.append(os.path.join(tmp, f"target_{name}.png"))
        save_image(to_uint8(img[0].float().cpu().numpy(), 255.0), paths[-1])
    return paths, compos.expand(5, -1, -1, -1).contiguous()


def run_recon(torch, failures, tmp):
    """Phase 5: the gradient check, the timed steps, the CLI, a profile."""
    import numpy as np

    from rendernet_tpu_torch.cli.__main__ import main as cli_main
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.recon.inverse import ReconConfig, initial_latents, make_recon_step

    layers.WINOGRAD_2D = False  # as JAX's recon (batch 5 is outside K3's envelope anyway)
    gc.collect()  # the earlier phases' objects: the host dispatches every op of a step
    torch.cuda.empty_cache()
    out, per_step = {}, {}
    model = recon_model(torch)
    (albedo, normal), rendered = write_recon_targets(torch, model, tmp)
    out["gradient_check"] = recon_gradient_check(torch, failures, model, rendered)
    del rendered
    # the timed steps' target: a fixed random image, as benchmarks/recon_bench.py's
    gen = torch.Generator(device="cuda").manual_seed(11)
    target = torch.rand(5, 512, 512, 3, generator=gen, device="cuda")

    out["steps"] = timed_recon_steps(torch, failures, model, target, per_step, "recon")

    # the CLI, as a user runs it: bf16 on the card, 2 epochs of 4 steps, a
    # dump every 2 steps (one mid-epoch and one end-of-epoch forward each)
    run_dir = os.path.join(tmp, "recon")
    cfg_path = os.path.join(tmp, "recon.json")
    with open(cfg_path, "w") as f:
        json.dump({"batch_size": 5, "inner_step": 4, "max_epochs": 2, "new_size": 128,
                   "img_res": 512, "sample_save": run_dir, "target_albedo": albedo,
                   "target_normal": normal}, f)
    reset_counts()
    t0 = time.perf_counter()
    rc = cli_main(["reconstruct", cfg_path, "--random-weights", "--dump-every", "2"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    totals, by_shape = read_counts()
    want = recon_launches()
    fwd = recon_launches(forward_only=True)
    for kid in want:  # 8 steps and 4 dump forwards
        want[kid] = {k: 8 * want[kid].get(k, 0) + 4 * fwd[kid].get(k, 0)
                     for k in set(want[kid]) | set(fwd[kid])}
    check_step_counts(failures, "reconstruct CLI", by_shape, 1, want)
    names = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []
    hist = os.path.join(run_dir, "loss_history.npz")
    finite = False
    if os.path.exists(hist):
        with np.load(hist) as h:
            finite = (h["curves"].shape == (2, 4, 5) and bool(np.isfinite(h["curves"]).all())
                      and bool(np.isfinite(h["final"]).all()))
            final = h["final"].tolist()
    expected = {"shaded_target.png", "metrics.jsonl", "loss_history.npz",
                "epoch0_step2.png", "epoch0_step2.binvox", "epoch1_step2.png",
                "epoch1_step2.binvox"}
    ends = [n for n in names if n.startswith("epoch") and "_p" in n]
    out["cli"] = {"rc": rc, "s": cli_s, "files": len(names), "epoch_dumps": ends,
                  "final_losses": final if finite else None, "launches": totals}
    log("recon_cli " + json.dumps(out["cli"]))
    if rc != 0 or not expected <= set(names) or len(ends) != 4 or not finite:
        failures.append(f"reconstruct CLI: rc {rc}, files {names}, finite losses {finite}")

    cfg = ReconConfig(compute_dtype="bfloat16", light_elevation=RECON_LIGHT_ELEVATION)
    step = make_recon_step(model, cfg)
    holder = [initial_latents(cfg, device="cuda")]

    def one_step():
        holder[0], _ = step(holder[0], target)

    out["profile"] = profile_run(torch, one_step, top=25)
    return out, per_step


# ---------------------------------------------------------------------------
# phase 6: the fused wide-conv route (CUDA_CONV2D) on every path
# ---------------------------------------------------------------------------
def serve_launches2d():
    """Launches per batch-8 forward with CUDA_CONV2D and WINOGRAD_2D on: K1
    and K2 as phase 3's, the 32 wide convs on the fused route, no K3."""
    k5, _ = k5_launches(8, 64, (1024, 512), (10, 5), grad=False)
    return {"K1": {(8, 16384, 128, 128): 8},
            "K2": {((8, 64, 64, 32, 16), 32): 1, (X3[8], 32): 21},
            "K3": {}, "K4": {}, "K2w": {}, "K6": {}, "K5": k5, "K5w": {}}


def conv2d_serving(torch, np, failures, per_step):
    """(b) One forward per dtype at batch 8 (bf16 first, the serving
    form), its launches, its logits against the all-plain forward's
    (phase 3's limits), and its time."""
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward

    net = init_shader_params(0, ShaderConfig(), device="cuda")
    rng = np.random.default_rng(0)
    vox = torch.from_numpy(np.repeat(
        procedural_voxel().astype(np.float32)[None, :, :, :, None], 8, axis=0)).cuda()
    pose = torch.from_numpy(np.stack(
        [rng.uniform(0, 6.28, 8), rng.uniform(-1, 1, 8), np.ones(8)], axis=1
    ).astype(np.float32)).cuda()
    logits = []
    hook = net.encoder["e_conv11"].register_forward_hook(
        lambda mod, args, y: logits.append(y.float()))
    out = {}
    with torch.no_grad():
        for dtype, run in ((torch.bfloat16, "serve2d16"), (torch.float32, "serve2d32")):
            dname = str(dtype).split(".")[-1]
            fwd = lambda: shader_forward(net, vox, pose, compute_dtype=dtype,  # noqa: E731
                                         resample="multipass")
            logits.clear()
            reset_counts()
            img = fwd()
            torch.cuda.synchronize()
            totals, by_shape = read_counts()
            per_step[run] = check_step_counts(failures, f"serve2d {dname} forward", by_shape, 1,
                                              serve_launches2d())
            got = logits.pop()
            with plain_kernels():
                reset_counts()
                ref_img = fwd().float()
                ref = logits.pop()
                if any(read_counts()[0].values()):
                    failures.append(f"serve2d {dname}: the plain forward launched a kernel")
            spread = float(ref_img.max() - ref_img.min())
            logit_spread = float(ref.max() - ref.min())
            err = float((got - ref).abs().max())
            res = {"dtype": dname, "launches": totals, "logit_max_abs_err": err,
                   "logit_spread": logit_spread, "rel_err": err / logit_spread,
                   "output_spread": spread, "tol": FORWARD_TOL[dname]}
            if tuple(img.shape) != (8, 512, 512, 1) or not bool(torch.isfinite(img).all()):
                failures.append(f"serve2d {dname}: shape {tuple(img.shape)} or non-finite values")
            if not err <= FORWARD_TOL[dname] * logit_spread:
                failures.append(f"serve2d {dname} forward's logits differ from the plain "
                                f"forward's by {err:.3e} of spread {logit_spread:.3e}")
            if not spread >= MIN_SPREAD:
                failures.append(f"serve2d {dname} plain forward's output spreads only {spread:.3e}")
            logits.clear()
            res["forward_ms"] = time_ms(torch, fwd, 3)
            logits.clear()
            out[dname] = res
            log("serve2d " + json.dumps(res))
    hook.remove()
    return out


def conv2d_training(torch, np, failures, per_step):
    """(c) The gradient check at batch 8 (patch 128, fp32 and bf16),
    bench.py's configuration at batch 24 (patch 128 and 64: a warm-up and
    TRAIN_STEPS timed steps each), one step with PRELU_SAVE_PRE off and one
    with remat, and (e) a profiled bf16 patch-128 step."""
    from rendernet_tpu_torch.models.shader import ShaderConfig
    from rendernet_tpu_torch.ops import cuda_conv2d
    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.train.steps import create_shader_state, make_shader_train_step

    out = {}
    g = gradient_check(torch, np, failures, patches=(128,), conv2d=True, tag="grad2d")
    out["gradient_check"] = [v["result"] for v in g.values()]
    per_step["grad2d32"] = g["float32", 128]["per_step"]
    del g
    b = 24
    cfg = TrainConfig(batch_size=b, img_res=512, new_size=128, compute_dtype="bfloat16",
                      is_greyscale=True, e_eta=1e-5, moment_dtype="bfloat16")
    mcfg = ShaderConfig(preact_policy=True)
    batch = bench_batch(torch, np, b)
    state, tx = create_shader_state(0, mcfg, cfg, device="cuda")
    train = {}
    for patch, run in ((128, "train2d"), (64, "train2d64")):
        step = make_shader_train_step(mcfg, cfg, tx, patch)
        state, train[patch], per_step[run] = timed_steps(
            torch, failures, state, step, batch, TRAIN_STEPS,
            step_launches(b, patch, conv2d=True), f"train2d patch {patch} steps", "train2d",
            {"patch": patch, "batch": b, "dtype": "bfloat16"})
    out["train"] = train
    extra = {}
    for mode, save_pre, remat in (("nosave2d", False, False), ("remat2d", True, True)):
        cuda_conv2d.PRELU_SAVE_PRE = save_pre
        step = make_shader_train_step(ShaderConfig(preact_policy=True, remat=remat), cfg, tx, 128)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        state, loss = step(state, *batch, 1)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        totals, by_shape = read_counts()
        ps = check_step_counts(failures, f"{mode} step", by_shape, 1,
                               step_launches(b, 128, remat=remat, conv2d=True, save_pre=save_pre))
        if mode == "nosave2d":
            per_step[mode] = ps
        extra[mode] = {"ms": dt * 1e3, "loss": float(loss), "launches": totals,
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        log(f"extra {mode} " + json.dumps(extra[mode]))
        if not math.isfinite(float(loss)):
            failures.append(f"{mode} step: non-finite loss")
    cuda_conv2d.PRELU_SAVE_PRE = True
    out["extra_modes"] = extra
    step = make_shader_train_step(mcfg, cfg, tx, 128)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *batch, 1)

    out["profile"] = profile_run(torch, one_step)
    return out


def conv2d_recon(torch, failures, per_step):
    """(d) The latent-gradient check (phase 5's limits and controls on the
    conditioned model) and, per dtype, a warm-up and RECON_STEPS timed
    make_recon_steps, their launches checked."""
    model = recon_model(torch)
    rendered = render_target(torch, model)[0].expand(5, -1, -1, -1).contiguous()
    out = {"gradient_check": recon_gradient_check(torch, failures, model, rendered,
                                                  conv2d=True, tag="recon2d_grad")}
    del rendered
    gen = torch.Generator(device="cuda").manual_seed(11)
    target = torch.rand(5, 512, 512, 3, generator=gen, device="cuda")
    out.update(timed_recon_steps(torch, failures, model, target, per_step, "recon2d",
                                 conv2d=True))
    return out


def run_conv2d(torch, failures, per_step):
    """Phase 6: serving, training and inverse rendering with CUDA_CONV2D
    (and WINOGRAD_2D, which it takes precedence over) on."""
    import numpy as np

    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.ops import cuda_conv2d

    gc.collect()
    torch.cuda.empty_cache()
    layers.CUDA_CONV2D, layers.WINOGRAD_2D = True, True
    out = {}
    try:
        for name, run in (("serving", lambda: conv2d_serving(torch, np, failures, per_step)),
                          ("training", lambda: conv2d_training(torch, np, failures, per_step)),
                          ("recon", lambda: conv2d_recon(torch, failures, per_step))):
            t0 = time.perf_counter()
            out[name] = run()
            gc.collect()
            torch.cuda.empty_cache()
            log(f"phase 6 {name} took {time.perf_counter() - t0:.1f} s")
    finally:
        layers.CUDA_CONV2D, layers.WINOGRAD_2D = False, False
        cuda_conv2d.PRELU_SAVE_PRE = True
    return out


# Device kernels of each kernel id in a profile, by substrings of their
# (demangled) names.
PROFILED = {"K1": ("k1_pass",), "K4": ("k4_adjoint",),
            "K2": ("conv3d_mma_kernel", "conv3d_core_kernel"), "K2w": ("conv3d_wgrad_",),
            "K3": ("k3_",), "K6": ("k6_",), "K5": ("conv2d_wgmma_kernel", "conv2d_f32_kernel"),
            "K5w": ("wgrad_wgmma_kernel", "::wgrad_f32_kernel", "::wgrad_reduce_kernel")}


def _profile(torch, fn):
    """(device kernels as (name, calls, us), wall us) over one call of
    ``fn`` after a warm-up call (torch.profiler)."""
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
    return rows, wall_us


def _part(rows, names, busy_us):
    mine = [r for r in rows if any(n in r[0] for n in names)]
    us = sum(r[2] for r in mine)
    return {"ms": us / 1e3, "kernels": sum(r[1] for r in mine),
            "busy_share": us / busy_us if busy_us else None}


def profile_run(torch, fn, top: int = 12, run: str | None = None):
    """Device time by kernel name over one call of ``fn``, the device's
    busy share of its wall time, and the device time and share of the busy
    time of each kernel in PROFILED; ``run`` names the run in the printed
    line."""
    rows, wall_us = _profile(torch, fn)
    busy_us = sum(r[2] for r in rows)
    res = {"run": run, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us if wall_us else None,
           "top": [{"kernel": k[:90], "count": c, "ms": us / 1e3} for k, c, us in rows[:top]]}
    for kid, names in PROFILED.items():
        res[kid] = _part(rows, names, busy_us)
    log("profile " + json.dumps(res))
    return res


# The resample warp's device time by part, by substrings of kernel names
# (lower case), first match wins: K1 and K4; the copies around them (the
# transposes and reshapes between passes, _qturn_swap's torch.where, the
# wrappers' .contiguous(), the input's pad and channel move); the matmuls
# (pass_param_grad's two contractions, and the plan's 4x4 products and
# solve); the reductions (pass_param_grad's sum; the plan's); the rest
# (the plan's elementwise ops and its small solve).
WARP_PARTS = (("K1", ("k1_pass",)), ("K4", ("k4_adjoint",)),
              ("copies", ("copy", "where", "pad", "cat")),
              ("matmuls", ("gemm", "gemv", "xmma", "cutlass", "splitk")),
              ("reductions", ("reduce",)))


def warp_profile(torch, run: str, fn) -> dict:
    """One profiled call of a resample warp: busy and wall time, and the
    device time of each WARP_PARTS part and of the rest."""
    rows, wall_us = _profile(torch, fn)
    busy_us = sum(r[2] for r in rows)
    res = {"run": run, "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us if wall_us else None}
    left = rows
    for part, names in WARP_PARTS:
        mine = [r for r in left if any(n in r[0].lower() for n in names)]
        left = [r for r in left if r not in mine]
        res[part] = _part(mine, ("",), busy_us)
    res["other"] = _part(left, ("",), busy_us)
    res["top"] = [{"kernel": k[:90], "count": c, "ms": us / 1e3} for k, c, us in rows[:10]]
    log("warp_profile " + json.dumps(res))
    return res


def warp_profiles(torch) -> list:
    """The resample warp alone, bf16, as the main paths run it: serving's
    batch-8 forward (bench_batch's voxels and poses, no gradient), and
    recon's two warps, the shape grid [5, 64^3, 1] and the texture grid
    [5, 64^3, 4], forward and backward at the first hypotheses' poses
    (ReconConfig's initial latents)."""
    import numpy as np

    from rendernet_tpu_torch.ops.cuda_resample import rotate_resample_to_camera_multipass
    from rendernet_tpu_torch.recon.inverse import ReconConfig, initial_latents

    bf16 = torch.bfloat16
    vox, _, pose = bench_batch(torch, np, 8)

    def serve():
        with torch.no_grad():
            rotate_resample_to_camera_multipass(vox, pose, new_size=128, compute_dtype=bf16)

    out = [warp_profile(torch, "serve bf16 batch 8, forward", serve)]
    del vox, pose
    cfg = ReconConfig(compute_dtype="bfloat16", light_elevation=RECON_LIGHT_ELEVATION)
    rpose = initial_latents(cfg, device="cuda").pose
    gen = torch.Generator(device="cuda").manual_seed(13)
    grids = [torch.rand(5, 64, 64, 64, c, generator=gen, device="cuda") for c in (1, 4)]
    cots = [torch.randn(5, 128, 128, 128, c, generator=gen, device="cuda").to(bf16)
            for c in (1, 4)]

    def recon():
        p = rpose.detach().requires_grad_()
        leaves = [g.detach().requires_grad_() for g in grids]
        outs = [rotate_resample_to_camera_multipass(g, p, new_size=128, compute_dtype=bf16)
                for g in leaves]
        torch.autograd.grad(outs, [p, *leaves], cots)

    out.append(warp_profile(torch, "recon bf16 [5|20,16384,128], forward + backward", recon))
    return out


class plain_kernels:
    """Route every kernel wrapper to its plain version (on the card)."""

    def __enter__(self):
        from rendernet_tpu_torch.ops import cuda_conv2d, cuda_conv3d, cuda_resample, cuda_winograd

        swaps = [(cuda_conv2d, "conv2d_hwnc", cuda_conv2d.conv2d_hwnc_plain),
                 (cuda_conv2d, "conv2d_wgrad", cuda_conv2d.conv2d_wgrad_plain),
                 (cuda_resample, "interp_pass_fwd", cuda_resample.interp_pass_plain),
                 (cuda_resample, "interp_pass_bwd", cuda_resample.interp_pass_bwd_plain),
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


# Tensor-core instructions each library must hold (any one of them): K3's,
# K6's, K5's and K5w's GEMMs are wgmma (HGMMA); K2's and K2w's bf16 kernels
# are mma.sync (HMMA). SASS_TMA: the libraries whose wgmma is fed by TMA
# (UTMALDG) and must show it.
SASS_NEEDS = {"winograd": ("HGMMA",), "winograd_wgrad": ("HGMMA",),
              "conv3d": ("HMMA", "HGMMA"), "conv3d_wgrad": ("HMMA", "HGMMA"),
              "conv2d": ("HGMMA",), "conv2d_wgrad": ("HGMMA",)}
SASS_TMA = ("winograd", "winograd_wgrad", "conv2d", "conv2d_wgrad")
# Libraries whose kernels move tiles with 1-D bulk copies (UBLKCP): K1, K4.
SASS_BULK = ("resample", "resample_bwd")
# Libraries whose ptxas report must not say that it serializes their
# tensor-core code ("Potential Performance Loss": C7515 / C7518 and kin).
NO_SERIALIZATION = ("winograd_wgrad", "conv3d", "conv3d_wgrad", "conv2d", "conv2d_wgrad")


def kernel_sass(failures) -> None:
    """Counts the tensor-core (HMMA, HGMMA), TMA load (UTMALDG) and bulk
    copy (UBLKCP) instructions in the SASS of the libraries of SASS_NEEDS
    and SASS_BULK: each of SASS_NEEDS must issue one of its names, those of
    SASS_TMA a TMA load, those of SASS_BULK (K1's, K4's) a bulk copy.
    Skipped, and said so, where the toolkit has no cuobjdump."""
    from rendernet_tpu_torch.ops import _native

    tool = os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        log("sass not inspected: no cuobjdump beside nvcc")
        return
    for name in (*SASS_NEEDS, *SASS_BULK):
        sass = subprocess.run([tool, "-sass", str(_native._target(name))],
                              capture_output=True, text=True).stdout
        counts = {op: sass.count(op) for op in ("HMMA", "HGMMA", "UTMALDG", "UBLKCP")}
        log(f"sass [{name}] {json.dumps(counts)}")
        needs = SASS_NEEDS.get(name, ())
        if needs and not any(counts[op] for op in needs):
            failures.append(f"{name}'s library issues no tensor-core instruction ({needs})")
        if name in SASS_TMA and not counts["UTMALDG"]:
            failures.append(f"{name}'s library issues no TMA load (UTMALDG)")
        if name in SASS_BULK and not counts["UBLKCP"]:
            failures.append(f"{name}'s library issues no bulk copy (UBLKCP)")


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
    failures: list = []
    for name, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "Performance Loss" in line):  # ptxas serializing wgmma, say
                log(f"  [{name}] {line.strip()}")
            if "Performance Loss" in line and name in NO_SERIALIZATION:
                failures.append(f"ptxas serializes tensor-core code in {name}: {line.strip()}")
    kernel_sass(failures)
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
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        main_out["recon"], recon_per_step = run_recon(torch, failures, tmp)
    per_step.update(recon_per_step)
    main_out["recon"]["warp_profiles"] = warp_profiles(torch)
    log(f"phase 5 (inverse rendering) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_out["conv2d"] = run_conv2d(torch, failures, per_step)
    log(f"phase 6 (the fused wide-conv route) took {time.perf_counter() - t0:.1f} s")

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
        path = f" ({r['path']} path)" if r.get("path") else ""
        kernels.append({
            "name": f"{kid} {label} {dname}{path}", "route": "cuda",
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
