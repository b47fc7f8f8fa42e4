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
     the positions; the device kernels of cuDNN's fp32 K5w call at res2 by
     name), then the fp32 K5 / K5w and K2w at several accumulator chain
     lengths (``chains``: error and ms), then the fused Adam update (no TPU
     kernel) at the shader's and texface's parameter sets (``adam``
     lines: bit-equal to its plain version, its ms, the plain version's
     and ``torch.optim.Adam(fused=True)``'s, and its SASS: 128-bit loads,
     no local memory; every training step below is checked for one Adam
     launch, and the kernels line takes its launches from the patch-64
     train runs of phases 4 and 7);
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
     by parameter, and a profile of the fp32 patch-128 step whose K2w
     kernels must include ``conv3d_wgrad_tf32_kernel`` (phase 6's flag-on
     check likewise); (b) ``bench.py``'s two
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
  7. the texture/face path at ``TextureFaceConfig()`` (tex_base 32, enc
     8/16/16, res 10/10/5, base 32, new_size 128; multipass; the 2D stacks
     on K3): phase 2 holds every kernel at the texture shapes (K2 / K2w at
     16 -> 16 channels, K3 at 512 and 256, K6 at both, K1 / K4 at BC = 4B,
     K5 / K5w at 512 and 256 with the flag); (a) one bf16
     ``texture_face_forward`` at batch 8, both heads' logits against the
     all-plain forward's, timed; (b) one texture step's gradients
     (``texture_loss``, batch 8, patch 128) in fp32 (TF32 off) and bf16
     against the all-plain step's: the trunk and heads per parameter by
     max (TEX_GRAD_TOL), the texture decoder by norm (TEX_DECODER_TOL),
     with a control that halves K4's voxel cotangent and must fail, and a
     profile of the fp32 step whose K2w kernels must include its TF32
     kernel (``conv3d_wgrad_tf32_kernel``, by name); (c, d)
     five timed bf16 steps at batch 24 per patch (128, 64), one step with
     ``WGRAD=True``, one with ``CUDA_CONV2D``, a profiled patch-128 step;
  8. the training CLIs on the card: ``make_synthetic_shader_tar`` renders
     3 procedural models from 8 poses at img_res 512, ``pack-tar`` packs
     the PNGs, the loader alone is timed (images/s, which decoder ran),
     ``train-shader --max-steps 6`` runs a full-width bf16 multipass
     config at batch 8 whose curriculum crosses from patch 32 to 64, a
     second run resumes at step 6 and stops at 8 (params on the card,
     ``resumed_at_step`` 6 in ``metrics.jsonl``, every image decoded by
     the native decoder, K1 / K2 / K3 launches as ``step_launches`` for
     the patches taken), then ``train-texture --max-steps 2`` on a
     synthetic face dataset at img_res 512.
  9. the exact conv rewrites that JAX leaves to XLA (plain PyTorch, no
     kernel of their own) and the frozen artifact: (a) every conv and
     deconv of the shader, texture and recon networks at full width is
     recorded with its route (``routes`` lines; PHASE_CONV3D "all" and
     DEPTH_PACK on), and each phase-space conv (e_conv1 / e_conv2), K=4
     sub-pixel deconv and depth-packed conv is held against its plain form
     (output and both gradients, REWRITE_TOL) in bf16 at the training
     batch and fp32 at the gradient checks', both forms timed forward +
     backward (``rewrite`` lines); where K2 takes every conv the depth
     packing could (``depth_pack: route unreached``), the packing is timed
     at res1's shape against the plain conv and K2; (b) the PHASE_CONV3D
     A/B (off / True / "all", a warm-up and AB_STEPS steps each, median;
     ``ab`` and ``ab_phase`` lines) runs in phase 4 on the shader's
     patch-128 step and in phase 7 on the texture's, every arm's launches
     checked, and phase 7 profiles one texture step with a range around
     each conv and deconv outside the res blocks, forward and backward,
     naming its cuDNN dgrad calls by layer (``named_profile``); (c)
     ``freeze_shader_render`` of a seeded ``ShaderConfig()`` at batch 1
     (checked on the card), loaded in a fresh process that must
     import no model code, against the live exact fp32 forward
     (FROZEN_TOL), both timed; then the render CLI with ``--frozen`` and
     with the reference weight directory that ``convert npz-to-refdir``
     writes, each image against the flat-npz render's (``frozen`` line).
 10. data parallelism (``train/distributed.py``; the all-reduce is a
     library collective, no kernel of its own): (a) NCCL at world size 1
     (``tcp://127.0.0.1:<free port>``): bench.py's patch-128 configuration
     built with a mesh, 2 steps with the fp32 and with the bf16 all-reduce
     from the seeded state, against the step without a mesh (fp32: loss and
     params bit for bit; bf16: the loss equal, params within 2 e_eta after
     step 1; a data axis of 1 all-reduces nothing, as JAX's), the
     all-reduce alone on that step's gradients (NCCL, both dtypes: its ms,
     the gradient bytes, the result its input or its bf16 rounding), one
     texture step (``TextureFaceConfig()``, batch 24) with and without a
     mesh, bit for bit, and ``graft_entry.entry()``'s forward; (b) two
     ranks on the one card over gloo (spawned), 12 rows each, 2 steps per
     all-reduce dtype: the ranks' params bit-equal after each step, the
     all-reduced gradients of step 1 within GRAD_TOL (bf16) of (a)'s
     world-1 batch-24 step's, the params after it within 2 e_eta of it,
     each rank's launches as ``step_launches(12, 128)``; (c) ``train-shader``
     as two processes (``--coordinator 127.0.0.1:<port> --num-processes 2
     --process-id i``) on phase 8's tar at global batch 16 for its one
     epoch (2 steps): both exit 0, rank 0 alone writes (rank 1's run dir,
     named in its config, is never made), the ranks read disjoint tar
     entries covering the tar, and a third run (this process) resumes at
     step 2.
 11. spatial sharding (a model axis over the rows; the halo exchange is a
     library all-gather over each pair of neighbouring ranks, no kernel of
     its own), two gloo ranks sharing the card on a 1 x 2 mesh at
     ``ShaderConfig()`` full width, against the world-1 runs in this
     process: (a) one bf16 multipass ``shader_forward`` at batch 8
     (``--fast``), each rank on its rows of the raw grid, its logits
     gathered and held to phase 3's limit of the world-1 logits, timed,
     each rank's peak memory; (b) bench.py's patch-128 configuration at
     batch 8 on the gradient check's inputs: the loss (SP_LOSS_TOL) and
     the model-summed gradients (phase 4's bf16 limit) of step 1 against
     the world-1 step's, the ranks' params bit-equal after step 2, the
     step's ms, peak memory and halo bytes sent and received per rank;
     (c) the port's ``graft_entry.dryrun_multichip(4)`` (4 ranks: data
     parallel, then the dp + spatial forward and train step on a (2, 2)
     mesh); (d) two planted faults: the halo adjoint's add dropped, which
     (b)'s gradient check must reject, and the halo rows read as zeros
     in the forward, which (b)'s loss check must reject. Phase 2 holds K1, K2, K2w and K3 at the slabs' shapes
     (``SP_CASES``), whose launches are rank 0's per forward and per step.
 12. the texture step and inverse rendering under a model axis: two gloo
     ranks sharing the card on a 1 x 2 mesh, against the world-1 runs in
     this process: (a) ``TextureFaceConfig()`` bf16 multipass at batch 8:
     one ``texture_face_forward`` (each rank on its rows of the raw grid;
     both heads' logits gathered and held to phase 3's limit of the world-1
     logits), timed, its memory; one patch-128 texture step: the loss
     (SP_LOSS_TOL), the model-summed gradients by phase 7's limits (trunk
     and heads per parameter, the texture decoder by norm), the ranks'
     params bit-equal, ms, memory and halo bytes; a planted fault (the
     texture grid's cotangent also summed over the model axis) that the
     decoder's limit must reject; (b) ``ReconConfig()`` multipass on the
     conditioned model of phase 5 (cuDNN deterministic), fp32 and bf16:
     SP_RECON_STEPS steps on each rank's rows of the target, every step's
     per-sample losses (SP_LOSS_TOL) and step 1's model-summed latent
     gradients (phase 5's per-group limits) against world 1's, the ranks'
     latents bit-equal, ms, memory and halo bytes; a planted fault (the
     pose gradient left out of the model sum) that the pose limit must
     reject; one ``reconstruct`` epoch on the mesh must pick world 1's best
     hypothesis. Phase 2 holds K1, K4, K2, K2w and K3 at these slabs'
     shapes (``SP12_CASES``), whose launches are rank 0's per step.
The kernels' launch counters are zeroed just before each run of phases 3
to 8 and 10 to 12 (and of each A/B arm) and read just after; every run's counts are checked, shape by
shape, against the counts its graph implies. K1's and K4's phase 2 rows
name the path each launch took (``bulk`` or ``scalar``, from the
wrappers' path counters); K3's carry the bytes of its V scratch; the fp32
K2 and K3 rows are bound by three TF32 passes (495 TFLOP/s) and carry the
one-pass bound on the fp32 CUDA cores (67 TFLOP/s, ``cuda_core_bound_ms``)
beside it; the
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
the z-recompute row per step with PRELU_SAVE_PRE off); phase 7's rows count
the texture run named in the row (``tex`` rows per bf16 batch-24 step,
``texfwd`` per bf16 batch-8 forward, ``texgrad32`` per fp32 gradient-check
step, ``texwgrad`` / ``tex2d`` per step with WGRAD / the flag). The ragged shapes and the fp32
batch-24 checks are printed on ``ragged`` and ``check`` lines of their own.
The last line is ``{"ok": true, "device": {...}}``. Exits non-zero,
printing no result, when there is no CUDA card, when the port is missing,
or when any check fails.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

# Published H100 SXM peaks (dense): bf16 and TF32 tensor cores, fp32 CUDA
# cores, HBM3.
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
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
            "K5w": ("cuda_conv2d", "wgrad_"), "Adam": ("cuda_adam", "")}


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


# The ops whose fp32 form runs every product as three TF32 passes (K2 at
# C <= 32, every fp32 K2 case here; K2w; K3; K5 and its data gradient; K5w).
TF32_OPS = ("conv3d", "conv3d_dgrad", "conv3d_wgrad", "wino", "wino_dgrad", "conv2d",
            "conv2d_dgrad", "conv2d_wgrad")


def bound_dtype(op: str, dname: str) -> str:
    """The peak rate that bounds a case's operations: K4's fp32 CUDA-core
    math, K6's bf16 tensor-core passes (three for fp32 products), the TF32
    tensor cores for fp32 K2, K2w, K3, K5 and K5w (three passes, counted in
    the case's flops), else the storage dtype's."""
    if dname == "float32" and op in TF32_OPS:
        return "tf32"
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
# Rows whose library call is also profiled once, its device kernels printed
# by name (``library_kernels``): cuDNN's fp32 K5w at res2, which runs under
# three TF32 passes' bound with TF32 off.
LIBRARY_KERNELS = {("K5w", "train res2 [64, 64, 8, 1024]->1024", "float32")}


def _texture_cases():
    """Phase 7's shapes: the texture/face path at ``TextureFaceConfig()``
    (enc 8/16/16, res2 512 wide, res3 256). Runs: "texfwd" per bf16
    batch-8 ``texture_face_forward``; "texgrad32" per fp32 gradient-check
    step (batch 8, patch 128); "tex" / "tex64" per bf16 step at batch 24,
    patch 128 / 64; "texwgrad" per step with WGRAD=True; "tex2d" per step
    with CUDA_CONV2D. The shape grid warps at BC = B, the texture grid at
    BC = 4B, and only the texture grid's warp runs K4."""
    x8, x24, x24p = (8, 64, 64, 32, 16), (24, 64, 64, 32, 16), (24, 32, 32, 32, 16)
    full = lambda bc: (bc, 16384, 128, 128, 128)  # noqa: E731
    cases = [
        ("K1", "tex fwd texture pass [32,16384,128]", "pass", full(32), BF16, "texfwd"),
        ("K1", "tex texture pass [32,16384,128]", "pass", full(32), F32, "texgrad32"),
        ("K1", "tex shape pass [24,16384,128]", "pass", full(24), BF16, "tex"),
        ("K1", "tex texture pass [96,16384,128]", "pass", full(96), BF16, "tex"),
        ("K1", "tex64 texture window pass [96,16384,128]->64", "pass", (96, 16384, 128, 64, 128),
         BF16, "tex64"),
        ("K1", "tex64 texture window pass [96,8192,128]->64", "pass", (96, 8192, 128, 64, 128),
         BF16, "tex64"),
        *[("K4", f"tex texture adjoint [{bc},16384,128] taps {taps}", "pass_bwd",
           full(bc) + (taps, 1), dn, run)
          for bc, dn, run in ((96, BF16, "tex"), (32, F32, "texgrad32")) for taps in (3, 6)],
        ("K4", "tex64 texture adjoint [96,16384,128]->64 taps 6", "pass_bwd",
         (96, 16384, 128, 64, 128, 6, 1), BF16, "tex64"),
        ("K4", "tex64 texture adjoint [96,8192,128]->64 taps 6", "pass_bwd",
         (96, 8192, 128, 64, 128, 6, 1), BF16, "tex64"),
        ("K2", "tex e_conv3/res1 [8,64,64,32,16]->16", "conv3d", (x8, 16), BF16, "texfwd"),
        ("K2", "tex e_conv3/res1 fwd+dgrad [8,64,64,32,16]->16", "conv3d", (x8, 16), F32,
         "texgrad32"),
        ("K2", "tex e_conv3/res1 fwd+dgrad [24,64,64,32,16]->16", "conv3d", (x24, 16), BF16,
         "tex"),
        ("K2", "tex64 e_conv3/res1 fwd+dgrad [24,32,32,32,16]->16", "conv3d", (x24p, 16), BF16,
         "tex64"),
        ("K2w", "tex e_conv3/res1 [8,64,64,32,16]->16", "conv3d_wgrad", (x8, 16), F32,
         "texgrad32"),
        ("K2w", "tex e_conv3/res1 [24,64,64,32,16]->16", "conv3d_wgrad", (x24, 16), BF16, "tex"),
        ("K2w", "tex64 e_conv3/res1 [24,32,32,32,16]->16", "conv3d_wgrad", (x24p, 16), BF16,
         "tex64"),
    ]
    for c, stack in ((512, "res2"), (256, "res3")):
        cases += [
            ("K3", f"tex {stack} [8,64,64,{c}]->{c}", "wino", ((8, 64, 64, c), c), BF16, "texfwd"),
            ("K3", f"tex {stack} fwd+dgrad [8,64,64,{c}]->{c}", "wino_dgrad", ((8, 64, 64, c), c),
             F32, "texgrad32"),
            ("K3", f"tex {stack} fwd+dgrad [24,64,64,{c}]->{c}", "wino_dgrad",
             ((24, 64, 64, c), c), BF16, "tex"),
            ("K3", f"tex64 {stack} fwd+dgrad [24,32,32,{c}]->{c}", "wino_dgrad",
             ((24, 32, 32, c), c), BF16, "tex64"),
            ("K6", f"tex {stack} [24,64,64,{c}]->{c} WGRAD=True", "wino_wgrad",
             ((24, 64, 64, c), c, False), BF16, "texwgrad"),
        ]
        xh = (64, 64, 24, c)
        cases += [
            ("K5", f"tex2d {stack} prelu+pre {list(xh)}->{c}", "conv2d", (xh, c, "bias+prelu+pre"),
             BF16, "tex2d"),
            ("K5", f"tex2d {stack} res {list(xh)}->{c}", "conv2d", (xh, c, "bias+res"), BF16,
             "tex2d"),
            ("K5", f"tex2d {stack}_skip fwd + dgrad {list(xh)}->{c}", "conv2d_dgrad", (xh, c),
             BF16, "tex2d"),
            ("K5w", f"tex2d {stack} {list(xh)}->{c}", "conv2d_wgrad", (xh, c), BF16, "tex2d"),
        ]
    return cases


TEX_CASES = _texture_cases()
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
    *TEX_CASES,
]

# The sharded path's shapes (phase 11), on each rank of its model axis of 2
# at batch 8, patch 128: K1's y pass emitting the rank's 64 camera rows and
# the 2 halo rows inside the grid (66), the z pass on those rows; K2 and
# K2w on the 3-D slab extended by a row each side (34 of the 64 rows); K3
# on the 2-D slab extended by whole 2-row Winograd tiles (36).
X3S = (8, 34, 64, 32, 32)
SP_CASES = [
    ("K1", "spatial window pass [8,16384,128]->66", "pass", (8, 16384, 128, 66, 128), BF16,
     "sp_serve"),
    ("K1", "spatial pass [8,8448,128]", "pass", (8, 8448, 128, 128, 128), BF16, "sp_serve"),
    ("K2", "spatial e_conv3 [8,34,64,32,16]->32", "conv3d", ((8, 34, 64, 32, 16), 32), BF16,
     "sp_serve"),
    ("K2", "spatial res1 [8,34,64,32,32]->32", "conv3d", (X3S, 32), BF16, "sp_serve"),
    ("K2", "spatial train dgrad e_conv3 [8,34,64,32,32]->16", "conv3d_dgrad", (X3S, 16), BF16,
     "sp_train"),
    ("K2w", "spatial train e_conv3 [8,34,64,32,16]->32", "conv3d_wgrad",
     ((8, 34, 64, 32, 16), 32), BF16, "sp_train"),
    ("K2w", "spatial train res1 [8,34,64,32,32]->32", "conv3d_wgrad", (X3S, 32), BF16,
     "sp_train"),
    ("K3", "spatial res2 [8,36,64,1024]->1024", "wino", ((8, 36, 64, 1024), 1024), BF16,
     "sp_serve"),
    ("K3", "spatial res3 [8,36,64,512]->512", "wino", ((8, 36, 64, 512), 512), BF16,
     "sp_serve"),
    ("K3", "spatial train res2 fwd+dgrad [8,36,64,1024]->1024", "wino_dgrad",
     ((8, 36, 64, 1024), 1024), BF16, "sp_train"),
    ("K3", "spatial train res3 fwd+dgrad [8,36,64,512]->512", "wino_dgrad",
     ((8, 36, 64, 512), 512), BF16, "sp_train"),
]
CASES += SP_CASES

# Phase 12's sharded shapes, on each rank of the model axis of 2: the
# texture step at TextureFaceConfig() (batch 8, patch 128; the texture grid
# warps at BC = 32, the shape grid at 8 as SP_CASES' rows) and the recon
# step at ReconConfig() (BC 5 and 20): K1's last y pass emitting the rank's
# 66 camera rows, the z pass on them, and K4's adjoints of both (the
# plan's y and z scale passes, 6 taps); the texture warp's whole passes
# (five 3-tap shears and the x scale pass) in bf16; K2 / K2w at 16 -> 16
# channels on the 3-D slabs extended by a row each side (34 of 64 rows),
# K3 on the texture's 2-D slabs extended by whole tiles (36). Runs:
# "sp_tex" per sharded texture step, "sp_recon32" / "sp_recon16" per
# sharded recon step.
XTS = (8, 34, 64, 32, 16)
XRS = (5, 34, 64, 32, 16)
SP12_CASES = [
    ("K1", "spatial tex texture window pass [32,16384,128]->66", "pass",
     (32, 16384, 128, 66, 128), BF16, "sp_tex"),
    ("K1", "spatial tex texture pass [32,8448,128]", "pass", (32, 8448, 128, 128, 128), BF16,
     "sp_tex"),
    *[("K4", f"spatial tex texture adjoint [32,16384,128] taps {taps}", "pass_bwd",
       (32, 16384, 128, 128, 128, taps, 1), BF16, "sp_tex") for taps in (3, 6)],
    ("K4", "spatial tex texture window adjoint [32,16384,128]->66 taps 6", "pass_bwd",
     (32, 16384, 128, 66, 128, 6, 1), BF16, "sp_tex"),
    ("K4", "spatial tex texture adjoint [32,8448,128] taps 6", "pass_bwd",
     (32, 8448, 128, 128, 128, 6, 1), BF16, "sp_tex"),
    ("K2", "spatial tex e_conv3/res1 fwd+dgrad [8,34,64,32,16]->16", "conv3d", (XTS, 16), BF16,
     "sp_tex"),
    ("K2w", "spatial tex e_conv3/res1 [8,34,64,32,16]->16", "conv3d_wgrad", (XTS, 16), BF16,
     "sp_tex"),
    *[("K3", f"spatial tex {stack} fwd+dgrad [8,36,64,{c}]->{c}", "wino_dgrad",
       ((8, 36, 64, c), c), BF16, "sp_tex") for c, stack in ((512, "res2"), (256, "res3"))],
]
for _dn, _run in (("float32", "sp_recon32"), ("bfloat16", "sp_recon16")):
    for _what, _bc in (("shape", 5), ("texture", 20)):
        SP12_CASES += [
            ("K1", f"spatial recon {_what} window pass [{_bc},16384,128]->66", "pass",
             (_bc, 16384, 128, 66, 128), (_dn,), _run),
            ("K1", f"spatial recon {_what} pass [{_bc},8448,128]", "pass",
             (_bc, 8448, 128, 128, 128), (_dn,), _run),
            ("K4", f"spatial recon {_what} window adjoint [{_bc},16384,128]->66 taps 6",
             "pass_bwd", (_bc, 16384, 128, 66, 128, 6, 1), (_dn,), _run),
            ("K4", f"spatial recon {_what} adjoint [{_bc},8448,128] taps 6", "pass_bwd",
             (_bc, 8448, 128, 128, 128, 6, 1), (_dn,), _run),
        ]
    SP12_CASES.append(("K2", "spatial recon e_conv3/res1 fwd+dgrad [5,34,64,32,16]->16",
                       "conv3d", (XRS, 16), (_dn,), _run))
CASES += SP12_CASES

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
    # fp32 K2, K2w, K3: three TF32 passes per product (bound_dtype)
    passes = 3 if bound_dtype(op, str(dtype).split(".")[-1]) == "tf32" else 1
    if op == "conv3d":
        x = rnd(*xs)
        w = rnd(3, 3, 3, c, co, scale=1.0 / math.sqrt(27 * c))
        return (lambda: cuda_conv3d.nc_conv3d_forward(x, w),
                lambda: cuda_conv3d.nc_conv3d_plain(x, w),
                lambda: torch.nn.functional.conv3d(cf(x), w.permute(4, 3, 0, 1, 2), padding=1),
                passes * 2.0 * m * co * 27 * c, item * (x.numel() + w.numel() + m * co), False)
    if op == "conv3d_dgrad":  # gy [.., c] of a conv co -> c; the data gradient has co channels
        gy = rnd(*xs)
        w = rnd(3, 3, 3, co, c, scale=1.0 / math.sqrt(27 * co))
        wf = torch.flip(w, (0, 1, 2)).transpose(3, 4)
        size = (xs[0], co) + tuple(xs[1:4])
        return (lambda: cuda_conv3d.nc_conv3d_forward(gy, wf),
                lambda: cuda_conv3d.nc_conv3d_plain(gy, wf),
                lambda: grad.conv3d_input(size, w.permute(4, 3, 0, 1, 2), cf(gy), padding=1),
                passes * 2.0 * m * co * 27 * c, item * (gy.numel() + w.numel() + m * co),
                False)
    if op == "conv3d_wgrad":
        x = rnd(*xs)
        gy = rnd(*xs[:-1], co)
        return (lambda: cuda_conv3d.nc_conv3d_wgrad(x, gy),
                lambda: cuda_conv3d.nc_conv3d_wgrad_plain(x, gy),
                lambda: grad.conv3d_weight(cf(x), (co, c, 3, 3, 3), cf(gy), padding=1),
                passes * 2.0 * m * 27 * c * co, item * (x.numel() + gy.numel()) + 4 * 27 * c * co,
                True)
    if op.startswith("conv2d"):
        return conv2d_case(torch, op, spec, dtype, rnd, m, c, passes)
    tiles = xs[0] * (xs[1] // 2) * (xs[2] // 2)
    if op == "wino":
        x = rnd(*xs)
        w = rnd(3, 3, c, co, scale=1.0 / math.sqrt(9 * c))
        return (lambda: cuda_winograd.wino_conv2d_forward(x, w),
                lambda: cuda_winograd.wino_conv2d_plain(x, w),
                lambda: torch.nn.functional.conv2d(cf(x), w.permute(3, 2, 0, 1), padding=1),
                passes * 2.0 * 16 * tiles * c * co, item * (x.numel() + 16 * c * co + m * co),
                False)
    if op == "wino_dgrad":  # gy [.., c] of a conv co -> c; the data gradient has co channels
        gy = rnd(*xs)
        w = rnd(3, 3, co, c, scale=1.0 / math.sqrt(9 * co))
        wf = torch.flip(w, (0, 1)).transpose(2, 3)
        size = (xs[0], co) + tuple(xs[1:3])
        return (lambda: cuda_winograd.wino_conv2d_forward(gy, wf),
                lambda: cuda_winograd.wino_conv2d_plain(gy, wf),
                lambda: grad.conv2d_input(size, w.permute(3, 2, 0, 1), cf(gy), padding=1),
                passes * 2.0 * 16 * tiles * c * co, item * (gy.numel() + 16 * c * co + m * co),
                False)
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


def conv2d_case(torch, op, spec, dtype, rnd, m, c, passes):
    """make_case for K5 and K5w on HWNC inputs [H, W, B, C] (``passes``:
    three TF32 passes per product in fp32). The cuDNN yardstick runs on
    channels-last (NHWC) copies, with no epilogue."""
    from rendernet_tpu_torch.ops import cuda_conv2d

    grad = torch.nn.grad
    item = torch.tensor([], dtype=dtype).element_size()
    xs, co = spec[0], spec[1]
    h, wd, b = xs[:3]

    def nchw(t):  # HWNC -> an NCHW view of a channels-last copy
        return t.permute(2, 0, 1, 3).contiguous().permute(0, 3, 1, 2)

    flops = passes * 2.0 * m * 9 * c * co
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
            rate = bound_dtype(op, dname)
            bms, by = bound(flops, nbytes, rate)
            row = dict(kernel=kid, shape=label, dtype=dname, max_abs_err=err,
                       max_abs_ref=scale, tol=tol, ok=ok, ms=kms, plain_ms=pms,
                       library_ms=lms, bound_ms=bms, bound_by=by, run=run,
                       key=case_key(op, spec))
            if rate == "tf32":  # the bound of one fp32 pass on the CUDA cores, beside it
                row["cuda_core_bound_ms"] = bound(flops / 3, nbytes, "float32")[0]
            if path is not None:
                row["path"] = path
            if lib_err is not None:
                row["library_max_abs_err"] = lib_err
            if kid == "K3":
                row["v_scratch_bytes"] = cuda_winograd.v_scratch_bytes(spec[0], dtype)
            if (kid, label, dname) in LIBRARY_KERNELS:  # what the cuDNN yardstick runs
                row["library_kernels"] = [
                    {"kernel": k, "count": n, "ms": us / 1e3} for k, n, us in _profile(torch, lib)[0]]
            rows[kid, label, dname] = row
            tag = {None: "ragged", "check": "check"}.get(run, "kernel")
            log(f"{tag} " + json.dumps(row))
            if not ok:
                failures.append(f"{kid} {label} {dname}: err {err:.3e} > {tol:.3e}")
            torch.cuda.empty_cache()
    return rows


# The fp32 K5 / K5w / K2w accumulator chains swept (cuda_conv2d.
# CHAIN_STAGES_F32, stages of 32 channels of one tap; MAX_CHAIN_STEPS_F32,
# steps of 32 pixels; cuda_conv3d.WGRAD_CHAIN_ROWS_F32, rows of 128
# positions): the first of each list is the kernels' own, the last one chain
# over the whole sum (K5 at res2: 9 C / 32 = 288 stages; K2w: a CTA's rows,
# ~62 at batch 8 and ~186 at batch 24).
K5_CHAINS = (1, 2, 8, 288)
K5W_CHAINS = (32, 8, 128, 1 << 20)
K2W_CHAINS = (4, 1, 2, 8, 32, 1 << 20)


def chain_sweep(torch) -> dict:
    """The fp32 K5 (res2 prelu, batch 8), K5w (res2, batch 8) and K2w (res1
    [8 / 24,64,64,32,32]->32) at several accumulator chain lengths: error
    against the plain version as a fraction of max|plain|, and ms per call.
    The tensor cores' fp32 sums lose precision along a chain; this is what
    the kernels' lengths were chosen from."""
    from rendernet_tpu_torch.ops import cuda_conv2d as cc
    from rendernet_tpu_torch.ops import cuda_conv3d

    gen = torch.Generator(device="cuda").manual_seed(16)
    xs, c = (64, 64, 8, 1024), 1024
    x = torch.randn(*xs, generator=gen, device="cuda")
    w = torch.randn(3, 3, c, c, generator=gen, device="cuda") / math.sqrt(9 * c)
    kw = dict(bias=torch.randn(c, generator=gen, device="cuda") * 0.1, act="prelu",
              alpha=torch.rand(c, generator=gen, device="cuda") * 0.3)
    gz = torch.randn(*xs[:3], c, generator=gen, device="cuda")
    x3 = {b: torch.randn(*X3[b], generator=gen, device="cuda") for b in (8, 24)}
    gy3 = {b: torch.randn(*X3[b][:-1], 32, generator=gen, device="cuda") for b in (8, 24)}
    out = {"k5": [], "k5w": [], "k2w": [], "k2w_b24": []}
    sweeps = [(cc, "k5", "CHAIN_STAGES_F32", K5_CHAINS, lambda: cc.conv2d_hwnc(x, w, **kw),
               cc.conv2d_hwnc_plain(x, w, **kw)),
              (cc, "k5w", "MAX_CHAIN_STEPS_F32", K5W_CHAINS, lambda: cc.conv2d_wgrad(x, gz),
               cc.conv2d_wgrad_plain(x, gz))]
    sweeps += [(cuda_conv3d, key, "WGRAD_CHAIN_ROWS_F32", K2W_CHAINS,
                lambda b=b: cuda_conv3d.nc_conv3d_wgrad(x3[b], gy3[b]),
                cuda_conv3d.nc_conv3d_wgrad_plain(x3[b], gy3[b]))
               for b, key in ((8, "k2w"), (24, "k2w_b24"))]
    for mod, key, name, chains, fn, ref in sweeps:
        own = getattr(mod, name)
        try:
            for chain in chains:
                setattr(mod, name, chain)
                err = float((fn() - ref).abs().max()) / float(ref.abs().max())
                out[key].append({"chain": chain, "err_rel": err, "ms": time_ms(torch, fn, 10)})
        finally:
            setattr(mod, name, own)
    log("chains " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# launch counters
# ---------------------------------------------------------------------------
def path_counter(kid):
    """K1's or K4's launches by path (``cuda_resample.pass_plan``)."""
    from rendernet_tpu_torch.ops import cuda_resample

    return {"K1": cuda_resample.launches_by_path, "K4": cuda_resample.bwd_launches_by_path}[kid]


def _counters():
    from rendernet_tpu_torch.ops import (
        cuda_adam,
        cuda_conv2d,
        cuda_conv3d,
        cuda_resample,
        cuda_winograd,
    )

    mods = {"cuda_resample": cuda_resample, "cuda_conv3d": cuda_conv3d,
            "cuda_winograd": cuda_winograd, "cuda_conv2d": cuda_conv2d, "cuda_adam": cuda_adam}
    return {kid: (mods[m], p) for kid, (m, p) in COUNTERS.items()}


def reset_counts():
    for mod, p in _counters().values():
        if hasattr(mod, p + "launches"):
            setattr(mod, p + "launches", 0)
        getattr(mod, p + "launches_by_shape").clear()
    for kid in ("K1", "K4"):
        path_counter(kid).clear()


def read_counts():
    """({kernel id: launches}, {kernel id: {shape key: launches}}); the
    totals are the sums of the counts by shape."""
    by_shape = {k: dict(getattr(m, p + "launches_by_shape")) for k, (m, p) in _counters().items()}
    return {k: sum(v.values()) for k, v in by_shape.items()}, by_shape


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


def serve_inputs(torch, np, b=8):
    """Phase 3's bf16 forward's inputs: the procedural voxel, poses from seed 0."""
    rng = np.random.default_rng(0)
    vox = torch.from_numpy(np.repeat(
        procedural_voxel().astype(np.float32)[None, :, :, :, None], b, axis=0)).cuda()
    pose = torch.from_numpy(np.stack(
        [rng.uniform(0, 6.28, b), rng.uniform(-1, 1, b), np.ones(b)], axis=1
    ).astype(np.float32)).cuda()
    return vox, pose


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
    net = init_shader_params(0, ShaderConfig(), device="cuda")
    vox, pose = serve_inputs(torch, np)
    layers.WINOGRAD_2D = "pallas"
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


def adam_launches(net) -> dict:
    """The optimizer's launches a training step: the fused Adam kernel
    once, over every parameter tensor of ``net`` (keyed by the tensors a
    launch takes)."""
    return {"Adam": {len(list(net.parameters())): 1}}


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


def spread_alphas(torch, net):
    """``net`` with its PReLU alphas drawn uniform in [0.05, 0.3) (seed 3,
    on the card), away from 0 so that the negative slope counts."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("alpha"):
                p.uniform_(0.05, 0.3, generator=gen)
    return net


def grad_inputs(torch, np, b=8):
    """The gradient check's inputs (phase 4): the procedural voxel, poses
    from seed 1, disc targets from seed 2."""
    rng = np.random.default_rng(1)
    vox = torch.from_numpy(np.repeat(
        procedural_voxel().astype(np.float32)[None, :, :, :, None], b, axis=0)).cuda()
    pose = torch.from_numpy(np.stack(
        [rng.uniform(0, 6.28, b), rng.uniform(-1, 1, b), np.ones(b)], axis=1
    ).astype(np.float32)).cuda()
    return vox, torch.from_numpy(disc_images(np, b, 512, 2)).cuda(), pose


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

    net = spread_alphas(torch, init_shader_params(0, ShaderConfig(preact_policy=True),
                                                  device="cuda"))
    vox, images, pose = grad_inputs(torch, np)
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
            prof = None
            if dtype == torch.float32 and patch == 128:  # the fp32 step's K2w, by name
                prof = profile_run(torch, lambda: grads(dtype, patch), run=f"{tag} float32 128")
                check_profiled_names(failures, prof, "K2w", "conv3d_wgrad_tf32_kernel", what)
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
            if prof is not None:
                res["profile_K2w"] = prof["K2w"]
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
    counts checked against ``expected`` and one Adam launch per step, every
    loss finite and every parameter finite and moved. Returns (state,
    result, launches per step)."""
    expected = {**expected, **adam_launches(state.params)}
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

    layers.WINOGRAD_2D = "pallas"  # bench.py's configuration: the 2D stacks on K3
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

    # (e) the A/B of the rewrites on both patches' steps (phase 9's (b))
    out["ab_phase"] = {}
    for patch in (64, 128):
        step = make_shader_train_step(mcfg, cfg, tx, patch)
        state, out["ab_phase"][patch] = phase_ab(
            torch, failures, state, step, (vox, img, pose), step_launches(b, patch),
            f"shader patch {patch} steps", {"path": "shader", "patch": patch, "batch": b,
                                            "dtype": "bfloat16"})
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
    # the A/B of the sub-pixel deconvs (phase 9's (b)): the same steps with
    # every K=4 deconv on cuDNN's transposed conv (launches checked)
    with cudnn_deconvs():
        out["steps_cudnn_deconv"] = timed_recon_steps(torch, failures, model, target, {},
                                                      "recon_cudnn_deconv")

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
    layers.CUDA_CONV2D, layers.WINOGRAD_2D = True, "pallas"
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


# ---------------------------------------------------------------------------
# phase 7: the texture/face path
# ---------------------------------------------------------------------------
# The texture forward with kernels vs with their plain versions (bf16,
# batch 8): max abs difference of each head's logits (before the sigmoid)
# as a fraction of the plain forward's logit spread, the worse head; the
# plain forward's sigmoid outputs must spread at least TEX_MIN_SPREAD.
# Readings on an H100: 0.0149 / 0.0188 (Image / Normal head) of spreads of
# 0.219 / 0.179; the limits are ~2.7x and ~0.4x of them.
TEX_FORWARD_TOL = 0.05
TEX_MIN_SPREAD = 0.08
# One texture step's gradients with kernels vs with their plain versions.
# The trunk's and heads' parameters as phase 4's (GRAD_TOL: per parameter
# max |g - g_plain| / max |g_plain|, the worst one). The texture decoder's
# gradients are sums over the 64^3 x 4 grid's cotangent that cancel, like
# recon's latent gradients, and their largest entries are single values
# out of up to 26 M (e_tex_fc1's weight), so they are held by norm, per
# parameter: ||g - g_plain|| / ||g_plain||, the worst one. They reach the
# decoder only through K4's voxel cotangent, so halving it on the warp's
# last pass (the control) puts every decoder parameter 0.5 off by norm,
# which each decoder limit must reject.
# Readings on an H100: trunk and heads 6.4e-4 (res3_5's first conv) fp32,
# 0.057 (res1_10's) bf16; decoder by norm 3.2e-3 fp32, 0.275 bf16 (both
# e_tex_fc1's bias: bf16 roundings in the trunk reach the texture grid's
# cotangent, a residue of sums that cancel, as in recon's bf16 check);
# the control 0.4950-0.4999 (e_tex_conv2's alpha the least). The fp32
# decoder limit is 3x its reading; the bf16 one sits between the reading
# and the control, which it rejects by 1.24x, as phase 5's bf16 limits do.
TEX_GRAD_TOL = GRAD_TOL
TEX_DECODER_TOL = {"float32": 1e-2, "bfloat16": 0.4}
TEX_STEPS = 5


def texture_step_launches(b, patch, wgrad=False, conv2d=False, forward=False):
    """Launches per texture step (or, with ``forward``, per
    ``texture_face_forward``) that the graph implies at
    ``TextureFaceConfig()``: two warps of 8 K1 passes, the shape grid at BC
    = B and the texture grid at BC = 4B (at a patch, the last pass on each
    cropped axis emits the window, as the shader step's); K4 on the texture
    warp only (five 3-tap shear passes and three 6-tap scale passes; at a
    patch the windowed scale passes take the window's shapes); e_conv3, the
    20 res1 convs and res1_skip on K2 at 16 -> 16 channels, forward and
    data gradient (44), K2w once each; the 21 res2 (512) and 11 res3 (256)
    convs on K3 forward and data gradient, K6 once each with WGRAD; with
    ``conv2d`` the 2D stacks take the fused route (k5_launches)."""
    n = 128

    def warp(bc):
        if patch == n:
            return {(bc, n * n, n, n): 8}
        return {(bc, n * n, n, n): 6, (bc, n * n, n, patch): 1, (bc, n * patch, n, patch): 1}

    bt = 4 * b
    if patch == n:
        k4 = {(bt, n * n, n, n, 3): 5, (bt, n * n, n, n, 6): 3}
    else:
        k4 = {(bt, n * n, n, n, 3): 5, (bt, n * n, n, n, 6): 1, (bt, n * n, n, patch, 6): 1,
              (bt, n * patch, n, patch, 6): 1}
    s = patch // 2
    x16, r2, r3 = (b, s, s, 32, 16), (b, s, s, 512), (b, s, s, 256)
    g = 1 if forward else 2
    k5, k5w = k5_launches(b, s, (512, 256), (10, 5), grad=not forward) if conv2d else ({}, {})
    return {"K1": {**warp(b), **warp(bt)}, "K4": {} if forward else k4,
            "K2": {(x16, 16): 22 * g}, "K2w": {} if forward else {(x16, 16): 22},
            "K3": {} if conv2d else {(r2, 512): 21 * g, (r3, 256): 11 * g},
            "K6": {(r2, 512): 21, (r3, 256): 11} if wgrad and not conv2d else {},
            "K5": k5, "K5w": {} if forward else k5w}


def texture_batch(torch, np, b, seed=0):
    """Procedural voxels, disc albedo and normal targets (3 channels), seeded
    texture codes and random poses, on the card."""
    rng = np.random.default_rng(seed)
    vox = np.repeat(procedural_voxel().astype(np.float32)[None, :, :, :, None], b, axis=0)
    img = np.concatenate([disc_images(np, b, 512, seed + c) for c in range(3)], axis=-1)
    nrm = np.concatenate([disc_images(np, b, 512, seed + 10 + c) for c in range(3)], axis=-1)
    codes = rng.standard_normal((b, 199)).astype(np.float32)
    pose = np.stack([rng.uniform(0, 6.28, b), rng.uniform(-1, 1, b), np.ones(b)],
                    axis=1).astype(np.float32)
    return tuple(torch.from_numpy(a).cuda() for a in (vox, img, nrm, codes, pose))


def texture_net(torch):
    """The seeded full-width network, its PReLU alphas drawn away from 0 so
    that the negative slope counts."""
    from rendernet_tpu_torch.models.texture_face import TextureFaceConfig, init_texture_face_params

    net = init_texture_face_params(0, TextureFaceConfig(), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("alpha"):
                p.uniform_(0.05, 0.3, generator=gen)
    return net


def texture_forward_check(torch, np, failures, per_step):
    """(a) One bf16 ``texture_face_forward`` at batch 8, its launches, both
    heads' logits against the all-plain forward's, and its time."""
    from rendernet_tpu_torch.models.texture_face import texture_face_forward

    net = texture_net(torch)
    vox, _, _, codes, pose = texture_batch(torch, np, 8)
    logits = []
    heads = [net.encoder["Image"]["e_conv10_1"]["conv2d_transpose"],
             net.encoder["Normal"]["e_conv10_2"]["e_conv10_2"]]
    hooks = [h.register_forward_hook(lambda mod, args, y: logits.append(y.float()))
             for h in heads]

    def fwd():
        return texture_face_forward(net, vox, codes, pose, compute_dtype=torch.bfloat16,
                                    resample="multipass")

    with torch.no_grad():
        reset_counts()
        albedo, normal = fwd()
        torch.cuda.synchronize()
        totals, by_shape = read_counts()
        per_step["texfwd"] = check_step_counts(failures, "texture forward", by_shape, 1,
                                               texture_step_launches(8, 128, forward=True))
        got = list(logits)
        logits.clear()
        with plain_kernels():
            reset_counts()
            ref_out = [t.float() for t in fwd()]
            ref = list(logits)
            if any(read_counts()[0].values()):
                failures.append("texture forward: the plain forward launched a kernel")
        logits.clear()
        errs = [float((a - b).abs().max()) / float(b.max() - b.min()) for a, b in zip(got, ref)]
        spreads = [float(t.max() - t.min()) for t in ref_out]
        res = {"launches": totals, "logit_rel_err": errs, "output_spread": spreads,
               "tol": TEX_FORWARD_TOL, "min_spread": TEX_MIN_SPREAD,
               "shapes": [list(albedo.shape), list(normal.shape)]}
        for h in hooks:
            h.remove()
        res["forward_ms"] = time_ms(torch, fwd, 3)
        with plain_kernels():
            res["plain_forward_ms"] = time_ms(torch, fwd, 2)
    log("texfwd " + json.dumps(res))
    if [list(albedo.shape), list(normal.shape)] != [[8, 512, 512, 3]] * 2 or not all(
            bool(torch.isfinite(t).all()) for t in (albedo, normal)):
        failures.append(f"texture forward: shapes {res['shapes']} or non-finite values")
    if not max(errs) <= TEX_FORWARD_TOL:
        failures.append(f"texture forward's logits differ from the plain forward's by {errs} "
                        f"of their spread (limit {TEX_FORWARD_TOL})")
    if not min(spreads) >= TEX_MIN_SPREAD:
        failures.append(f"texture plain forward's outputs spread only {spreads}")
    return res


def texture_gradient_check(torch, np, failures, per_step):
    """(b) One texture step's gradients (``texture_loss``) at batch 8, patch
    128, fp32 and bf16, with the kernels and with every kernel replaced by
    its plain version, parameter by parameter; the control halves K4's
    voxel cotangent on the texture warp's last pass and must fail the
    gate."""
    from rendernet_tpu_torch.models.texture_face import TextureFaceConfig
    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.train.steps import texture_loss

    net = texture_net(torch)
    batch = texture_batch(torch, np, 8, seed=1)
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    mcfg = TextureFaceConfig()
    out = {}
    for dname in ("float32", "bfloat16"):
        cfg = TrainConfig(batch_size=8, compute_dtype=dname, resample="multipass",
                          is_greyscale=False)

        def grads():
            loss = texture_loss(net, mcfg, cfg, 128, *batch)
            return float(loss.detach()), torch.autograd.grad(loss, params)

        def rel_errs(g, gp):
            """(max-relative errors of the trunk's and heads' parameters,
            norm-relative errors of the decoder's)."""
            net_errs, dec_errs = {}, {}
            for n, a, b in zip(names, g, gp):
                a, b = a.float(), b.float()
                if n.startswith("texture_encoder."):
                    dec_errs[n] = float((a - b).norm() / b.norm())
                else:
                    net_errs[n] = float((a - b).abs().max() / b.abs().max())
            return net_errs, dec_errs

        def worst(errs):
            k = max(errs, key=errs.get)
            return k, errs[k]

        what = f"texture {dname} gradient check"
        reset_counts()
        loss, g = grads()
        torch.cuda.synchronize()
        totals, by_shape = read_counts()
        ps = check_step_counts(failures, what, by_shape, 1, texture_step_launches(8, 128))
        prof = None
        if dname == "float32":
            per_step["texgrad32"] = ps
            prof = profile_run(torch, grads, run="texgrad32")  # the fp32 step's K2w, by name
            check_profiled_names(failures, prof, "K2w", "conv3d_wgrad_tf32_kernel", what)
        with plain_kernels():
            reset_counts()
            loss_p, gp = grads()
            if any(read_counts()[0].values()):
                failures.append(f"{what}: the plain step launched a kernel")
        for n, a, b in zip(names, g, gp):
            ref = float(b.float().abs().max())
            if not (ref > 0 and math.isfinite(ref)) or not bool(torch.isfinite(a).all()):
                failures.append(f"{what}: gradient of {n}: plain max {ref}, or non-finite")
        net_errs, dec_errs = rel_errs(g, gp)
        (wn, we), (dn, de) = worst(net_errs), worst(dec_errs)
        with k4_fault("gv_half"):
            c_net, c_dec = rel_errs(grads()[1], gp)
        (cn, ce) = min(c_dec.items(), key=lambda kv: kv[1])
        res = {"patch": 128, "loss": loss, "plain_loss": loss_p, "worst_param": wn,
               "worst_rel_err": we, "tol": TEX_GRAD_TOL[dname],
               "median_rel_err": sorted(net_errs.values())[len(net_errs) // 2],
               "decoder_worst_param": dn, "decoder_worst_norm_rel_err": de,
               "decoder_tol": TEX_DECODER_TOL[dname],
               "decoder_max_rel_err": worst({n: float((a.float() - b.float()).abs().max()
                                                      / b.float().abs().max())
                                             for n, a, b in zip(names, g, gp)
                                             if n in dec_errs}),
               "control_k4_gv_half": {"decoder_least_norm_rel_err": [cn, ce],
                                      "net_worst_rel_err": worst(c_net)},
               "params": len(names), "launches": totals}
        if prof is not None:
            res["profile_K2w"] = prof["K2w"]
        out[dname] = res
        log(f"texgrad {dname} " + json.dumps(res))
        if not we <= TEX_GRAD_TOL[dname]:
            failures.append(f"{what}: gradients differ from the all-plain step's: {wn} "
                            f"{we:.3e} > {TEX_GRAD_TOL[dname]}")
        if not de <= TEX_DECODER_TOL[dname]:
            failures.append(f"{what}: the decoder's gradients differ from the all-plain step's "
                            f"by norm: {dn} {de:.3e} > {TEX_DECODER_TOL[dname]}")
        if ce <= TEX_DECODER_TOL[dname]:
            failures.append(f"{what}: the control (K4's gv halved) passed the decoder's gate "
                            f"at {cn} ({ce:.3e})")
        del g, gp
    del net
    torch.cuda.empty_cache()
    return out


def texture_training(torch, np, failures, per_step):
    """(c, d) TEX_STEPS timed bf16 steps at batch 24 per patch (128, 64),
    their launches checked per step; one step each with WGRAD=True and with
    CUDA_CONV2D, counted; a profiled patch-128 step."""
    from rendernet_tpu_torch.models.texture_face import TextureFaceConfig
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.ops import cuda_winograd
    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.train.steps import create_texture_state, make_texture_train_step

    b = 24
    cfg = TrainConfig(batch_size=b, img_res=512, new_size=128, compute_dtype="bfloat16",
                      is_greyscale=False, e_eta=1e-5, moment_dtype="bfloat16",
                      resample="multipass")
    mcfg = TextureFaceConfig()
    batch = texture_batch(torch, np, b, seed=2)
    state, tx = create_texture_state(0, mcfg, cfg, device="cuda")
    out = {}
    for patch, run in ((128, "tex"), (64, "tex64")):
        step = make_texture_train_step(mcfg, cfg, tx, patch)
        state, out[patch], per_step[run] = timed_steps(
            torch, failures, state, step, batch, TEX_STEPS, texture_step_launches(b, patch),
            f"texture patch {patch} steps", "textrain",
            {"patch": patch, "batch": b, "dtype": "bfloat16"})
    step = make_texture_train_step(mcfg, cfg, tx, 128)
    for run, kw in (("texwgrad", {"wgrad": True}), ("tex2d", {"conv2d": True})):
        cuda_winograd.WGRAD = run == "texwgrad"
        layers.CUDA_CONV2D = run == "tex2d"
        try:
            state, _ = step(state, *batch, 1)  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            state, loss = step(state, *batch, 1)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            totals, by_shape = read_counts()
            per_step[run] = check_step_counts(failures, f"texture {run} step", by_shape, 1,
                                              texture_step_launches(b, 128, **kw))
        finally:
            cuda_winograd.WGRAD, layers.CUDA_CONV2D = False, False
        out[run] = {"ms": ms, "loss": float(loss), "launches": totals}
        log(f"textrain {run} " + json.dumps(out[run]))
        if not math.isfinite(float(loss)):
            failures.append(f"texture {run} step: non-finite loss")
    # the A/B of the rewrites on both patches' steps (phase 9's (b))
    out["ab_phase"] = {}
    for patch in (64, 128):
        step = make_texture_train_step(mcfg, cfg, tx, patch)
        state, out["ab_phase"][patch] = phase_ab(
            torch, failures, state, step, batch, texture_step_launches(b, patch),
            f"texture patch {patch} steps", {"path": "texture", "patch": patch, "batch": b,
                                             "dtype": "bfloat16"})
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], *batch, 1)

    out["profile"] = profile_run(torch, one_step, run="texture bf16 patch 128 batch 24")
    # the same step with a range around each conv and deconv outside the
    # res blocks (whose convs run on K2 / K3), forward and backward, so
    # that its cuDNN dgrad calls are named by layer
    net = holder[0].params
    in_blocks = {f"{n}.{c}" for n, m in net.named_modules() if isinstance(m, layers.ResBlock)
                 for c, _ in m.named_children()}
    named = {n: m for n, m in net.named_modules()
             if isinstance(m, (layers.Conv, layers.ConvTranspose)) and n not in in_blocks}
    out["named_profile"] = named_profile(torch, one_step, named,
                                         "texture bf16 patch 128 batch 24")
    return out


def run_texture(torch, failures, per_step):
    """Phase 7: the texture/face path at TextureFaceConfig(), multipass, the
    2D stacks on K3 (WINOGRAD_2D, as bench.py's configuration)."""
    import numpy as np

    from rendernet_tpu_torch.nn import layers

    gc.collect()
    torch.cuda.empty_cache()
    layers.WINOGRAD_2D = "pallas"
    out = {}
    try:
        for name, fn in (("forward", texture_forward_check), ("gradient_check",
                                                             texture_gradient_check),
                         ("training", texture_training)):
            t0 = time.perf_counter()
            out[name] = fn(torch, np, failures, per_step)
            gc.collect()
            torch.cuda.empty_cache()
            log(f"phase 7 {name} took {time.perf_counter() - t0:.1f} s")
    finally:
        layers.WINOGRAD_2D = False
    return out


# ---------------------------------------------------------------------------
# phase 8: the training CLIs on the card
# ---------------------------------------------------------------------------
CLI_BATCH = 8


def shader_dataset(torch, tmp):
    """pack-tar's input: 3 procedural voxel models (the sphere and box, and
    two mirror images of it) rendered by ``make_synthetic_shader_tar`` on
    the card from 8 poses each at img_res 512, unpacked into a directory of
    PNGs; returns (PNG dir, model dir)."""
    import tarfile

    import numpy as np

    from rendernet_tpu_torch.data.synthetic import make_synthetic_shader_tar
    from rendernet_tpu_torch.io.binvox import save_binvox

    base = procedural_voxel()
    paths = []
    for i, v in enumerate((base, base[::-1], base[:, :, ::-1])):
        paths.append(os.path.join(tmp, f"proc{i}.binvox"))
        save_binvox(np.ascontiguousarray(v), paths[-1])
    poses = [(az, th) for az in (30, 120, 210, 300) for th in (60, 100)]
    tar, model_dir = make_synthetic_shader_tar(os.path.join(tmp, "synth"), paths, poses,
                                               img_res=512, device="cuda")
    png_dir = os.path.join(tmp, "pngs")
    with tarfile.open(tar) as tf:
        tf.extractall(png_dir, filter="data")
    return png_dir, model_dir


def run_cli(torch, failures, per_step, tmp):
    """Phase 8: pack-tar, train-shader (6 steps over a curriculum that
    crosses from patch 32 to 64, then a resumed run to step 8, full width,
    bf16, multipass, the 2D stacks on K3), train-texture (2 steps on a
    synthetic face dataset), all on the card."""
    import numpy as np

    from rendernet_tpu_torch.cli.__main__ import main as cli_main
    from rendernet_tpu_torch.data.loaders import data_loader
    from rendernet_tpu_torch.data.synthetic import synthetic_face_dataset
    from rendernet_tpu_torch.io import native, native_img
    from rendernet_tpu_torch.io.binvox import save_binvox
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.train.loop import train_shader
    from rendernet_tpu_torch.utils import image

    gc.collect()
    torch.cuda.empty_cache()
    out = {"native_decoders": {"png": native_img.available(), "binvox": native.available()}}
    if not native_img.available():
        failures.append(f"the native PNG decoder did not build: {native_img.error()}")
    t0 = time.perf_counter()
    png_dir, model_dir = shader_dataset(torch, tmp)
    out["dataset_s"] = time.perf_counter() - t0
    tar = os.path.join(tmp, "images.tar")
    rc = cli_main(["pack-tar", "--images_path", png_dir, "--save_path", tar])
    n_png = len([f for f in os.listdir(png_dir) if f.endswith(".png")])
    out["pack_tar"] = {"rc": rc, "pngs": n_png}
    out["dataset"] = {"tar": tar, "model_dir": model_dir}  # phase 10's
    if rc != 0 or n_png != 24:
        failures.append(f"pack-tar: rc {rc}, {n_png} PNGs")

    # the loader alone: every image and voxel grid of the tar, decoded
    before = dict(image.decoded_by)
    t0 = time.perf_counter()
    n_img = sum(len(c[0]) for c in data_loader(tar, model_dir, batch_size=CLI_BATCH,
                                               flatten=True, img_res=512))
    load_s = time.perf_counter() - t0
    decoded = {k: v - before.get(k, 0) for k, v in image.decoded_by.items()}
    out["loader"] = {"images": n_img, "s": load_s, "images_per_s": n_img / load_s,
                     "decoded_by": decoded}
    log("cli_loader " + json.dumps(out["loader"]))
    if decoded.get("python") or not decoded.get("native"):
        failures.append(f"the loader decoded {decoded}: not all by the native decoder")

    run_dir = os.path.join(tmp, "shader_run")
    cfg_path = os.path.join(tmp, "shader.json")
    with open(cfg_path, "w") as f:
        json.dump({"image_path": tar, "model_path": model_dir, "batch_size": CLI_BATCH,
                   "img_res": 512, "new_size": 128, "compute_dtype": "bfloat16",
                   "resample": "multipass", "moment_dtype": "bfloat16", "curriculum_epochs": 1,
                   "max_epochs": 4, "sample_save": run_dir, "sample_every_steps": 1000,
                   "checkpoint_secs": 100000, "e_eta": 1e-5}, f)
    layers.WINOGRAD_2D = "pallas"
    try:
        before = dict(image.decoded_by)
        reset_counts()
        t0 = time.perf_counter()
        rc = cli_main(["train-shader", cfg_path, "--max-steps", "6"])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        _, by_shape = read_counts()
        want = {}
        for patch, n in ((32, 3), (64, 3)):  # 24 images: 3 steps an epoch
            for kid, exp in step_launches(CLI_BATCH, patch).items():
                for k, v in exp.items():
                    want.setdefault(kid, {})[k] = want.get(kid, {}).get(k, 0) + n * v
        check_step_counts(failures, "train-shader CLI", {k: by_shape[k] for k in ("K1", "K2",
                                                                               "K3")},
                          1, {k: want[k] for k in ("K1", "K2", "K3")})
        reset_counts()
        marks = []
        t0 = time.perf_counter()
        state = train_shader(TrainConfig.from_json(cfg_path), max_steps=8,
                             progress=lambda step, loss: marks.append(time.perf_counter()))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        _, by_shape = read_counts()
        check_step_counts(failures, "resumed train-shader", {k: by_shape[k] for k in
                                                             ("K1", "K2", "K3")}, 2,
                          {k: step_launches(CLI_BATCH, 32)[k] for k in ("K1", "K2", "K3")})
    finally:
        layers.WINOGRAD_2D = False
    decoded = {k: v - before.get(k, 0) for k, v in image.decoded_by.items()}
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    on_card = all(p.is_cuda for p in state.params.parameters())
    files = sorted(os.listdir(run_dir))
    # steps/s: the CLI run's 6 steps over its wall time, start-up, data and
    # checkpoint write included; and between the resumed run's two steps
    # (host marks; the guard reads each loss one step late)
    out["train_shader"] = {"rc": rc, "first_run_s": first_s, "steps_per_s": 6 / first_s,
                           "resumed_run_s": resume_s,
                           "resumed_step_s": marks[1] - marks[0] if len(marks) == 2 else None,
                           "step": state.step, "params_on_card": on_card, "files": files,
                           "metrics": metrics, "decoded_by": decoded}
    log("cli_shader " + json.dumps(out["train_shader"]))
    if (rc != 0 or state.step != 8 or not on_card
            or {"resumed_at_step": 6} not in metrics
            or not {"config.json", "metrics.jsonl", "tb", "3d2d_renderer"} <= set(files)):
        failures.append(f"train-shader CLI: rc {rc}, step {state.step}, params on the card "
                        f"{on_card}, metrics {metrics}, files {files}")
    if decoded.get("python") or not decoded.get("native"):
        failures.append(f"train-shader decoded {decoded}: not all by the native decoder")

    # train-texture on a synthetic face dataset at img_res 512
    base = procedural_voxel()
    paths = []
    for i, v in enumerate((base, base[::-1])):
        paths.append(os.path.join(tmp, f"face{i}.binvox"))
        save_binvox(np.ascontiguousarray(v), paths[-1])
    ftar, fmod, ftex, fnrm = synthetic_face_dataset(os.path.join(tmp, "face"), paths,
                                                    img_res=512, device="cuda")
    trun = os.path.join(tmp, "texture_run")
    tcfg_path = os.path.join(tmp, "texture.json")
    with open(tcfg_path, "w") as f:
        json.dump({"image_path": ftar, "model_path": fmod, "texture_path": ftex,
                   "normal_path": fnrm, "batch_size": 2, "img_res": 512, "new_size": 128,
                   "compute_dtype": "bfloat16", "resample": "multipass",
                   "is_greyscale": False, "max_epochs": 2, "sample_save": trun,
                   "sample_every_steps": 1, "checkpoint_secs": 100000}, f)
    reset_counts()
    t0 = time.perf_counter()
    rc = cli_main(["train-texture", tcfg_path, "--max-steps", "2"])
    torch.cuda.synchronize()
    tex_s = time.perf_counter() - t0
    totals, _ = read_counts()
    with open(os.path.join(trun, "metrics.jsonl")) as f:
        tmetrics = [json.loads(line) for line in f]
    out["train_texture"] = {"rc": rc, "s": tex_s, "launches": totals, "metrics": tmetrics,
                            "files": sorted(os.listdir(trun))}
    log("cli_texture " + json.dumps(out["train_texture"]))
    losses = [m["loss"] for m in tmetrics if "loss" in m]
    if (rc != 0 or len(losses) != 2 or not all(math.isfinite(x) for x in losses)
            or not (totals["K1"] and totals["K4"] and totals["K2"] and totals["K2w"])):
        failures.append(f"train-texture CLI: rc {rc}, losses {losses}, launches {totals}")
    return out


# ---------------------------------------------------------------------------
# phase 9: the exact conv rewrites (phase-space conv, sub-pixel deconvs,
# depth-packed conv) against their plain forms, and the frozen artifact
# ---------------------------------------------------------------------------
# A rewrite on seeded inputs: the output and both gradients, each within
# this fraction of its reference's max. fp32 (TF32 off): the reference is
# the plain form, which sums the same products in other orders (weight
# gradients, sums over up to 4e8 products: WGRAD_TOL). bf16: the reference
# is the plain form computed in fp32 on the same bf16 values, since each
# bf16 result rounds once (2^-8 relative), but cuDNN's own bf16 plain form
# may round more than once: its data gradient of the 1-channel e_conv1 sat
# 1.7% of its max from that reference on an H100, the phase form's one
# ulp. The plain bf16 form's error against the reference is printed beside
# it.
REWRITE_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
# The arms of the A/B (phases 4, 5 and 7), each a warm-up and AB_STEPS
# timed steps (median): PHASE_CONV3D off, True (the fan-in gate) and
# "all"; and "all" with the K=4 deconvs on cuDNN's transposed conv
# (``layers._plain_conv_transpose``, the form the sub-pixel ones replace;
# patched here only, the port has no switch for it).
PHASE_ARMS = (("off", False, False), ("gate", True, False), ("all", "all", False),
              ("all_cudnn_deconv", "all", True))
AB_STEPS = 3


class cudnn_deconvs:
    """Every K=4 transposed conv on ``_plain_conv_transpose`` (cuDNN)."""

    def __enter__(self):
        from rendernet_tpu_torch.nn import layers

        self.route = layers._deconv_route
        layers._deconv_route = lambda ks, stride: None

    def __exit__(self, *exc):
        from rendernet_tpu_torch.nn import layers

        layers._deconv_route = self.route
# The frozen artifact (fp32, exact resample) against the live exact forward
# on the card, max abs difference of the [0, 1] image: the same aten ops, in
# another process whose cuDNN may pick other algorithms (TF32 off in both),
# ~4e-6 of a logit spread of ~1 through the sigmoid (slope <= 1/4).
FROZEN_TOL = 2e-5


def phase_ab(torch, failures, state, step, batch, expected, what, info):
    """The arms of PHASE_ARMS on one training step (``step`` at one patch,
    ``batch``), in order, each with its launches checked against
    ``expected`` (the rewrites add none); returns (state, {arm: median
    ms})."""
    from rendernet_tpu_torch.nn import layers

    saved, medians = layers.PHASE_CONV3D, {}
    try:
        for arm, value, cudnn in PHASE_ARMS:
            layers.PHASE_CONV3D = value
            with cudnn_deconvs() if cudnn else contextlib.nullcontext():
                state, res, _ = timed_steps(torch, failures, state, step, batch, AB_STEPS,
                                            expected, f"{what} {arm}", "ab", dict(info, arm=arm))
            medians[arm] = res["median_ms"]
    finally:
        layers.PHASE_CONV3D = saved
    log("ab_phase " + json.dumps(dict(info, median_ms=medians)))
    return state, medians


def named_profile(torch, fn, modules, run):
    """One profiled call of ``fn`` with a ``record_function`` range around
    the forward and the backward of each of ``modules`` ({name: module}):
    each range's device time and the cuDNN dgrad kernels in it, and every
    dgrad kernel of the call (name, calls, ms)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    opened, handles = {}, []

    def enter(key):
        opened[key] = record_function(key)
        opened[key].__enter__()

    def leave(key):
        rf = opened.pop(key, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    for name, mod in modules.items():
        f, b = f"fwd {name}", f"bwd {name}"
        handles += [mod.register_forward_pre_hook(lambda m, a, k=f: enter(k)),
                    mod.register_forward_hook(lambda m, a, y, k=f: leave(k)),
                    mod.register_full_backward_pre_hook(lambda m, g, k=b: enter(k)),
                    mod.register_full_backward_hook(lambda m, gi, go, k=b: leave(k))]
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()

    def kernels(evt):
        out = list(getattr(evt, "kernels", []))
        for child in getattr(evt, "cpu_children", []):
            out += kernels(child)
        return out

    ranges = {}
    for evt in prof.events():
        if "CPU" not in str(getattr(evt, "device_type", "CPU")):
            continue  # the device's copy of a range carries no kernels
        if evt.name.startswith(("fwd ", "bwd ")) and evt.name.split(" ", 1)[1] in modules:
            ks = kernels(evt)
            r = ranges.setdefault(evt.name, {"calls": 0, "device_ms": 0.0, "dgrad": {}})
            r["calls"] += 1
            r["device_ms"] += sum(k.duration for k in ks) / 1e3
            for k in ks:
                if "dgrad" in k.name.lower():
                    d = r["dgrad"].setdefault(k.name[:80], [0, 0.0])
                    d[0] += 1
                    d[1] += k.duration / 1e3
    dgrad = {}
    for evt in prof.key_averages():
        if "CUDA" in str(getattr(evt, "device_type", "")) and "dgrad" in evt.key.lower():
            us = getattr(evt, "self_device_time_total", None)
            us = getattr(evt, "self_cuda_time_total", 0.0) if us is None else us
            dgrad[evt.key[:80]] = [evt.count, us / 1e3]
    named = sum(d[1] for r in ranges.values() for d in r["dgrad"].values())
    res = {"run": run, "ranges": ranges, "dgrad_kernels": dgrad,
           "dgrad_ms": sum(d[1] for d in dgrad.values()), "dgrad_ms_named": named}
    log("named_profile " + json.dumps(res))
    return res


def record_routes(torch, fn):
    """The convs and deconvs ``fn`` runs: (kind, input shape, kernel shape,
    stride, route) in call order, from ``layers._kernel_for`` and
    ``layers._deconv_route``."""
    from rendernet_tpu_torch.nn import layers

    log_, kernel_for, deconv_route = [], layers._kernel_for, layers._deconv_route
    convt = layers.conv_transpose_op

    def conv_route(x, w_shape, stride, ndim):
        route = kernel_for(x, w_shape, stride, ndim)
        log_.append(("conv", tuple(x.shape), tuple(w_shape), tuple(stride), route))
        return route

    def deconv(x, w, stride, ndim):
        log_.append(("deconv", tuple(x.shape), tuple(w.shape), tuple(stride),
                     deconv_route(w.shape[:ndim], tuple(stride))))
        return convt(x, w, stride, ndim)

    layers._kernel_for, layers.conv_transpose_op = conv_route, deconv
    try:
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
    finally:
        layers._kernel_for, layers.conv_transpose_op = kernel_for, convt
    return log_


def model_routes(torch, np):
    """Every conv and deconv of the three families at full width on the
    card, with PHASE_CONV3D "all" and DEPTH_PACK on (so every conv the
    rewrites could take shows it): the shader and the texture network at
    batch 1 (the rows scale the batch), the recon step's forward as it runs
    (5 hypotheses, decoders at batch 1). Returns {family: [record]}."""
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params
    from rendernet_tpu_torch.models.texture_face import texture_decoder
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.recon.inverse import ReconConfig, initial_latents, recon_forward

    saved = layers.PHASE_CONV3D, layers.DEPTH_PACK
    layers.PHASE_CONV3D, layers.DEPTH_PACK = "all", True
    out = {}
    try:
        net = init_shader_params(0, ShaderConfig(), device="cuda")
        out["shader"] = record_routes(torch, lambda: net(
            torch.zeros(1, 128, 128, 128, 1, device="cuda")))
        del net
        tex = texture_net(torch)
        out["texture"] = record_routes(torch, lambda: (
            texture_decoder(tex, torch.zeros(1, 199, device="cuda")),
            tex(torch.zeros(1, 128, 128, 128, 5, device="cuda"))))
        del tex
        model = recon_model(torch)
        cfg = ReconConfig(compute_dtype="bfloat16", light_elevation=RECON_LIGHT_ELEVATION)
        lat = initial_latents(cfg, device="cuda")
        out["recon"] = record_routes(torch, lambda: recon_forward(model, lat, cfg))
        del model
    finally:
        layers.PHASE_CONV3D, layers.DEPTH_PACK = saved
    gc.collect()
    torch.cuda.empty_cache()
    for fam, recs in out.items():
        census = {}
        for kind, *_, route in recs:
            census[f"{kind}:{route}"] = census.get(f"{kind}:{route}", 0) + 1
        log(f"routes {fam} " + json.dumps(census))
    return out


def rewrite_row(torch, failures, label, fast, plain, x_shape, w_shape, dname, grads="xw"):
    """A rewrite (``fast``) against its plain form on seeded inputs at one
    shape: the output and the gradients named in ``grads`` (x: data, w:
    weights) within REWRITE_TOL of the reference (WGRAD_TOL for fp32
    weight gradients), and both forms' ms for forward + backward (CUDA
    events)."""
    dtype = getattr(torch, dname)
    gen = torch.Generator(device="cuda").manual_seed(zlib.crc32(label.encode()))
    x = torch.randn(x_shape, generator=gen, device="cuda").to(dtype)
    fan_in = math.prod(w_shape[:-1])
    w = (torch.randn(w_shape, generator=gen, device="cuda") / math.sqrt(fan_in)).to(dtype)
    x.requires_grad_("x" in grads)
    w.requires_grad_("w" in grads)
    wrt = [t for t in (x, w) if t.requires_grad]
    y0 = plain(x, w)
    g = torch.randn(y0.shape, generator=gen, device="cuda").to(dtype)

    def run(fn):
        y = fn(x, w)
        return (y.detach(),) + torch.autograd.grad(y, wrt, g)

    got, plain_out = run(fast), run(plain)
    if dname == "float32":
        ref = plain_out
    else:  # the plain form in fp32 on the same bf16 values
        x32, w32 = (t.detach().float().requires_grad_(t.requires_grad) for t in (x, w))
        y32 = plain(x32, w32)
        ref = (y32.detach(),) + torch.autograd.grad(
            y32, [t for t in (x32, w32) if t.requires_grad], g.float())
        del x32, w32, y32
    errs, ok = [], True
    for part, a, p, b in zip(["y"] + [t for t in "xw" if t in grads], got, plain_out, ref):
        scale = max(float(b.float().abs().max()), 1e-30)
        err = float((a.float() - b.float()).abs().max())
        tol = (WGRAD_TOL if part == "w" and dname == "float32" else REWRITE_TOL[dname]) * scale
        e = {"part": part, "max_abs_err": err, "max_abs_ref": scale, "tol": tol}
        if dname != "float32":
            e["plain_max_abs_err"] = float((p.float() - b.float()).abs().max())
        errs.append(e)
        ok = ok and err <= tol and bool(torch.isfinite(a.float()).all())
    del got, plain_out, ref, y0
    row = {"rewrite": label, "dtype": dname, "x": list(x_shape), "w": list(w_shape),
           "ms": time_ms(torch, lambda: run(fast), 5),
           "plain_ms": time_ms(torch, lambda: run(plain), 5), "errors": errs, "ok": ok}
    log("rewrite " + json.dumps(row))
    if not ok:
        failures.append(f"rewrite {label} {dname}: {errs}")
    del x, w, g
    torch.cuda.empty_cache()
    return row


def _batched(shape, b):
    return (b,) + tuple(shape[1:])


def rewrite_rows(torch, failures, routes):
    """(a) Each phase-space conv (shader and texture e_conv1 / e_conv2),
    sub-pixel deconv and, where one runs, depth-packed conv of the three
    families against its plain form: the shader's and texture's at the
    bf16 steps' batch 24 and the fp32 gradient checks' batch 8, recon's at
    its own batches. The texture's e_conv1 also as phase_dgrad_conv3d (its
    data gradient through the phase adjoint). Where K2 takes every conv
    the depth packing could, that is printed, and the packing is timed at
    res1's shape against the plain conv and K2."""
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.ops import cuda_conv3d, phase_conv

    batches = {"shader": {"bfloat16": 24, "float32": 8}, "texture": {"bfloat16": 24,
                                                                     "float32": 8}}
    rows, seen = [], set()
    for fam, recs in routes.items():
        for kind, xs, ws, stride, route in recs:
            for dname in ("bfloat16", "float32"):
                b = batches.get(fam, {}).get(dname)
                x_shape = _batched(xs, b) if b else xs
                ndim = len(stride)
                key = (kind, x_shape, ws, stride, dname)
                if key in seen or route not in ("phase", "s1_k4", "s2_k4", "depth_pack"):
                    continue
                seen.add(key)
                label = f"{fam} {kind} {route} {list(x_shape)} @ {list(ws)} s{list(stride)}"
                if route == "phase":
                    fast = lambda x, w, s=stride: phase_conv.phase_conv3d(x, w, s)  # noqa: E731
                    plain = lambda x, w, s=stride: layers._plain_conv(x, w, s, 3)  # noqa: E731
                elif route == "depth_pack":
                    f = layers._depth_pack_factor(x_shape, ws, stride)
                    fast = lambda x, w, f=f: layers._depth_packed_conv(x, w, f)  # noqa: E731
                    plain = lambda x, w: layers._plain_conv(x, w, (1, 1, 1), 3)  # noqa: E731
                else:
                    fast = (layers._deconv_s1_k4 if route == "s1_k4" else layers._deconv_s2_k4)
                    fast = lambda x, w, fn=fast, n=ndim: fn(x, w, n)  # noqa: E731
                    plain = lambda x, w, s=stride, n=ndim: layers._plain_conv_transpose(  # noqa
                        x, w, s, n)
                rows.append(rewrite_row(torch, failures, label, fast, plain, x_shape, ws, dname))
                if route == "phase" and xs[-1] == 5:  # the texture's e_conv1: its dgrad alone
                    rows.append(rewrite_row(
                        torch, failures, f"{fam} phase_dgrad {list(x_shape)} @ {list(ws)}",
                        lambda x, w, s=stride: phase_conv.phase_dgrad_conv3d(x, w, s),
                        lambda x, w, s=stride: layers._plain_conv(x, w, s, 3),
                        x_shape, ws, dname, grads="x"))
    reached = any(r[-1] == "depth_pack" for recs in routes.values() for r in recs)
    if not reached:
        log("depth_pack: route unreached on the card: K2 takes every stride-1 odd-kernel 3D "
            "conv of the three families (DEPTH_PACK on, K2 checked first)")
        for dname, b in (("bfloat16", 24), ("float32", 8)):
            xs, ws = X3[b], (3, 3, 3, 32, 32)
            f = layers._depth_pack_factor(xs, ws, (1, 1, 1))
            row = rewrite_row(torch, failures, f"res1 depth_pack f={f} (K2 off) {list(xs)}",
                              lambda x, w, f=f: layers._depth_packed_conv(x, w, f),
                              lambda x, w: layers._plain_conv(x, w, (1, 1, 1), 3), xs, ws, dname)
            x = torch.randn(xs, device="cuda").to(getattr(torch, dname)).requires_grad_()
            w = torch.randn(ws, device="cuda").to(x.dtype).requires_grad_()
            g = torch.randn(xs[:-1] + (32,), device="cuda").to(x.dtype)
            row["k2_ms"] = time_ms(torch, lambda: torch.autograd.grad(
                cuda_conv3d.nc_conv3d(x, w), (x, w), g), 5)
            log("depth_pack_k2 " + json.dumps({"dtype": dname, "x": list(xs),
                                               "k2_ms": row["k2_ms"]}))
            rows.append(row)
            del x, w, g
    return rows, reached


FROZEN_LOAD = r"""
import json, sys, time
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from rendernet_tpu_torch.compat.frozen import load_frozen
mod = load_frozen(sys.argv[1])  # the card by default
data = np.load(sys.argv[2])
vox, pose = (torch.from_numpy(data[k]).cuda() for k in ("vox", "pose"))
with torch.no_grad():
    out = mod(vox, pose)
    torch.cuda.synchronize()
    for _ in range(2):
        mod(vox, pose)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        mod(vox, pose)
    b.record()
    b.synchronize()
np.save(sys.argv[3], out.float().cpu().numpy())
print(json.dumps({"models_imported": sorted(m for m in sys.modules
                                            if m.startswith("rendernet_tpu_torch.models")),
                  "platforms": list(mod.platforms), "in_shapes": mod.in_shapes,
                  "device": str(out.device), "ms": a.elapsed_time(b) / 5}))
"""


def run_frozen(torch, failures, tmp):
    """(c) ``freeze_shader_render`` of a seeded ``ShaderConfig()`` (batch
    1, checked on the card), loaded in a fresh process that imports no model
    code, against the live exact fp32 forward (FROZEN_TOL), both timed;
    then the render CLI with ``--frozen`` and with the reference directory
    ``convert npz-to-refdir`` writes, each image against the flat-npz
    render's."""
    import numpy as np

    from rendernet_tpu_torch.cli.__main__ import main as cli_main
    from rendernet_tpu_torch.compat.frozen import freeze_shader_render, save_frozen
    from rendernet_tpu_torch.io.binvox import save_binvox
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward
    from rendernet_tpu_torch.train.checkpoint import save_params_npz
    from rendernet_tpu_torch.utils.image import decode_image

    net = init_shader_params(0, ShaderConfig(), device="cuda")
    npz, art = os.path.join(tmp, "shader.npz"), os.path.join(tmp, "shader.pt2")
    save_params_npz(npz, net)
    t0 = time.perf_counter()
    frozen = freeze_shader_render(net, batch=1, platforms=("cuda",))
    save_frozen(frozen, art)
    out = {"freeze_s": time.perf_counter() - t0, "artifact_mib": os.path.getsize(art) / 2 ** 20}
    del frozen
    rng = np.random.default_rng(5)
    vox = procedural_voxel().astype(np.float32)[None, :, :, :, None]
    pose = np.array([[rng.uniform(0, 6.28), rng.uniform(-1, 1), 1.0]], np.float32)
    np.savez(os.path.join(tmp, "in.npz"), vox=vox, pose=pose)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", FROZEN_LOAD, art, os.path.join(tmp, "in.npz"),
                           os.path.join(tmp, "out.npy")], capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
                              __file__))), timeout=600)
    out["load_process_s"] = time.perf_counter() - t0
    if proc.returncode != 0:
        failures.append(f"frozen load process failed: {proc.stderr[-2000:]}")
        return out
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    frozen_img = np.load(os.path.join(tmp, "out.npy"))
    v, q = torch.from_numpy(vox).cuda(), torch.from_numpy(pose).cuda()
    with torch.no_grad():
        live = shader_forward(net, v, q, resample="exact").float().cpu().numpy()
        live_ms = time_ms(torch, lambda: shader_forward(net, v, q, resample="exact"), 5)
    err = float(np.abs(frozen_img - live).max())
    out.update(frozen=info, frozen_ms=info["ms"], live_ms=live_ms, max_abs_err=err,
               tol=FROZEN_TOL, output_spread=float(live.max() - live.min()))
    if (info["models_imported"] or info["platforms"] != ["cuda"]
            or not info["device"].startswith("cuda") or frozen_img.shape != (1, 512, 512, 1)):
        failures.append(f"frozen artifact: load process {info}")
    if not err <= FROZEN_TOL:
        failures.append(f"frozen artifact differs from the live exact forward by {err:.3e}")
    del net
    torch.cuda.empty_cache()

    vox_path = os.path.join(tmp, "sphere_box.binvox")
    save_binvox(procedural_voxel(), vox_path)
    refdir = os.path.join(tmp, "refdir")
    rc_ref = cli_main(["convert", "npz-to-refdir", npz, refdir])
    images, rcs = {}, {"npz-to-refdir": rc_ref}
    for tag, extra in (("npz", ["--weights", npz]), ("refdir", ["--weights", refdir]),
                       ("frozen", ["--frozen", art])):
        rdir = os.path.join(tmp, f"render_{tag}")
        rcs[tag] = cli_main(["render", "--voxel_path", vox_path, "--render_dir", rdir,
                             "--out_channels", "1", *extra])
        names = sorted(os.listdir(rdir))
        with open(os.path.join(rdir, names[0]), "rb") as f:
            images[tag] = decode_image(f.read()).astype(np.int16)
    diffs = {t: int(np.abs(images[t] - images["npz"]).max()) for t in ("refdir", "frozen")}
    out["cli"] = {"rcs": rcs, "max_abs_level_diff": diffs,
                  "npz_image_spread": int(images["npz"].max() - images["npz"].min())}
    log("frozen " + json.dumps(out))
    # the weight directory holds the same fp32 values: the same image; the
    # frozen program may round a pixel to the next of 255 levels
    if any(rcs.values()) or diffs["refdir"] != 0 or diffs["frozen"] > 1:
        failures.append(f"render CLI with --weights <refdir> / --frozen: {out['cli']}")
    return out


def run_rewrites(torch, failures, tmp):
    """Phase 9: (a) the rewrite rows, (c) the frozen artifact and its CLIs;
    (b), the PHASE_CONV3D A/B, runs inside phases 4 and 7 on their
    states."""
    import numpy as np

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows, reached = rewrite_rows(torch, failures, model_routes(torch, np))
    log(f"phase 9 rewrites took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    frozen = run_frozen(torch, failures, tmp)
    log(f"phase 9 frozen took {time.perf_counter() - t0:.1f} s")
    return {"rows": len(rows), "depth_pack_reached": reached, "frozen": frozen}


# ---------------------------------------------------------------------------
# phase 10: data parallelism (train/distributed.py)
# ---------------------------------------------------------------------------
DIST_STEPS = 2
# The two-process CLI: global batch 16 (8 per rank) on phase 8's 24 images,
# so each rank's 12 entries make one batch and a padded tail: one epoch is 2
# steps, and the run ends there (checkpoint and params_final.npz).
DIST_CLI_BATCH = 16


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def recording(tx, sink: list):
    """``tx`` whose update, and in-place apply where it has one, append (a
    clone of) the gradients they are given to ``sink``: on a data-parallel
    step, the all-reduced ones. The step still takes ``tx``'s fused
    update."""
    from rendernet_tpu_torch.train.optim import GradientTransformation

    def record(fn):
        def run(grads, state, params):
            sink.append({k: g.detach().clone() for k, g in grads.items()})
            return fn(grads, state, params)

        return run

    return GradientTransformation(tx.init, record(tx.update),
                                  None if tx.apply is None else record(tx.apply))


def bench_config(dtype="float32"):
    """bench.py's training configuration (batch 24, bf16, bf16 moments,
    patch 128 from the step) with the all-reduce dtype ``dtype``."""
    from rendernet_tpu_torch.train.config import TrainConfig

    return TrainConfig(batch_size=24, img_res=512, new_size=128, compute_dtype="bfloat16",
                       is_greyscale=True, e_eta=1e-5, moment_dtype="bfloat16",
                       allreduce_dtype=dtype)


def fresh_states(torch, create, mcfg, cfg, prepare=None):
    """(net, tx, fresh()): ``fresh()`` resets the seeded network (after
    ``prepare(net)``, where given) to its initial values and returns a new
    TrainState (fresh optimizer state)."""
    from rendernet_tpu_torch.train.steps import TrainState

    state, tx = create(0, mcfg, cfg, device="cuda")
    net = state.params
    if prepare is not None:
        prepare(net)
    init = {k: v.clone() for k, v in net.state_dict().items()}

    def fresh():
        net.load_state_dict(init)
        return TrainState(net, tx.init(dict(net.named_parameters())), 0)

    return net, tx, fresh


def stepped(torch, step, state, batch, n):
    """``n`` steps; (state, losses, step ms from CUDA events between the
    steps, params after each step as clones)."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    marks[0].record()
    losses, params = [], []
    for i in range(n):
        state, loss = step(state, *batch, 1)
        marks[i + 1].record()
        losses.append(loss)
        params.append({k: p.detach().clone() for k, p in state.params.named_parameters()})
    torch.cuda.synchronize()
    return (state, [float(x) for x in losses], [a.elapsed_time(b) for a, b in zip(marks, marks[1:])],
            params)


def allreduce_ms(torch, grads, mesh, dtype, reps=5):
    """The all-reduce's own time (``all_reduce_mean`` on the step's
    gradients), CUDA events, after a warm-up; and its result."""
    from rendernet_tpu_torch.train import distributed

    tensors = list(grads.values())
    out = distributed.all_reduce_mean(tensors, mesh, dtype)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        distributed.all_reduce_mean(tensors, mesh, dtype)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def adam_step_apart(a: dict, b: dict, lr: float):
    """(max |a - b| over every parameter, whether every value lies within
    the bound of two Adam first steps from one start): each step moves a
    value by lr * m / (sqrt(v) + eps) = +-lr in exact arithmetic (the
    moments are fresh fp32 values, whatever their storage), so two runs
    whose gradients differ in sign lie 2 lr apart; allowed on top, the fp32
    rounding of the update (a few ulps of lr) and of each stored value
    (2^-24 of it, per side)."""
    dev, within = 0.0, True
    for k in b:
        x, y = a[k].float(), b[k].float()
        d = (x - y).abs()
        dev = max(dev, float(d.max()))
        within &= bool((d <= 2 * lr * (1 + 2 ** -20) + 2 ** -23 * (x.abs() + y.abs())).all())
    return dev, within


def dist_world1(torch, np, failures, tmp):
    """(a) NCCL at world size 1: the bench configuration's step built with a
    mesh, fp32 and bf16 all-reduce, against the step without one; the
    all-reduce on the step's gradients, timed; the texture step likewise.
    Saves the plain step's first gradients and params (the world-1 batch-24
    reference of (b)) to ``tmp``/ref.pt."""
    import dataclasses

    import torch.distributed as tdist

    from rendernet_tpu_torch.graft_entry import entry
    from rendernet_tpu_torch.models.shader import ShaderConfig
    from rendernet_tpu_torch.models.texture_face import TextureFaceConfig
    from rendernet_tpu_torch.train import distributed
    from rendernet_tpu_torch.train.steps import (
        create_shader_state,
        create_texture_state,
        make_shader_train_step,
        make_texture_train_step,
    )

    out = {}
    joined = distributed.initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    # bit-equality of two runs needs cuDNN's deterministic algorithms
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        out["backend"] = tdist.get_backend()
        if not joined or out["backend"] != "nccl":
            failures.append(f"phase 10 (a): joined {joined}, backend {out['backend']}")
        mesh = distributed.make_mesh()
        mcfg = ShaderConfig(preact_policy=True)
        batch = bench_batch(torch, np, 24)
        net, tx, fresh = fresh_states(torch, create_shader_state, mcfg, bench_config())
        out["params"] = sum(p.numel() for p in net.parameters())
        out["gradient_bytes"] = {d: distributed.gradient_bytes(net, getattr(torch, d))
                                 for d in ("float32", "bfloat16")}
        warm = make_shader_train_step(mcfg, bench_config(), tx, 128)
        warm(fresh(), *batch, 1)  # warm-up (cuDNN's deterministic algorithms, caches)
        runs = {}
        for name, dtype, m in (("plain", "float32", None), ("mesh_fp32", "float32", mesh),
                               ("mesh_bf16", "bfloat16", mesh)):
            grads = []
            step = make_shader_train_step(mcfg, bench_config(dtype), recording(tx, grads), 128,
                                          mesh=m)
            reset_counts()
            _, losses, ms, params = stepped(torch, step, fresh(), batch, DIST_STEPS)
            _, by_shape = read_counts()
            check_step_counts(failures, f"phase 10 (a) {name} steps", by_shape, DIST_STEPS,
                              {**step_launches(24, 128), **adam_launches(net)})
            runs[name] = {"losses": losses, "step_ms": ms, "params": params, "grads": grads}
        ref = runs["plain"]
        torch.save({"grads": {k: g.cpu() for k, g in ref["grads"][0].items()},
                    "params": {k: p.cpu() for k, p in ref["params"][0].items()},
                    "loss": ref["losses"][0]}, os.path.join(tmp, "ref.pt"))
        res = {}
        for name in ("mesh_fp32", "mesh_bf16"):
            r = runs[name]
            equal = [all(torch.equal(a[k], b[k]) for k in b)
                     for a, b in zip(r["params"], ref["params"])]
            res[name] = {"losses": r["losses"], "step_ms": r["step_ms"],
                         "loss_equal": r["losses"] == ref["losses"], "params_equal": equal,
                         "step1_apart": adam_step_apart(r["params"][0], ref["params"][0],
                                                        bench_config().e_eta)}
        out["shader"] = {"plain": {"losses": ref["losses"], "step_ms": ref["step_ms"]}, **res}
        if not (res["mesh_fp32"]["loss_equal"] and all(res["mesh_fp32"]["params_equal"])):
            failures.append(f"phase 10 (a): the fp32 all-reduce step differs from the plain "
                            f"one: {res['mesh_fp32']}")
        if not (res["mesh_bf16"]["losses"][0] == ref["losses"][0]
                and res["mesh_bf16"]["step1_apart"][1]):
            failures.append(f"phase 10 (a): the bf16 all-reduce step: {res['mesh_bf16']}")
        # the all-reduce itself on the first step's gradients (world 1: a sum
        # over one rank, so the fp32 result is its input and the bf16 one its
        # rounding)
        g = ref["grads"][0]
        out["allreduce"] = {}
        for dname in ("float32", "bfloat16"):
            dtype = getattr(torch, dname)
            ms, red = allreduce_ms(torch, g, mesh, dtype)
            exact = all(torch.equal(r, t.to(dtype).float()) for r, t in zip(red, g.values()))
            out["allreduce"][dname] = {"ms": ms, "bytes": out["gradient_bytes"][dname],
                                       "exact": exact}
            if not exact:
                failures.append(f"phase 10 (a): NCCL's world-1 all-reduce ({dname}) changed "
                                "the gradients")
        del runs, ref, g, red, net, fresh
        gc.collect()
        torch.cuda.empty_cache()

        # one texture step with and without a mesh
        tcfg = dataclasses.replace(bench_config(), is_greyscale=False, resample="multipass")
        tm = TextureFaceConfig()
        tbatch = texture_batch(torch, np, 24, seed=2)
        tnet, ttx, tfresh = fresh_states(torch, create_texture_state, tm, tcfg)
        out["texture_gradient_bytes"] = distributed.gradient_bytes(tnet)
        make_texture_train_step(tm, tcfg, ttx, 128)(tfresh(), *tbatch, 1)  # warm-up
        tex = {}
        for name, m in (("plain", None), ("mesh_fp32", mesh)):
            step = make_texture_train_step(tm, tcfg, ttx, 128, mesh=m)
            reset_counts()
            _, losses, ms, params = stepped(torch, step, tfresh(), tbatch, 1)
            _, by_shape = read_counts()
            check_step_counts(failures, f"phase 10 (a) texture {name} step", by_shape, 1,
                              {**texture_step_launches(24, 128), **adam_launches(tnet)})
            tex[name] = (losses, ms, params[0])
        equal = (tex["plain"][0] == tex["mesh_fp32"][0]
                 and all(torch.equal(tex["plain"][2][k], tex["mesh_fp32"][2][k])
                         for k in tex["plain"][2]))
        out["texture"] = {"losses": tex["plain"][0], "step_ms": tex["plain"][1],
                          "mesh_step_ms": tex["mesh_fp32"][1], "equal": equal}
        if not equal:
            failures.append("phase 10 (a): the texture step with a mesh differs from the plain one")
        del tex, tnet, tfresh
        # graft_entry's forward on the card
        fn, args = entry()
        img = fn(*args)
        out["entry"] = {"shape": list(img.shape), "finite": bool(torch.isfinite(img).all())}
        if img.shape != (1, 512, 512, 1) or not out["entry"]["finite"]:
            failures.append(f"phase 10 (a): graft_entry.entry(): {out['entry']}")
        del fn, args, img
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
        if joined:
            tdist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    log("dist_world1 " + json.dumps(out))
    return out


def dist_rank(rank: int, tmp: str) -> None:
    """(b) One rank of two on the one card (gloo): the bench configuration
    at local batch 12, DIST_STEPS steps with each all-reduce dtype; writes
    ``tmp``/rank{rank}.json."""
    import numpy as np
    import torch

    from rendernet_tpu_torch.models.shader import ShaderConfig
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.train import distributed
    from rendernet_tpu_torch.train.steps import create_shader_state, make_shader_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    layers.WINOGRAD_2D = "pallas"
    failures, out = [], {"rank": rank}
    distributed.initialize_multihost(f"file://{tmp}/init", 2, rank)
    try:
        out["backend"] = torch.distributed.get_backend()
        out["device"] = str(distributed.rank_device())
        mesh = distributed.make_mesh()
        ref = torch.load(os.path.join(tmp, "ref.pt"), map_location="cpu", weights_only=True)
        mcfg = ShaderConfig(preact_policy=True)
        local, _, n = distributed.process_shard(24)
        batch = distributed.shard_batch(mesh, tuple(
            a[rank * local:(rank + 1) * local] for a in bench_batch(torch, np, 24)))
        net, tx, fresh = fresh_states(torch, create_shader_state, mcfg, bench_config())
        for dname in ("float32", "bfloat16"):
            grads = []
            state = distributed.replicate(mesh, fresh())
            step = make_shader_train_step(mcfg, bench_config(dname), recording(tx, grads), 128,
                                          mesh=mesh)
            reset_counts()
            res = {"losses": [], "step_wall_ms": [], "ranks_equal": []}
            marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
                     for _ in range(DIST_STEPS)]
            for i in range(DIST_STEPS):
                t0 = time.perf_counter()
                marks[i][0].record()
                state, loss = step(state, *batch, 1)
                marks[i][1].record()
                res["losses"].append(float(loss))
                res["step_wall_ms"].append((time.perf_counter() - t0) * 1e3)
                sums = [zlib.crc32(p.detach().reshape(-1).view(torch.uint8).cpu().numpy())
                        for p in net.parameters()]
                every = [None] * n
                torch.distributed.all_gather_object(every, sums)
                res["ranks_equal"].append(all(s == every[0] for s in every))
                if i == 0:
                    g = grads[0]
                    errs = {k: float((g[k].float().cpu() - ref["grads"][k]).abs().max())
                            / float(ref["grads"][k].abs().max()) for k in ref["grads"]}
                    worst = max(errs, key=errs.get)
                    res["grad_worst"] = [worst, errs[worst]]
                    res["step1_apart"] = adam_step_apart(
                        {k: p.detach().cpu() for k, p in net.named_parameters()},
                        ref["params"], bench_config().e_eta)
                    res["loss1_vs_world1"] = [res["losses"][0], ref["loss"]]
            torch.cuda.synchronize()
            res["step_ms"] = [a.elapsed_time(b) for a, b in marks]
            _, by_shape = read_counts()
            check_step_counts(failures, f"rank {rank} {dname} steps", by_shape, DIST_STEPS,
                              {**step_launches(local, 128), **adam_launches(net)})
            res["allreduce_ms"], _ = allreduce_ms(torch, grads[-1], mesh, getattr(torch, dname),
                                                  reps=2)
            out[dname] = res
            if not all(res["ranks_equal"]):
                failures.append(f"rank {rank} {dname}: the ranks' params differ: {res}")
            if res["grad_worst"][1] > GRAD_TOL["bfloat16"]:
                failures.append(f"rank {rank} {dname}: all-reduced gradients vs world 1's: "
                                f"{res['grad_worst']} > {GRAD_TOL['bfloat16']}")
            if not res["step1_apart"][1]:
                failures.append(f"rank {rank} {dname}: params after step 1 "
                                f"{res['step1_apart'][0]} from world 1's, beyond 2 e_eta")
            del grads, state
    except Exception as e:  # the rank's failure, reported through its file
        failures.append(f"rank {rank}: {e!r}")
        raise
    finally:
        out["failures"] = failures
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        torch.distributed.destroy_process_group()


CLI_RANK = r"""
import json, sys
from rendernet_tpu_torch.cli.__main__ import main
from rendernet_tpu_torch.data import loaders
from rendernet_tpu_torch.nn import layers

entries, read = loaders._entries, []


def recording(img_path, shard):
    for img, name in entries(img_path, shard):
        read.append(name)
        yield img, name


loaders._entries = recording
layers.WINOGRAD_2D = "pallas"
rc = main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump({"rc": rc, "read": read}, f)
sys.exit(rc)
"""


def dist_cli(torch, failures, cli_data, tmp):
    """(c) ``train-shader`` as two processes on the card (``--coordinator
    127.0.0.1:<port> --num-processes 2 --process-id i``), each with its own
    run dir in its config; then the run resumed in this process."""
    from rendernet_tpu_torch.cli.__main__ import main as cli_main

    port = free_port()
    procs, outs = [], []
    for rank in (0, 1):
        cfg_path = os.path.join(tmp, f"dist{rank}.json")
        with open(cfg_path, "w") as f:
            json.dump({"image_path": cli_data["tar"], "model_path": cli_data["model_dir"],
                       "batch_size": DIST_CLI_BATCH, "img_res": 512, "new_size": 128,
                       "compute_dtype": "bfloat16", "resample": "multipass",
                       "moment_dtype": "bfloat16", "max_epochs": 1,
                       "sample_save": os.path.join(tmp, f"dist_run{rank}"),
                       "sample_every_steps": 1, "checkpoint_secs": 100000, "e_eta": 1e-5}, f)
        outs.append(os.path.join(tmp, f"dist_cli{rank}.json"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", CLI_RANK, outs[-1], "train-shader", cfg_path,
             "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
             "--process-id", str(rank)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    t0 = time.perf_counter()
    try:
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    res = {"rcs": [p.returncode for p in procs], "s": time.perf_counter() - t0}
    run0, run1 = (os.path.join(tmp, f"dist_run{r}") for r in (0, 1))
    read = []
    for path in outs:
        if os.path.exists(path):
            with open(path) as f:
                read.append(json.load(f)["read"])
        else:
            read.append(None)
    res["files"] = sorted(os.listdir(run0)) if os.path.exists(run0) else None
    res["rank1_dir"] = os.path.exists(run1)
    res["read"] = [len(r) if r is not None else None for r in read]
    res["disjoint"] = bool(read[0] and read[1] and not set(read[0]) & set(read[1])
                           and len(set(read[0]) | set(read[1])) == 24)
    if res["rcs"] != [0, 0] or res["rank1_dir"] or not res["disjoint"] or res["files"] is None \
            or not {"3d2d_renderer", "params_final.npz", "metrics.jsonl"} <= set(res["files"]):
        failures.append(f"phase 10 (c): the two-process CLI: {res}; stderr tails: "
                        f"{[lg[1][-3000:] for lg in logs]}")
    # the third run: resumed at step 2 in this process, stops at step 3
    reset_counts()
    t0 = time.perf_counter()
    rc = cli_main(["train-shader", os.path.join(tmp, "dist0.json"), "--max-steps", "3"])
    torch.cuda.synchronize()
    res["resume"] = {"rc": rc, "s": time.perf_counter() - t0}
    with open(os.path.join(run0, "metrics.jsonl")) as f:
        metrics = [json.loads(line) for line in f]
    res["metrics"] = metrics
    if rc != 0 or {"resumed_at_step": 2} not in metrics or not any(
            m.get("step") == 3 for m in metrics):
        failures.append(f"phase 10 (c): the resumed run: rc {rc}, metrics {metrics}")
    log("dist_cli " + json.dumps(res))
    return res


def run_distributed(torch, failures, cli_data, tmp):
    """Phase 10: (a) NCCL at world size 1, (b) two gloo ranks on the card,
    (c) the two-process CLI."""
    import numpy as np

    from rendernet_tpu_torch.nn import layers

    out = {}
    layers.WINOGRAD_2D = "pallas"  # bench.py's configuration: the 2D stacks on K3
    try:
        for name, run in (("world1", lambda: dist_world1(torch, np, failures, tmp)),
                          ("two_ranks", lambda: dist_two_ranks(torch, failures, tmp)),
                          ("cli", lambda: dist_cli(torch, failures, cli_data, tmp))):
            t0 = time.perf_counter()
            try:
                out[name] = run()
            except Exception as e:  # recorded as a failure; the next part still runs
                failures.append(f"phase 10 {name}: {e!r}")
            log(f"phase 10 {name} took {time.perf_counter() - t0:.1f} s")
    finally:
        layers.WINOGRAD_2D = False
    return out


def dist_two_ranks(torch, failures, tmp):
    """(b) Launch the two ranks (``dist_rank``) and read their results."""
    from rendernet_tpu_torch.train import distributed

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        distributed.launch(dist_rank, 2, (tmp,), timeout=400)
    finally:
        ranks = []
        for r in (0, 1):
            path = os.path.join(tmp, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
        for r in ranks:
            failures.extend(r["failures"])
        log("dist_two_ranks " + json.dumps({"s": time.perf_counter() - t0, "ranks": ranks}))
    if len(ranks) != 2:
        failures.append(f"phase 10 (b): {len(ranks)} rank results")
    return {"ranks": ranks}


# ---------------------------------------------------------------------------
# phase 11: spatial sharding (a model axis over the rows, halo exchanges)
# ---------------------------------------------------------------------------
SP_MODEL = 2  # the model axis: two gloo ranks sharing the one card
# The sharded bf16 step's loss against the world-1 step's, relative: both
# sum the same 8 x 512^2 BCE terms in fp32 from bf16 logits, which differ
# where the slab's ops round in another order or cuDNN picks another
# algorithm for the slab's shape (a few bf16 ulps of some logits). Read at
# 2.6e-7 on an H100; JAX's own sharded step is held to 1e-5 of the
# unsharded. (d)'s forward fault (the neighbours' halo rows read as zeros)
# must land above it.
SP_LOSS_TOL = 1e-5
SP_TIMED = 3  # timed calls of each sharded run (a fixed count: every rank calls alike)


def slab_warp(bc, rank, m=SP_MODEL, patch=128, n=128):
    """K1's passes of one multipass warp of a ``patch``-row patch to rank
    ``rank``'s camera rows: the 6 passes on the whole ``n``^3 grid, the last
    y pass emitting the slab's rows with e_conv1's halo (2, 2) clipped to
    the patch, and the z pass on those rows. Returns (the K1 launches by
    key, the window's rows)."""
    rows = patch // m
    win = min((rank + 1) * rows + 2, patch) - max(rank * rows - 2, 0)
    return {(bc, n * n, n, n): 6, (bc, n * n, n, win): 1, (bc, n * win, n, patch): 1}, win


def slab_adjoint(bc, win, n=128):
    """K4's adjoints of :func:`slab_warp`'s passes: five 3-tap shears and the
    x scale pass on the whole grid, the y and z scale passes (6 taps) on
    the window's shapes."""
    return {(bc, n * n, n, n, 3): 5, (bc, n * n, n, n, 6): 1, (bc, n * n, n, win, 6): 1,
            (bc, n * win, n, n, 6): 1}


def sharded_launches(b, patch, rank, m=SP_MODEL, grad=False):
    """Launches per batch-``b`` forward (``grad``: per training step, as
    :func:`step_launches` with preact_policy) on rank ``rank`` of a model
    axis of ``m`` at full width: the warp's 8 K1 passes, the last y pass
    emitting the rank's camera rows with e_conv1's halo (2, 2) clipped to
    the patch and the z pass on those rows (:func:`slab_warp`); every
    3x3x3 conv on the slab extended by one row each side (K2, K2w), every
    Winograd conv by two (whole 2-row tiles)."""
    k1, _ = slab_warp(b, rank, m, patch)
    s = patch // 2
    h3, h2 = s // m + 2, s // m + 4
    x16, x32 = (b, h3, s, 32, 16), (b, h3, s, 32, 32)
    r2, r3 = (b, h2, s, 1024), (b, h2, s, 512)
    g = 2 if grad else 1
    out = {"K1": k1, "K4": {}, "K2": {(x16, 32): 1, (x32, 32): 21 * g},
           "K2w": {}, "K3": {(r2, 1024): 21 * g, (r3, 512): 11 * g}, "K6": {}, "K5": {},
           "K5w": {}}
    if grad:
        out["K2"][(x32, 16)] = 1
        out["K2w"] = {(x16, 32): 1, (x32, 32): 21}
    return out


def sp_state(torch):
    """(net, tx, fresh()) of bench.py's patch-128 configuration at full
    width with preact_policy, the PReLU alphas spread as phase 4's
    (:func:`fresh_states`)."""
    from rendernet_tpu_torch.models.shader import ShaderConfig
    from rendernet_tpu_torch.train.steps import create_shader_state

    return fresh_states(torch, create_shader_state, ShaderConfig(preact_policy=True),
                        bench_config(), prepare=lambda net: spread_alphas(torch, net))


def fixed_ms(torch, fn, n=SP_TIMED):
    """ms per call of ``fn`` over ``n`` calls after one warm-up call, CUDA
    events (a fixed count, so that ranks running collectives call alike)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def sp_steps(torch, step, state, batch, n):
    """``n`` steps; (state, losses, each step's ms from CUDA events, and of
    the first step: its peak device memory, that peak less the memory held
    before the step, and the activations it holds for the backward: the
    memory allocated when the head (e_conv11) returns, less that before)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    held = []
    hook = state.params.encoder["e_conv11"].register_forward_hook(
        lambda *args: held.append(torch.cuda.memory_allocated()))
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    marks[0].record()
    losses, peak = [], None
    try:
        for i in range(n):
            state, loss = step(state, *batch, 1)
            marks[i + 1].record()
            losses.append(loss)
            if peak is None:
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
    finally:
        hook.remove()
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    mem = {"peak_bytes": peak, "added_bytes": peak - before, "activation_bytes": held[0] - before}
    return state, [float(x) for x in losses], ms, mem


def sp_world1(torch, np, failures, tmp):
    """The world-1 references of (a) and (b), in this process: the bf16
    multipass forward at batch 8 (``--fast``) with its logits, ms and peak
    memory; one step of the patch-128 configuration at batch 8 on the
    gradient check's inputs with its loss, gradients, ms and peak memory.
    Saves the logits, loss and gradients to ``tmp``/sp_ref.pt."""
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward
    from rendernet_tpu_torch.train.steps import make_shader_train_step

    out = {}
    net = init_shader_params(0, ShaderConfig(), device="cuda")
    vox, pose = serve_inputs(torch, np)
    logits = []
    hook = net.encoder["e_conv11"].register_forward_hook(
        lambda mod, args, y: logits.append(y.float()))

    def fwd():
        return shader_forward(net, vox, pose, compute_dtype=torch.bfloat16, resample="multipass")

    with torch.no_grad():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fwd()
        torch.cuda.synchronize()
        out["forward_peak_bytes"] = torch.cuda.max_memory_allocated()
        out["forward_added_bytes"] = out["forward_peak_bytes"] - before
        ref_logits = logits.pop()
        out["forward_ms"] = fixed_ms(torch, fwd)
    hook.remove()
    del net, logits
    gc.collect()
    torch.cuda.empty_cache()
    net, tx, fresh = sp_state(torch)
    grads = []
    step = make_shader_train_step(net.cfg, bench_config(), recording(tx, grads), 128)
    batch = grad_inputs(torch, np)
    step(fresh(), *batch, 1)  # warm-up
    grads.clear()
    _, losses, ms, out["step_memory"] = sp_steps(torch, step, fresh(), batch, 1)
    out["loss"], out["step_ms"] = losses[0], ms[0]
    torch.save({"logits": ref_logits.cpu(), "loss": losses[0],
                "grads": {k: g.float().cpu() for k, g in grads[0].items()}},
               os.path.join(tmp, "sp_ref.pt"))
    del net, tx, fresh, grads, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp_grad_errors(torch, got, ref):
    """(worst parameter, its max |g - g_ref| / max |g_ref|) over every
    parameter, compared on the card."""
    errs = {}
    for k, r in ref.items():
        r = r.cuda()
        errs[k] = float((got[k].float() - r).abs().max()) / max(float(r.abs().max()), 1e-30)
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


class halo_forward_fault:
    """The planted fault of (d) that the loss check must reject: the halo
    exchange's forward reads the neighbours' rows as zeros (the exchange
    itself still runs, so that the ranks' collectives stay in step)."""

    def __enter__(self):
        from rendernet_tpu_torch.ops import halo

        self.saved = saved = halo._Exchange.forward

        def forward(ctx, x, lo, hi, shard, axis):
            y = saved(ctx, x, lo, hi, shard, axis)
            y.narrow(axis, 0, lo).zero_()
            y.narrow(axis, y.shape[axis] - hi, hi).zero_()
            return y

        halo._Exchange.forward = staticmethod(forward)

    def __exit__(self, *exc):
        from rendernet_tpu_torch.ops import halo

        halo._Exchange.forward = staticmethod(self.saved)


class halo_adjoint_fault:
    """The planted fault of (d) that the gradient check must reject: the
    halo exchange's backward drops the cotangent its neighbours send back
    (each rank keeps only its own)."""

    def __enter__(self):
        from rendernet_tpu_torch.ops import halo

        self.saved = halo._add_halo_cotangents
        halo._add_halo_cotangents = lambda gx, *args: gx

    def __exit__(self, *exc):
        from rendernet_tpu_torch.ops import halo

        halo._add_halo_cotangents = self.saved


def sp_rank(rank: int, tmp: str) -> None:
    """One rank of the 1 x 2 mesh (gloo, the one card): (a) the sharded bf16
    forward; (b) the sharded step, twice, and (d) the planted faults; writes
    ``tmp``/sp_rank{rank}.json and, on rank 0, the launches per forward
    and per step."""
    import numpy as np
    import torch

    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.ops import halo
    from rendernet_tpu_torch.train import distributed
    from rendernet_tpu_torch.train.steps import make_shader_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    layers.WINOGRAD_2D = "pallas"
    failures, out = [], {"rank": rank}
    per_run = {}
    distributed.initialize_multihost(f"file://{tmp}/sp_init", SP_MODEL, rank)
    try:
        out["backend"] = torch.distributed.get_backend()
        mesh = distributed.make_mesh(n_data=1, n_model=SP_MODEL)
        shard = distributed.spatial_sharding(mesh, 5)
        ref = torch.load(os.path.join(tmp, "sp_ref.pt"), map_location="cpu", weights_only=True)
        # (a) serving
        net = init_shader_params(0, ShaderConfig(), device="cuda")
        vox, pose = serve_inputs(torch, np)
        logits = []
        hook = net.encoder["e_conv11"].register_forward_hook(
            lambda mod, args, y: logits.append(y.float()))
        want = ref["logits"].cuda()
        spread = float(want.max() - want.min())

        def fwd():
            return shader_forward(net, shard.take(vox), pose, compute_dtype=torch.bfloat16,
                                  resample="multipass", mesh=mesh)

        with torch.no_grad():
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            img = fwd()
            torch.cuda.synchronize()
            _, by_shape = read_counts()
            peak = torch.cuda.max_memory_allocated()
            got = shard.gather(logits.pop())
            err = float((got - want).abs().max())
            out["serve"] = {"rows": list(img.shape), "logit_max_abs_err": err,
                            "logit_spread": spread, "rel_err": err / spread, "peak_bytes": peak,
                            "added_bytes": peak - before, "ms": fixed_ms(torch, fwd)}
            logits.clear()
        what = f"phase 11 (a) rank {rank}"
        per_run["sp_serve"] = check_step_counts(failures, what, by_shape, 1,
                                                sharded_launches(8, 128, rank))
        if not err <= FORWARD_TOL["bfloat16"] * spread:
            failures.append(f"{what}: logits {err:.3e} from the world-1 forward's, spread "
                            f"{spread:.3e} (tol {FORWARD_TOL['bfloat16']} of it)")
        if tuple(img.shape) != (8, 512 // SP_MODEL, 512, 1):
            failures.append(f"{what}: the rank's rows {tuple(img.shape)}")
        hook.remove()
        del net, logits, want, img, got
        gc.collect()
        torch.cuda.empty_cache()

        # (b) training, and (d) the planted fault
        net, tx, fresh = sp_state(torch)
        vox, img, pose = grad_inputs(torch, np)
        batch = (shard.take(vox), shard.take(img), pose)
        grads = []
        step = make_shader_train_step(net.cfg, bench_config(), recording(tx, grads), 128,
                                      mesh=mesh)
        step(fresh(), *batch, 1)  # warm-up
        grads.clear()
        reset_counts()
        halo.exchanges, halo.sent_bytes, halo.received_bytes = 0, 0, 0
        state, losses, ms, mem = sp_steps(torch, step, fresh(), batch, 2)
        _, by_shape = read_counts()
        train = {"losses": losses, "step_ms": ms, "memory": mem,
                 "halo_exchanges": halo.exchanges // 2, "halo_sent_bytes": halo.sent_bytes // 2,
                 "halo_received_bytes": halo.received_bytes // 2}
        per_run["sp_train"] = check_step_counts(
            failures, f"phase 11 (b) rank {rank} steps", by_shape, 2,
            {**sharded_launches(8, 128, rank, grad=True), **adam_launches(net)})
        train["loss_rel_err"] = abs(losses[0] - ref["loss"]) / abs(ref["loss"])
        train["grad_worst"] = sp_grad_errors(torch, grads[0], ref["grads"])
        sums = [zlib.crc32(p.detach().reshape(-1).view(torch.uint8).cpu().numpy())
                for p in net.parameters()]
        every = [None] * SP_MODEL
        torch.distributed.all_gather_object(every, sums)
        train["ranks_equal"] = all(s == every[0] for s in every)
        grads.clear()
        with halo_adjoint_fault():
            step(fresh(), *batch, 1)
        train["fault_grad_worst"] = sp_grad_errors(torch, grads[0], ref["grads"])
        with halo_forward_fault():
            _, loss = step(fresh(), *batch, 1)
        train["fault_loss_rel_err"] = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
        out["train"] = train
        what = f"phase 11 (b) rank {rank}"
        if not train["loss_rel_err"] <= SP_LOSS_TOL:
            failures.append(f"{what}: loss {losses[0]} vs world 1's {ref['loss']}")
        if not train["grad_worst"][1] <= GRAD_TOL["bfloat16"]:
            failures.append(f"{what}: model-summed gradients vs world 1's: {train['grad_worst']} "
                            f"> {GRAD_TOL['bfloat16']}")
        if not train["ranks_equal"]:
            failures.append(f"{what}: the ranks' params differ after 2 steps")
        if train["fault_grad_worst"][1] <= GRAD_TOL["bfloat16"]:
            failures.append(f"phase 11 (d) rank {rank}: the gradient check passed the planted "
                            f"fault (the halo adjoint's add dropped): {train['fault_grad_worst']}")
        if train["fault_loss_rel_err"] <= SP_LOSS_TOL:
            failures.append(f"phase 11 (d) rank {rank}: the loss check passed the planted fault "
                            f"(the halo rows read as zeros): {train['fault_loss_rel_err']:.3e}")
        if rank == 0:
            out["per_run"] = {run: {kid: [[list(k) if isinstance(k, tuple) else k, v]
                                          for k, v in c.items()] for kid, c in counts.items()}
                              for run, counts in per_run.items()}
    except Exception as e:  # the rank's failure, reported through its file
        failures.append(f"phase 11 rank {rank}: {e!r}")
        raise
    finally:
        out["failures"] = failures
        with open(os.path.join(tmp, f"sp_rank{rank}.json"), "w") as f:
            json.dump(out, f, default=str)
        torch.distributed.destroy_process_group()


def run_spatial(torch, failures, tmp):
    """Phase 11: the world-1 references, the two ranks (``sp_rank``), then
    the port's ``graft_entry.dryrun_multichip(4)`` on the card. Returns
    (the results, rank 0's launches per forward and per step by run)."""
    import numpy as np

    from rendernet_tpu_torch import graft_entry
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.train import distributed

    out, per_run = {}, {}
    t0 = time.perf_counter()
    layers.WINOGRAD_2D = "pallas"
    try:
        out["world1"] = sp_world1(torch, np, failures, tmp)
    finally:
        layers.WINOGRAD_2D = False
    out["world1_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = []
    try:
        distributed.launch(sp_rank, SP_MODEL, (tmp,), timeout=400)
    except Exception as e:  # recorded; the ranks' files say more
        failures.append(f"phase 11 ranks: {e!r}")
    finally:
        for r in range(SP_MODEL):
            path = os.path.join(tmp, f"sp_rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
    for r in ranks:
        failures.extend(r["failures"])
    if len(ranks) != SP_MODEL:
        failures.append(f"phase 11: {len(ranks)} rank results")
    out["ranks"] = ranks
    out["ranks_s"] = time.perf_counter() - t0
    for run, counts in (ranks[0].get("per_run", {}) if ranks else {}).items():
        per_run[run] = {kid: {tuple(tuple(x) if isinstance(x, list) else x for x in k)
                              if isinstance(k, list) else k: v for k, v in rows}
                        for kid, rows in counts.items()}
    t0 = time.perf_counter()
    try:
        out["dryrun4"] = graft_entry.dryrun_multichip(4)
    except Exception as e:
        failures.append(f"phase 11 (c) dryrun_multichip(4): {e!r}")
    out["dryrun4_s"] = time.perf_counter() - t0
    log("spatial " + json.dumps(out, default=str))
    return out, per_run


# ---------------------------------------------------------------------------
# phase 12: the texture step and inverse rendering under a model axis
# ---------------------------------------------------------------------------
SP_RECON_STEPS = 3  # sharded recon steps per dtype
SP_RECON_EPOCH_STEPS = 2  # inner steps of the one reconstruct epoch


def sharded_texture_launches(b, rank, m=SP_MODEL, grad=False):
    """Launches per texture forward (``grad``: per texture step) on rank
    ``rank`` of a model axis of ``m`` at ``TextureFaceConfig()``, patch 128:
    both warps to the rank's rows (:func:`slab_warp`; the shape grid at BC
    = b, the texture grid at 4b), K4 on the texture warp only
    (:func:`slab_adjoint`); e_conv3, the 20 res1 convs and res1_skip on K2
    at 16 -> 16 channels on the 3-D slab extended by a row each side (again
    for their data gradients; K2w once each); the 21 res2 (512) and 11 res3
    (256) convs on K3 on the 2-D slab extended by two rows each side."""
    s = 128 // 2
    k1s, win = slab_warp(b, rank, m)
    k1t, _ = slab_warp(4 * b, rank, m)
    x16 = (b, s // m + 2, s, 32, 16)
    r2, r3 = (b, s // m + 4, s, 512), (b, s // m + 4, s, 256)
    g = 2 if grad else 1
    return {"K1": {**k1s, **k1t}, "K4": slab_adjoint(4 * b, win) if grad else {},
            "K2": {(x16, 16): 22 * g}, "K2w": {(x16, 16): 22} if grad else {},
            "K3": {(r2, 512): 21 * g, (r3, 256): 11 * g}, "K6": {}, "K5": {}, "K5w": {}}


def sharded_recon_launches(rank, m=SP_MODEL):
    """Launches per inverse-rendering step at ``ReconConfig()`` on rank
    ``rank`` of a model axis of ``m``: both warps (BC 5 and 20) to the
    rank's rows and their adjoints (:func:`slab_warp`, :func:`slab_adjoint`);
    e_conv3, the 20 res1 convs and res1_skip on K2 at 16 -> 16 on the 3-D
    slab extended by a row each side, forward and data gradient (the
    networks are frozen: no K2w; batch 5 is outside K3's envelope)."""
    k1, k4 = {}, {}
    for bc in (5, 20):
        warp, win = slab_warp(bc, rank, m)
        k1.update(warp)
        k4.update(slab_adjoint(bc, win))
    xr = (5, 64 // m + 2, 64, 32, 16)
    return {"K1": k1, "K4": k4, "K2": {(xr, 16): 44}, "K2w": {}, "K3": {}, "K6": {}, "K5": {},
            "K5w": {}}


def sp_texture_config():
    """The sharded texture step's training configuration (batch 8, bf16,
    multipass, bf16 Adam moments, the RGB losses)."""
    from rendernet_tpu_torch.train.config import TrainConfig

    return TrainConfig(batch_size=8, img_res=512, new_size=128, compute_dtype="bfloat16",
                       is_greyscale=False, e_eta=1e-5, moment_dtype="bfloat16",
                       resample="multipass")


def sp_texture_state(torch):
    """(net, tx, fresh()) of the texture net of phase 7 (its alphas spread)."""
    from rendernet_tpu_torch.models.texture_face import TextureFaceConfig
    from rendernet_tpu_torch.train.steps import create_texture_state

    return fresh_states(torch, create_texture_state, TextureFaceConfig(), sp_texture_config(),
                        prepare=lambda net: spread_alphas(torch, net))


def texture_heads(net):
    """The two heads' last deconvs (their outputs are the logits)."""
    return [net.encoder["Image"]["e_conv10_1"]["conv2d_transpose"],
            net.encoder["Normal"]["e_conv10_2"]["e_conv10_2"]]


def held_memory(torch, module, fn):
    """(fn's result, {peak bytes, peak less the bytes held before, the
    activations held for the backward: the bytes allocated when ``module``
    (the last layer of the forward) returns, less those before})."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    held = []
    hook = module.register_forward_hook(lambda *a: held.append(torch.cuda.memory_allocated()))
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        hook.remove()
    peak = torch.cuda.max_memory_allocated()
    return out, {"peak_bytes": peak, "added_bytes": peak - before,
                 "activation_bytes": held[0] - before}


def sp_recon_run(torch, model, cfg, target, mesh=None, n=SP_RECON_STEPS):
    """``n`` single recon steps from the initial latents: {"losses": the
    per-sample losses per step, "latents" after the last step, "grads":
    step 1's latent gradients (with ``mesh``, as the step's model-axis sum
    returns them; else autograd's of the losses' sum at the initial
    latents), "ms" per step of steps 2..n (CUDA events), "memory" of step
    1}; all on the host."""
    from rendernet_tpu_torch.recon.inverse import (
        Latents,
        initial_latents,
        make_recon_step,
        recon_per_sample_loss,
    )
    from rendernet_tpu_torch.train import distributed

    lat = initial_latents(cfg, device="cuda")
    sums = []
    if mesh is None:
        leaves = [t.clone().requires_grad_() for t in lat]
        per = recon_per_sample_loss(model, Latents(*leaves), target, cfg)
        sums.append(torch.autograd.grad(per.sum(), leaves))
        del per, leaves
    else:
        model_sum = distributed.model_sum

        def recording(tensors, m):  # (losses, vector, pose, texture, light), summed
            out = model_sum(tensors, m)
            sums.append([t.clone() for t in out[1:]])
            return out

        distributed.model_sum = recording
    try:
        step = make_recon_step(model, cfg, mesh=mesh)
        head = model.renderer.encoder["Normal"]["e_conv11"]["e_conv11_2"]
        (lat, per), mem = held_memory(torch, head, lambda: step(lat, target))
        losses = [per]
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
        marks[0].record()
        for i in range(1, n):
            lat, per = step(lat, target)
            marks[i].record()
            losses.append(per)
        torch.cuda.synchronize()
    finally:
        if mesh is not None:
            distributed.model_sum = model_sum
    return {"losses": [p.cpu() for p in losses], "latents": [t.cpu() for t in lat],
            "grads": [g.cpu() for g in sums[0]],
            "ms": [a.elapsed_time(b) for a, b in zip(marks, marks[1:])], "memory": mem}


def sp_grad_rel(got, ref):
    """Per latent group, ||g - g_ref|| / ||g_ref|| (phase 5's measure)."""
    from rendernet_tpu_torch.recon.inverse import Latents

    return {n: float((a.double() - b.double()).norm() / b.double().norm())
            for n, a, b in zip(Latents._fields, got, ref)}


def sp_recon_model(torch):
    """The conditioned recon model (phase 5's gradient check's)."""
    model = conditioned_recon_model(torch)
    for net in model:
        net.requires_grad_(False)
    return model


def sp_recon_configs():
    from rendernet_tpu_torch.recon.inverse import ReconConfig

    return {dname: ReconConfig(compute_dtype=dname, light_elevation=RECON_LIGHT_ELEVATION,
                               resample="multipass")
            for dname in ("float32", "bfloat16")}


def sp12_world1_texture(torch, np, out, ref):
    """:func:`sp12_world1`'s texture part: fills ``out`` (times, memory) and
    ``ref`` (logits, loss, gradients)."""
    from rendernet_tpu_torch.models.texture_face import texture_face_forward
    from rendernet_tpu_torch.train.steps import make_texture_train_step

    net, tx, fresh = sp_texture_state(torch)
    fresh()
    vox, img, nrm, codes, pose = texture_batch(torch, np, 8, seed=1)
    logits = []
    hooks = [h.register_forward_hook(lambda mod, args, y: logits.append(y.float()))
             for h in texture_heads(net)]

    def fwd():
        return texture_face_forward(net, vox, codes, pose, compute_dtype=torch.bfloat16,
                                    resample="multipass")

    with torch.no_grad():
        _, out["forward_memory"] = held_memory(torch, texture_heads(net)[1], fwd)
        ref["logits"] = [t.cpu() for t in logits]
        logits.clear()
        out["forward_ms"] = fixed_ms(torch, fwd)
    for h in hooks:
        h.remove()
    del logits
    grads = []
    step = make_texture_train_step(net.cfg, sp_texture_config(), recording(tx, grads), 128)
    batch = (vox, img, nrm, codes, pose)
    step(fresh(), *batch, 1)  # warm-up
    grads.clear()
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    marks[0].record()
    (_, loss), out["step_memory"] = held_memory(torch, texture_heads(net)[1],
                                                lambda: step(fresh(), *batch, 1))
    marks[1].record()
    torch.cuda.synchronize()
    out["step_ms"] = marks[0].elapsed_time(marks[1])
    ref["loss"] = out["loss"] = float(loss)
    ref["grads"] = {k: g.float().cpu() for k, g in grads[0].items()}


def sp12_world1(torch, np, failures, tmp):
    """The world-1 references of phase 12 in this process: the texture
    forward (bf16, batch 8) with both heads' logits, ms and memory; one
    texture step at batch 8, patch 128 with its loss, gradients, ms and
    memory; per dtype SP_RECON_STEPS recon steps on the conditioned model
    (phase 5's) with their losses, latents, ms and memory, and one
    reconstruct epoch's best hypothesis. Saves what the ranks compare to
    ``tmp``/sp12_ref.pt."""
    import dataclasses

    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.recon.inverse import reconstruct

    out, ref = {}, {}
    layers.WINOGRAD_2D = "pallas"  # the texture net's 2D stacks on K3, as phase 7's
    try:
        sp12_world1_texture(torch, np, out, ref)
    finally:
        layers.WINOGRAD_2D = False
    gc.collect()
    torch.cuda.empty_cache()

    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model = sp_recon_model(torch)
        target = render_target(torch, model)[0].expand(5, -1, -1, -1).contiguous()
        ref["target"] = target.cpu()
        out["recon"] = {}
        for dname, cfg in sp_recon_configs().items():
            res = sp_recon_run(torch, model, cfg, target)
            ref[f"recon_{dname}"] = {k: res[k] for k in ("losses", "latents", "grads")}
            out["recon"][dname] = {"losses": [p.tolist() for p in res["losses"]],
                                   "step_ms": res["ms"], "memory": res["memory"],
                                   "grad_norm": [float(g.norm()) for g in res["grads"]]}
        cfg = dataclasses.replace(sp_recon_configs()["float32"],
                                  inner_steps=SP_RECON_EPOCH_STEPS, max_epochs=1)
        _, history, _ = reconstruct(model, target, cfg)
        ref["best"] = out["reconstruct_best"] = int(history[-1].argmin())
        out["reconstruct_losses"] = history[-1].tolist()
    finally:
        torch.backends.cudnn.deterministic = cudnn_det
    torch.save(ref, os.path.join(tmp, "sp12_ref.pt"))
    del model, target
    gc.collect()
    torch.cuda.empty_cache()
    return out


class grid_cotangent_fault:
    """The planted fault of phase 12 (a) that the decoder's gradient check
    must reject: the texture grid's cotangent also summed over the model
    axis (on top of the step's sum of the gradients), which counts the
    decoder's gradients once per rank."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        from rendernet_tpu_torch.train import distributed, steps

        self.saved = saved = steps.texture_decoder
        mesh = self.mesh

        def decoder(net, z):
            grid = saved(net, z)
            if grid.requires_grad:
                grid.register_hook(lambda g: distributed.model_sum([g], mesh)[0].to(g.dtype))
            return grid

        steps.texture_decoder = decoder

    def __exit__(self, *exc):
        from rendernet_tpu_torch.train import steps

        steps.texture_decoder = self.saved


class pose_sum_fault:
    """The planted fault of phase 12 (b) that the update check must reject:
    the recon step's pose gradient left out of the model-axis sum (each
    rank keeps its rows' partial gradient)."""

    def __enter__(self):
        from rendernet_tpu_torch.train import distributed

        self.saved = saved = distributed.model_sum

        def model_sum(tensors, mesh):
            out = saved(tensors, mesh)
            if len(tensors) == 5:  # (per-sample losses, vector, pose, texture, light)
                out[2] = tensors[2].float()
            return out

        distributed.model_sum = model_sum

    def __exit__(self, *exc):
        from rendernet_tpu_torch.train import distributed

        distributed.model_sum = self.saved


def ranks_equal(torch, tensors) -> bool:
    """Whether every rank of the group holds the same bytes in ``tensors``."""
    sums = [zlib.crc32(t.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy())
            for t in tensors]
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, sums)
    return all(x == every[0] for x in every)


def sp12_texture(torch, np, failures, rank, mesh, shard, ref, per_run):
    """Phase 12 (a) on one rank: the sharded texture forward against world
    1's logits; the sharded texture step's loss and model-summed gradients
    against world 1's, the ranks' params after it; the planted fault."""
    from rendernet_tpu_torch.models.texture_face import texture_face_forward
    from rendernet_tpu_torch.ops import halo
    from rendernet_tpu_torch.train.steps import make_texture_train_step

    out = {}
    what = f"phase 12 (a) rank {rank}"
    net, tx, fresh = sp_texture_state(torch)
    fresh()
    vox, img, nrm, codes, pose = texture_batch(torch, np, 8, seed=1)
    logits = []
    hooks = [h.register_forward_hook(lambda mod, args, y: logits.append(y.float()))
             for h in texture_heads(net)]

    def fwd():
        return texture_face_forward(net, shard.take(vox), codes, pose,
                                    compute_dtype=torch.bfloat16, resample="multipass",
                                    mesh=mesh)

    with torch.no_grad():
        reset_counts()
        heads, out["forward_memory"] = held_memory(torch, texture_heads(net)[1], fwd)
        _, by_shape = read_counts()
        per_run["sp_texfwd"] = check_step_counts(failures, f"{what} forward", by_shape, 1,
                                                 sharded_texture_launches(8, rank))
        errs, spreads = [], []
        for got, want in zip(logits, ref["logits"]):
            want = want.cuda()
            spreads.append(float(want.max() - want.min()))
            errs.append(float((shard.gather(got) - want).abs().max()) / spreads[-1])
        logits.clear()
        out["forward"] = {"rows": [list(t.shape) for t in heads], "logit_rel_err": errs,
                          "logit_spread": spreads, "ms": fixed_ms(torch, fwd)}
    for h in hooks:
        h.remove()
    del logits, heads
    if not max(errs) <= FORWARD_TOL["bfloat16"]:
        failures.append(f"{what}: logits {errs} of the spread from world 1's "
                        f"(tol {FORWARD_TOL['bfloat16']})")
    if out["forward"]["rows"] != [[8, 512 // SP_MODEL, 512, 3]] * 2:
        failures.append(f"{what}: the rank's rows {out['forward']['rows']}")

    grads = []
    step = make_texture_train_step(net.cfg, sp_texture_config(), recording(tx, grads), 128,
                                   mesh=mesh)
    batch = (shard.take(vox), shard.take(img), shard.take(nrm), codes, pose)
    step(fresh(), *batch, 1)  # warm-up
    grads.clear()
    reset_counts()
    halo.exchanges, halo.sent_bytes, halo.received_bytes = 0, 0, 0
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    marks[0].record()
    (state, loss), mem = held_memory(torch, texture_heads(net)[1],
                                     lambda: step(fresh(), *batch, 1))
    marks[1].record()
    torch.cuda.synchronize()
    _, by_shape = read_counts()
    per_run["sp_tex"] = check_step_counts(failures, f"{what} step", by_shape, 1,
                                          {**sharded_texture_launches(8, rank, grad=True),
                                           **adam_launches(net)})
    names = [n for n, _ in net.named_parameters()]

    def grad_errs(got):
        """(worst trunk / head parameter by max, worst decoder parameter by
        norm), each (name, error)."""
        errs, dec = {}, {}
        for n in names:
            a, b = got[n].float(), ref["grads"][n].cuda()
            if n.startswith("texture_encoder."):
                dec[n] = float((a - b).norm() / b.norm())
            else:
                errs[n] = float((a - b).abs().max() / b.abs().max())
        return max(errs.items(), key=lambda kv: kv[1]), max(dec.items(), key=lambda kv: kv[1])

    train = {"loss": float(loss), "loss_rel_err": abs(float(loss) - ref["loss"]) / ref["loss"],
             "step_ms": marks[0].elapsed_time(marks[1]), "memory": mem,
             "halo_exchanges": halo.exchanges, "halo_sent_bytes": halo.sent_bytes,
             "halo_received_bytes": halo.received_bytes,
             "ranks_equal": ranks_equal(torch, list(state.params.parameters()))}
    train["grad_worst"], train["decoder_worst"] = grad_errs(grads[0])
    grads.clear()
    with grid_cotangent_fault(mesh):
        step(fresh(), *batch, 1)
    train["fault_decoder_worst"] = grad_errs(grads[0])[1]
    fault_least = min(float((grads[0][n].float() - ref["grads"][n].cuda()).norm()
                            / ref["grads"][n].cuda().norm())
                      for n in names if n.startswith("texture_encoder."))
    train["fault_decoder_least"] = fault_least
    out["train"] = train
    if not train["loss_rel_err"] <= SP_LOSS_TOL:
        failures.append(f"{what}: loss {train['loss']} vs world 1's {ref['loss']}")
    if not train["grad_worst"][1] <= TEX_GRAD_TOL["bfloat16"]:
        failures.append(f"{what}: model-summed gradients vs world 1's {train['grad_worst']} > "
                        f"{TEX_GRAD_TOL['bfloat16']}")
    if not train["decoder_worst"][1] <= TEX_DECODER_TOL["bfloat16"]:
        failures.append(f"{what}: the decoder's gradients vs world 1's by norm "
                        f"{train['decoder_worst']} > {TEX_DECODER_TOL['bfloat16']}")
    if not train["ranks_equal"]:
        failures.append(f"{what}: the ranks' params differ after the step")
    if fault_least <= TEX_DECODER_TOL["bfloat16"]:
        failures.append(f"{what}: the planted fault (the grid cotangent model-summed) passed the "
                        f"decoder's gate: {fault_least:.3e}")
    del net, tx, fresh, grads, step, batch, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sp12_recon(torch, failures, rank, mesh, shard, ref, per_run):
    """Phase 12 (b) on one rank: per dtype SP_RECON_STEPS sharded recon
    steps against world 1's (the per-sample losses of every step; step 1's
    model-summed latent gradients by phase 5's per-group limits), the
    ranks' latents after them; the planted fault; one reconstruct epoch's
    best hypothesis."""
    import dataclasses

    from rendernet_tpu_torch.ops import halo
    from rendernet_tpu_torch.recon.inverse import reconstruct

    out = {}
    what = f"phase 12 (b) rank {rank}"
    model = sp_recon_model(torch)
    target = shard.take(ref["target"].cuda())
    for dname, cfg in sp_recon_configs().items():
        want = ref[f"recon_{dname}"]
        reset_counts()
        halo.exchanges, halo.sent_bytes, halo.received_bytes = 0, 0, 0
        res = sp_recon_run(torch, model, cfg, target, mesh)
        _, by_shape = read_counts()
        per_run["sp_recon" + ("32" if dname == "float32" else "16")] = check_step_counts(
            failures, f"{what} {dname} steps", by_shape, SP_RECON_STEPS,
            sharded_recon_launches(rank))
        loss_err = max(float(((a - b).abs() / b.abs()).max())
                       for a, b in zip(res["losses"], want["losses"]))
        errs = sp_grad_rel(res["grads"], want["grads"])
        row = {"losses": [p.tolist() for p in res["losses"]], "loss_rel_err": loss_err,
               "grad_rel_err": errs, "tol": RECON_GRAD_TOL[dname], "step_ms": res["ms"],
               "memory": res["memory"], "halo_exchanges": halo.exchanges // SP_RECON_STEPS,
               "halo_sent_bytes": halo.sent_bytes // SP_RECON_STEPS,
               "halo_received_bytes": halo.received_bytes // SP_RECON_STEPS,
               "ranks_equal": ranks_equal(torch, res["latents"])}
        if dname == "float32":
            with pose_sum_fault():
                fault = sp_recon_run(torch, model, cfg, target, mesh, n=1)
            row["fault_grad_rel_err"] = sp_grad_rel(fault["grads"], want["grads"])
        out[dname] = row
        if not loss_err <= SP_LOSS_TOL:
            failures.append(f"{what} {dname}: per-sample losses {loss_err:.3e} from world 1's")
        bad = [n for n, e in errs.items() if not e <= RECON_GRAD_TOL[dname][n]]
        if bad:
            failures.append(f"{what} {dname}: model-summed latent gradients {bad} differ from "
                            f"world 1's by {errs} (limits {RECON_GRAD_TOL[dname]})")
        if not row["ranks_equal"]:
            failures.append(f"{what} {dname}: the ranks' latents differ")
        if dname == "float32" and row["fault_grad_rel_err"]["pose"] <= \
                RECON_GRAD_TOL[dname]["pose"]:
            failures.append(f"{what}: the planted fault (the pose gradient left out of the model "
                            f"sum) passed the gate: {row['fault_grad_rel_err']}")
    cfg = dataclasses.replace(sp_recon_configs()["float32"], inner_steps=SP_RECON_EPOCH_STEPS,
                              max_epochs=1)
    _, history, _ = reconstruct(model, target, cfg, mesh=mesh)
    out["reconstruct_best"] = int(history[-1].argmin())
    out["reconstruct_losses"] = history[-1].tolist()
    if out["reconstruct_best"] != ref["best"]:
        failures.append(f"{what}: reconstruct picked hypothesis {out['reconstruct_best']}, world "
                        f"1 {ref['best']}")
    return out


def sp12_rank(rank: int, tmp: str) -> None:
    """One rank of the 1 x 2 mesh (gloo, the one card) in phase 12: (a) the
    texture path, (b) inverse rendering; writes ``tmp``/sp12_rank{rank}.json
    and, on rank 0, the launches per forward and per step."""
    import numpy as np
    import torch

    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.train import distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    failures, out, per_run = [], {"rank": rank}, {}
    distributed.initialize_multihost(f"file://{tmp}/sp12_init", SP_MODEL, rank)
    try:
        mesh = distributed.make_mesh(n_data=1, n_model=SP_MODEL)
        shard = distributed.spatial_sharding(mesh, 5)
        ref = torch.load(os.path.join(tmp, "sp12_ref.pt"), map_location="cpu",
                         weights_only=True)
        t0 = time.perf_counter()
        layers.WINOGRAD_2D = "pallas"
        try:
            out["texture"] = sp12_texture(torch, np, failures, rank, mesh, shard, ref, per_run)
        finally:
            layers.WINOGRAD_2D = False
        out["texture_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cudnn_det = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            out["recon"] = sp12_recon(torch, failures, rank, mesh, shard, ref, per_run)
        finally:
            torch.backends.cudnn.deterministic = cudnn_det
        out["recon_s"] = time.perf_counter() - t0
        if rank == 0:
            out["per_run"] = {run: {kid: [[list(k) if isinstance(k, tuple) else k, v]
                                          for k, v in c.items()] for kid, c in counts.items()}
                              for run, counts in per_run.items()}
    except Exception as e:  # the rank's failure, reported through its file
        failures.append(f"phase 12 rank {rank}: {e!r}")
        raise
    finally:
        out["failures"] = failures
        with open(os.path.join(tmp, f"sp12_rank{rank}.json"), "w") as f:
            json.dump(out, f, default=str)
        torch.distributed.destroy_process_group()


def run_spatial_texture_recon(torch, failures, tmp):
    """Phase 12: the world-1 references, then the two ranks
    (``sp12_rank``). Returns (the results, rank 0's launches by run)."""
    import numpy as np

    from rendernet_tpu_torch.train import distributed

    out, per_run = {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["world1"] = sp12_world1(torch, np, failures, tmp)
    out["world1_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = []
    try:
        distributed.launch(sp12_rank, SP_MODEL, (tmp,), timeout=400)
    except Exception as e:  # recorded; the ranks' files say more
        failures.append(f"phase 12 ranks: {e!r}")
    finally:
        for r in range(SP_MODEL):
            path = os.path.join(tmp, f"sp12_rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    ranks.append(json.load(f))
    for r in ranks:
        failures.extend(r["failures"])
    if len(ranks) != SP_MODEL:
        failures.append(f"phase 12: {len(ranks)} rank results")
    out["ranks"] = ranks
    out["ranks_s"] = time.perf_counter() - t0
    for run, counts in (ranks[0].get("per_run", {}) if ranks else {}).items():
        per_run[run] = {kid: {tuple(tuple(x) if isinstance(x, list) else x for x in k)
                              if isinstance(k, list) else k: v for k, v in rows}
                        for kid, rows in counts.items()}
    log("spatial_texture_recon " + json.dumps(out, default=str))
    return out, per_run


# Device kernels of each kernel id in a profile, by substrings of their
# (demangled) names.
PROFILED = {"K1": ("k1_pass",), "K4": ("k4_adjoint",),
            "K2": ("conv3d_mma_kernel", "conv3d_tf32_kernel", "conv3d_core_kernel"),
            "K2w": ("conv3d_wgrad_",),
            "K3": ("k3_",), "K6": ("k6_",),
            "K5": ("conv2d_wgmma_kernel", "conv2d_tf32_kernel", "::tf32_split_kernel"),
            "K5w": ("wgrad_wgmma_kernel", "wgrad_tf32_kernel", "tf32_split_cmajor",
                    "::wgrad_reduce_kernel")}


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
            "busy_share": us / busy_us if busy_us else None,
            "names": sorted({_kernel_name(r[0]) for r in mine})}


def _kernel_name(key: str) -> str:
    """A device kernel's name without its namespaces and arguments, with its
    template arguments (``conv3d_wgrad_tf32_kernel<32, 32, true>``)."""
    name = re.sub(r"^void ", "", key.replace("(anonymous namespace)::", "").split("(")[0])
    base, args = (name.split("<", 1) + [""])[:2]
    return re.sub(r"^.*::", "", base) + ("<" + args if args else "")


def check_profiled_names(failures, prof, kid, name, what):
    """Fails unless ``kid``'s kernels in profile ``prof`` include ``name``:
    the run went through that kernel."""
    if not any(n.startswith(name) for n in prof[kid]["names"]):
        failures.append(f"{what}: no {name} among {kid}'s profiled kernels "
                        f"{prof[kid]['names']}")


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
        from rendernet_tpu_torch.ops import (
            cuda_adam,
            cuda_conv2d,
            cuda_conv3d,
            cuda_resample,
            cuda_winograd,
        )

        swaps = [(cuda_adam, "adam_", cuda_adam.adam_plain),
                 (cuda_conv2d, "conv2d_hwnc", cuda_conv2d.conv2d_hwnc_plain),
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


# ---------------------------------------------------------------------------
# Adam (no TPU kernel: the JAX package leaves it to optax and XLA)
# ---------------------------------------------------------------------------
ADAM_REPS = 20


def adam_sass(failures) -> dict:
    """The Adam library's 128-bit loads and stores (its vector path; the
    table's pointers are generic, so they may be LD / ST as well as LDG /
    STG) and local memory accesses (none: the gradient pointers are read
    from the launch's parameters, not copied to the stack)."""
    from rendernet_tpu_torch.ops import _native

    tool = os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    sass = subprocess.run([tool, "-sass", str(_native._target("adam"))], capture_output=True,
                          text=True).stdout
    counts = {"ld128": len(re.findall(r"\bLDG?\.E\.128\b", sass)),
              "st128": len(re.findall(r"\bSTG?\.E\.128\b", sass)),
              "local": len(re.findall(r"\b(?:LDL|STL)\b", sass))}
    if not counts["ld128"] or not counts["st128"] or counts["local"]:
        failures.append(f"adam's SASS: {counts} (wanted 128-bit loads and stores, no local memory)")
    return counts


def run_adam(torch, failures) -> list:
    """The fused Adam update at the shader's and texface's parameter sets,
    fp32 gradients and moments: two updates of the kernel against two of
    its plain version on clones (bit for bit), then the ms of the kernel,
    of the plain version and of ``torch.optim.Adam(fused=True)`` on the same
    tensors (the one-call yardstick, ``library_ms``; the port never calls
    it), and the bound: 28 bytes a parameter at 3.35 TB/s. Prints an
    ``adam`` line a set; returns the kernels line's rows, each with the
    training run (``run``) whose launches per step the kernels line
    reports."""
    from rendernet_tpu_torch.models import param_shapes
    from rendernet_tpu_torch.models.shader import ShaderConfig
    from rendernet_tpu_torch.models.texture_face import TextureFaceConfig
    from rendernet_tpu_torch.ops import cuda_adam
    from rendernet_tpu_torch.train import optim

    dev = torch.device("cuda")
    sass = adam_sass(failures)
    hyper = dict(b1=0.5, b2=0.999, eps=1e-8)
    rows = []
    for kind, cfg, run in (("shader", ShaderConfig(preact_policy=True), "train64"),
                           ("texface", TextureFaceConfig(), "tex64")):
        shapes = param_shapes(cfg)
        gen = torch.Generator(device=dev).manual_seed(22)
        names = list(shapes)
        params = [torch.randn(shapes[k], generator=gen, device=dev) for k in names]
        grads = [torch.randn(shapes[k], generator=gen, device=dev) * 1e-3 for k in names]
        mu = [torch.zeros_like(p) for p in params]
        nu = [torch.zeros_like(p) for p in params]
        ref = [[t.clone() for t in ts] for ts in (params, mu, nu)]
        _, bc1, bc2 = optim._bias_corrections(torch.zeros((), dtype=torch.int32, device=dev),
                                              0.5, 0.999)
        lr = -optim.exponential_staircase(1e-3, 2, 0.96)(torch.ones((), dtype=torch.int32,
                                                                     device=dev))
        for _ in range(2):
            cuda_adam.adam_(params, grads, mu, nu, bc1, bc2, lr, **hyper)
            cuda_adam.adam_plain(ref[0], grads, ref[1], ref[2], bc1, bc2, lr, **hyper)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for ts, rs in zip((params, mu, nu), ref)
                  for a, b in zip(ts, rs))
        same = all(torch.equal(a, b) for ts, rs in zip((params, mu, nu), ref)
                   for a, b in zip(ts, rs))
        if not same:
            failures.append(f"adam {kind}: the kernel differs from its plain version "
                            f"(max abs {err:.3e})")
        del ref
        ms = time_ms(torch, lambda: cuda_adam.adam_(params, grads, mu, nu, bc1, bc2, lr,
                                                    **hyper), ADAM_REPS)
        plain_ms = time_ms(torch, lambda: cuda_adam.adam_plain(params, grads, mu, nu, bc1, bc2,
                                                               lr, **hyper), 5)
        leaves = [p.detach().clone().requires_grad_() for p in params]
        for leaf, g in zip(leaves, grads):
            leaf.grad = g
        lib = torch.optim.Adam(leaves, lr=1e-3, betas=(0.5, 0.999), eps=1e-8, fused=True)
        library_ms = time_ms(torch, lib.step, ADAM_REPS)
        del lib, leaves
        n = sum(p.numel() for p in params)
        bound_ms = 28 * n / PEAK_BYTES * 1e3
        row = {"name": f"Adam {kind} [{len(names)} tensors, {n} params] float32",
               "route": "cuda", "source": "rendernet_tpu_torch/csrc/adam.cu",
               "replaces": "none (the JAX package leaves Adam to optax / XLA)",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": library_ms}
        log("adam " + json.dumps({**row, "share": bound_ms / ms, "bit_equal": same,
                                  "sass": sass}))
        rows.append({**row, "run": run})
        del params, grads, mu, nu
        torch.cuda.empty_cache()
    return rows


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
    chain_sweep(torch)
    adam_rows = run_adam(torch, failures)
    torch.cuda.empty_cache()
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
    t0 = time.perf_counter()
    main_out["texture"] = run_texture(torch, failures, per_step)
    log(f"phase 7 (the texture path) took {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as cli_tmp:  # phase 8's dataset, read again in 10
        t0 = time.perf_counter()
        main_out["cli"] = run_cli(torch, failures, per_step, cli_tmp)
        log(f"phase 8 (the training CLIs) took {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            main_out["rewrites"] = run_rewrites(torch, failures, tmp)
        log(f"phase 9 (the exact rewrites, the frozen artifact) took "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            main_out["distributed"] = run_distributed(torch, failures,
                                                      main_out["cli"]["dataset"], tmp)
        log(f"phase 10 (data parallelism) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        main_out["spatial"], sp_per_run = run_spatial(torch, failures, tmp)
    per_step.update(sp_per_run)
    log(f"phase 11 (spatial sharding) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        main_out["spatial_texture_recon"], sp_per_run = run_spatial_texture_recon(
            torch, failures, tmp)
    per_step.update(sp_per_run)
    log(f"phase 12 (the texture step and inverse rendering under a model axis) took "
        f"{time.perf_counter() - t0:.1f} s")

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
    for r in adam_rows:  # launches a step of the run's training step
        launches = sum(per_step[r.pop("run")].get("Adam", {}).values())
        if launches != 1:
            failures.append(f"{r['name']}: {launches} launches a step in its training run")
        kernels.append({**r, "launches": launches})
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
