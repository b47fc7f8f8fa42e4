#!/usr/bin/env python3
"""Times chosen kernels of the port, and the paths that run them, against an
earlier revision of the repository, on one CUDA card.

    mkdir -p _scratch/parent && git archive <rev> | tar -x -C _scratch/parent
    python3 compare_parent.py _scratch/parent K5 K5w

The arguments after the earlier revision's tree are kernel ids of
``chip_smoke.py`` (K1, K4, K2, K2w, K3, K6, K5, K5w). Four processes, in
turns earlier revision, this tree, this tree, earlier revision, each on its
own tree's package and ``chip_smoke.py`` (kernels built from that tree's
sources, into that tree's ``_build``):

1. kernels: at every phase-2 row of those kernels (each dtype, ragged and
   check shapes included; inputs seeded by the row, so that both trees
   see the same ones), the wrapper's time (``chip_smoke.time_ms``: CUDA
   events over repeated calls) beside the library call's where there is
   one (cuDNN for the convolutions), its error against the plain version
   (``chip_smoke``'s tolerances) and a checksum of its output bits;
2. end to end, with ``layers.CUDA_CONV2D`` off and, where K5 or K5w is
   chosen, also on (the fused wide-conv route): one bf16 batch-8
   ``shader_forward`` at full width (ms per forward, and the device's idle
   share over a profiled forward), ``bench.py``'s two training
   configurations (batch 24, bf16, patch 128 and 64: two warm-up steps,
   then E2E_STEPS steps on one batch, each timed synchronize to
   synchronize; median and mean) and the bf16 inverse-rendering step at
   ``ReconConfig()`` (a warm-up, then RECON_STEPS steps on a fixed random
   target, each timed synchronize to synchronize; median and mean; device
   busy time and idle share over one profiled step); where K6 is chosen, with the flag off, also the
   patch-128 step with ``cuda_winograd.WGRAD`` set to True and to "fp32"
   (K6 in each operand form) on each tree, timed the same way.

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per kernel row of this tree (matched to the earlier revision's by kernel,
label and dtype; null where that revision has no such row; ``same_bits``:
all four turns' outputs have the same checksum, null without the earlier
revision's row), one per end-to-end route,
each with the four turns' readings, and a ``sass_identical`` line: for
each kernel library, whether both trees compiled the same SASS
(``cuobjdump -sass``, with the anonymous namespaces' per-file names
masked). Exits non-zero if a kernel row misses its tolerance.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

E2E_STEPS = 8
RECON_STEPS = 8


def _bits(torch, outs) -> int:
    """A checksum of the outputs' bits: each value's bit pattern times a
    position weight, summed in wrapping int64 (the same bits give the same
    sum, whatever the order of the sum)."""
    total = 0
    for t in outs:
        x = t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
        x = x.flatten().to(torch.int64)
        w = torch.arange(x.numel(), device=x.device, dtype=torch.int64) % 1000003 + 1
        total = (total * 1000033 + int((x * w).sum())) % (1 << 61)
        del x, w
    return total


def _kernel_rows(torch, cs, kids):
    # the tree's own rate for a case's bound (trees before it bound by dtype)
    rate = getattr(cs, "bound_dtype", lambda op, dname: dname)
    for kid, label, op, spec, dnames, _ in cs.CASES:
        if kid not in kids:
            continue
        for dname in dnames:
            dtype = getattr(torch, dname)
            # inputs seeded by the row alone, so both trees see the same ones
            seed = zlib.crc32(f"{kid}|{label}|{dname}".encode())
            gen = torch.Generator(device="cuda").manual_seed(seed)
            kern, plain, lib, flops, nbytes, f32_out = cs.make_case(torch, op, spec, dtype, gen)
            got, ref = kern(), plain()
            got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
            err = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
            scale = max(float(b.float().abs().max()) for b in ref)
            tol = (cs.WGRAD_TOL if f32_out else cs.KERNEL_TOL[dname]) * scale
            bits = _bits(torch, got)
            del got, ref
            print(json.dumps({"kernel": kid, "shape": label, "dtype": dname,
                              "ms": cs.time_ms(torch, kern, 20),
                              "library_ms": cs.time_ms(torch, lib, 20) if lib else None,
                              "bound_ms": cs.bound(flops, nbytes, rate(op, dname))[0],
                              "err": err, "tol": tol, "bits": bits}), flush=True)
            torch.cuda.empty_cache()


def _timed_steps(torch, step, state, batch):
    """Two warm-up steps, then E2E_STEPS steps, each timed synchronize to
    synchronize: (state, {"median", "mean"} ms, every loss finite)."""
    times, losses = [], []
    for i in range(2 + E2E_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, *batch, 1)
        losses.append(float(loss))  # synchronizes
        if i >= 2:
            times.append((time.perf_counter() - t0) * 1e3)
    return state, {"median": statistics.median(times), "mean": statistics.fmean(times)}, \
        all(math.isfinite(x) for x in losses)


def _e2e(torch, np, cs, conv2d: bool, wgrad: bool) -> dict:
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.ops import cuda_winograd
    from rendernet_tpu_torch.recon.inverse import ReconConfig, initial_latents, make_recon_step
    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.train.steps import create_shader_state, make_shader_train_step

    layers.WINOGRAD_2D, layers.CUDA_CONV2D = True, conv2d
    res = {"conv2d": conv2d}
    try:
        net = init_shader_params(0, ShaderConfig(), device="cuda")
        vox, _, pose = cs.bench_batch(torch, np, 8)
        with torch.no_grad():
            fwd = lambda: shader_forward(net, vox, pose, compute_dtype=torch.bfloat16,  # noqa: E731
                                         resample="multipass")
            res["forward_ms"] = cs.time_ms(torch, fwd, 10)
            res["forward_idle_share"] = cs.profile_run(torch, fwd)["device_idle_share"]
        del net, vox, pose
        cfg = TrainConfig(batch_size=24, img_res=512, new_size=128, compute_dtype="bfloat16",
                          is_greyscale=True, e_eta=1e-5, moment_dtype="bfloat16")
        mcfg = ShaderConfig(preact_policy=True)
        batch = cs.bench_batch(torch, np, 24)
        state, tx = create_shader_state(0, mcfg, cfg, device="cuda")
        for patch in (128, 64):
            step = make_shader_train_step(mcfg, cfg, tx, patch)
            state, res[f"step{patch}_ms"], res[f"step{patch}_finite"] = _timed_steps(
                torch, step, state, batch)
        # the patch-128 step with K6 in each operand form
        for mode in (True, "fp32") if wgrad and not conv2d else ():
            cuda_winograd.WGRAD = mode
            try:
                step = make_shader_train_step(mcfg, cfg, tx, 128)
                state, res[f"wgrad_{mode}_step128_ms"], res[f"wgrad_{mode}_finite"] = \
                    _timed_steps(torch, step, state, batch)
            finally:
                cuda_winograd.WGRAD = False
        del state, tx, batch
        torch.cuda.empty_cache()
        model = cs.recon_model(torch)
        rcfg = ReconConfig(compute_dtype="bfloat16", light_elevation=cs.RECON_LIGHT_ELEVATION)
        step = make_recon_step(model, rcfg)
        lat = initial_latents(rcfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(11)
        target = torch.rand(5, 512, 512, 3, generator=gen, device="cuda")
        lat, _ = step(lat, target)  # warm-up
        times, sums = [], []
        for _ in range(RECON_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lat, per = step(lat, target)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            sums.append(per.sum())
        res["recon16_ms"] = {"median": statistics.median(times), "mean": statistics.fmean(times)}
        res["recon16_finite"] = all(math.isfinite(float(x)) for x in sums)
        prof = cs.profile_run(torch, lambda: step(lat, target))
        res["recon16_busy_ms"] = prof["device_busy_ms"]
        res["recon16_idle_share"] = prof["device_idle_share"]
    finally:
        layers.WINOGRAD_2D, layers.CUDA_CONV2D = False, False
        torch.cuda.empty_cache()
    return res


def run(tree: str, kids) -> None:
    """One turn, on the package of ``tree`` (this process imports it)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from rendernet_tpu_torch.ops import _native

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _native.build_all()
    _kernel_rows(torch, cs, kids)
    for conv2d in (False, True) if {"K5", "K5w"} & set(kids) else (False,):
        print("e2e " + json.dumps(_e2e(torch, np, cs, conv2d, "K6" in kids)), flush=True)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--run":
        run(sys.argv[2], sys.argv[3:])
        return 0
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    parent = str(Path(sys.argv[1]).resolve())
    here = str(Path(__file__).resolve().parent)
    kids = sys.argv[2:]
    turns = []
    for tree in (parent, here, here, parent):
        out = subprocess.run([sys.executable, __file__, "--run", tree, *kids], check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        turns.append([line for line in out.splitlines()
                      if line.startswith("{") or line.startswith("e2e ")])
    # kernel rows by (kernel, shape, dtype): a row that the earlier revision
    # lacks reads null on its side
    kern = [{(r["kernel"], r["shape"], r["dtype"]): r
             for r in (json.loads(x) for x in t if x.startswith("{"))} for t in turns]
    e2e = [[json.loads(x[4:]) for x in t if x.startswith("e2e ")] for t in turns]
    failed = 0
    for key, n0 in kern[1].items():
        p0, n1, p1 = kern[0].get(key), kern[2][key], kern[3].get(key)
        ok = all(r["err"] <= r["tol"] for r in (p0, n0, n1, p1) if r)
        failed += not ok
        bits = {r["bits"] for r in (p0, n0, n1, p1) if r}
        print(json.dumps({"kernel": n0["kernel"], "shape": n0["shape"], "dtype": n0["dtype"],
                          "parent_ms": [r and r["ms"] for r in (p0, p1)],
                          "new_ms": [n0["ms"], n1["ms"]],
                          "library_ms": [r and r["library_ms"] for r in (p0, n0, n1, p1)],
                          "bound_ms": n0["bound_ms"], "err_parent": p0 and p0["err"],
                          "err_new": n0["err"], "tol": n0["tol"],
                          "same_bits": len(bits) == 1 if p0 and p1 else None, "ok": ok}),
              flush=True)
    for rows in zip(*e2e):
        print("e2e " + json.dumps({"conv2d": rows[0]["conv2d"], "parent": [rows[0], rows[3]],
                                   "new": [rows[1], rows[2]]}), flush=True)
    print("sass_identical " + json.dumps(_same_sass(parent, here)), flush=True)
    return 1 if failed else 0


def _same_sass(parent: str, here: str) -> dict:
    """{library: whether the two trees' builds hold the same SASS}."""
    from rendernet_tpu_torch.ops import _native

    tool = os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump")

    def sass(tree, name):
        libs = sorted(Path(tree, "rendernet_tpu_torch", "_build").glob(f"lib{name}-*.so"))
        if len(libs) != 1:
            return None
        text = subprocess.run([tool, "-sass", str(libs[0])], capture_output=True,
                              text=True).stdout
        return re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "ANON", text)

    out = {}
    for name in _native.SOURCES:
        a, b = sass(parent, name), sass(here, name)
        out[name] = None if a is None or b is None else a == b
    return out


if __name__ == "__main__":
    sys.exit(main())
