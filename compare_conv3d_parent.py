#!/usr/bin/env python3
"""Times K2 and K2w (``rendernet_tpu_torch/csrc/conv3d*.cu``) and the paths
that run them against an earlier revision of the repository, on one CUDA
card.

    mkdir -p _scratch/parent && git archive <rev> | tar -x -C _scratch/parent
    python3 compare_conv3d_parent.py _scratch/parent

Four processes, in turns earlier revision, this tree, this tree, earlier
revision, each on its own tree's package and ``chip_smoke.py`` (kernels
built from that tree's sources, into that tree's ``_build``):

1. kernels: at every bf16 K2 / K2w row of ``chip_smoke.py``'s phase 2, the
   wrapper's time (``chip_smoke.time_ms``: CUDA events over repeated
   calls) beside cuDNN's call, and its error against the plain version
   (``chip_smoke``'s tolerances);
2. end to end: one bf16 batch-8 ``shader_forward`` at full width (ms per
   forward, and the device's idle share over a profiled forward), and
   ``bench.py``'s two training configurations (batch 24, bf16, patch 128
   and 64): two warm-up steps, then E2E_STEPS steps on one batch, each
   timed synchronize to synchronize (median and mean).

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per kernel row and one for the end-to-end runs, each with the four turns'
readings. Exits non-zero if a kernel row misses its tolerance.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

E2E_STEPS = 10


def run(tree: str) -> None:
    """One turn, on the package of ``tree`` (this process imports it)."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward
    from rendernet_tpu_torch.nn import layers
    from rendernet_tpu_torch.ops import _native
    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.train.steps import create_shader_state, make_shader_train_step

    torch.backends.cudnn.allow_tf32 = False
    _native.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for kid, label, op, spec, dnames, _ in cs.CASES:
        if kid not in ("K2", "K2w") or "bfloat16" not in dnames:
            continue
        kern, plain, lib, flops, nbytes, f32_out = cs.make_case(torch, op, spec, torch.bfloat16,
                                                                gen)
        ref = plain().float()
        err = float((kern().float() - ref).abs().max())
        tol = (cs.WGRAD_TOL if f32_out else cs.KERNEL_TOL["bfloat16"]) * float(ref.abs().max())
        del ref
        print(json.dumps({"kernel": kid, "shape": label, "ms": cs.time_ms(torch, kern, 20),
                          "library_ms": cs.time_ms(torch, lib, 20),
                          "bound_ms": cs.bound(flops, nbytes, "bfloat16")[0], "err": err,
                          "tol": tol}), flush=True)
        torch.cuda.empty_cache()

    layers.WINOGRAD_2D = True
    res = {}
    net = init_shader_params(0, ShaderConfig(), device="cuda")
    vox, _, pose = cs.bench_batch(torch, np, 8)
    with torch.no_grad():
        fwd = lambda: shader_forward(net, vox, pose, compute_dtype=torch.bfloat16,  # noqa: E731
                                     resample="multipass")
        res["forward_ms"] = cs.time_ms(torch, fwd, 10)
        res["forward_idle_share"] = cs.profile_run(torch, fwd)["device_idle_share"]
    del net
    cfg = TrainConfig(batch_size=24, img_res=512, new_size=128, compute_dtype="bfloat16",
                      is_greyscale=True, e_eta=1e-5, moment_dtype="bfloat16")
    mcfg = ShaderConfig(preact_policy=True)
    batch = cs.bench_batch(torch, np, 24)
    state, tx = create_shader_state(0, mcfg, cfg, device="cuda")
    for patch in (128, 64):
        step = make_shader_train_step(mcfg, cfg, tx, patch)
        times, losses = [], []
        for i in range(2 + E2E_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, *batch, 1)
            losses.append(float(loss))  # synchronizes
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
        res[f"step{patch}_ms"] = {"median": statistics.median(times),
                                  "mean": statistics.fmean(times)}
        res[f"step{patch}_finite"] = all(math.isfinite(x) for x in losses)
    print("e2e " + json.dumps(res), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        run(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    parent = str(Path(sys.argv[1]).resolve())
    here = str(Path(__file__).resolve().parent)
    turns = []
    for tree in (parent, here, here, parent):
        out = subprocess.run([sys.executable, __file__, "--run", tree], check=True,
                             stdout=subprocess.PIPE, text=True).stdout
        turns.append([line for line in out.splitlines()
                      if line.startswith("{") or line.startswith("e2e ")])
    failed = 0
    for rows in zip(*turns):
        if rows[0].startswith("e2e "):
            e2e = [json.loads(r[4:]) for r in rows]
            print("e2e " + json.dumps({"parent": [e2e[0], e2e[3]], "new": [e2e[1], e2e[2]]}))
            continue
        p0, n0, n1, p1 = (json.loads(r) for r in rows)
        ok = all(r["err"] <= r["tol"] for r in (p0, n0, n1, p1))
        failed += not ok
        print(json.dumps({"kernel": n0["kernel"], "shape": n0["shape"],
                          "parent_ms": [p0["ms"], p1["ms"]], "new_ms": [n0["ms"], n1["ms"]],
                          "library_ms": [r["library_ms"] for r in (p0, n0, n1, p1)],
                          "bound_ms": n0["bound_ms"], "err_parent": p0["err"], "err_new": n0["err"],
                          "tol": n0["tol"], "ok": ok}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
