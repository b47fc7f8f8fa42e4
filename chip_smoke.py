#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``rendernet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, all of them on every run:
  1. build every CUDA kernel from ``rendernet_tpu_torch/csrc`` (one nvcc per
     source, in parallel) and print the card's name and power limit;
  2. kernels: call each kernel's wrapper (K1 resample pass, K2 conv3d, K3
     Winograd) at the shapes the serving path gives it, in float32 and
     bfloat16, plus one ragged shape each; hold it against its plain PyTorch
     version in the working dtype; time kernel, plain version and (K2, K3)
     the cuDNN conv yardstick with CUDA events;
  3. main: run the render CLI (fp32, ``--fast --resample multipass --rotate
     --sweep_batch 8``: 72 frames, 9 batch-8 forwards) on a procedural voxel,
     then one bf16 ``shader_forward`` at batch 8 (the serving-bench form),
     both at the full default width; the kernels' launch counters are zeroed
     just before each run and read just after; compare one full forward per
     dtype, on the logits, with the forward whose kernels are replaced by
     their plain versions.

Prints a ``{"kernels": [...]}`` line with one row per kernel, dtype and
main-path shape; its ``launches`` is the launches at that shape per batch-8
forward of that dtype's main-path run (the fp32 CLI's counts divided by its
9 forwards, after checking they are exact multiples). The ragged shapes are
checked on ``ragged`` lines of their own. The last line is
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, when
there is no CUDA card, when the port is missing, or when any check fails.
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
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}

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

REPO_SOURCES = {
    "K1": ("rendernet_tpu_torch/csrc/resample.cu",
           "rendernet_tpu/ops/pallas_resample.py:320 (_fwd_kernel)"),
    "K2": ("rendernet_tpu_torch/csrc/conv3d.cu",
           "rendernet_tpu/ops/pallas_conv3d.py:165 (_fwd_kernel)"),
    "K3": ("rendernet_tpu_torch/csrc/winograd.cu",
           "rendernet_tpu/ops/pallas_winograd.py:147 (_kernel)"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int) -> float:
    for _ in range(3):  # warm up (first-call setup, clocks)
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
# Per kernel: (label, case, launches at that shape per batch-8 forward, or
# None for the ragged shape, which the main path never gives it). A K1 case
# is (BC, R, L, out_lanes, db), a K2/K3 case (input shape, co); the first
# three entries, or the input shape, are the wrapper's shape key.
SHAPES = {
    "K1": [("pass [8,16384,128]", (8, 16384, 128, 128, 128), 8),
           ("ragged pass [3,1000,100]->37", (3, 1000, 100, 37, 40), None)],
    "K2": [("e_conv3 [8,64,64,32,16]->32", ((8, 64, 64, 32, 16), 32), 1),
           ("res1 [8,64,64,32,32]->32", ((8, 64, 64, 32, 32), 32), 21),
           ("ragged [2,5,10,24,24]->64", ((2, 5, 10, 24, 24), 64), None)],
    "K3": [("res2 [8,64,64,1024]->1024", ((8, 64, 64, 1024), 1024), 21),
           ("res3 [8,64,64,512]->512", ((8, 64, 64, 512), 512), 11),
           ("ragged [8,6,70,256]->128", ((8, 6, 70, 256), 128), None)],
}


MAIN_CASES = {(kid, label) for kid, cases in SHAPES.items()
              for label, _, n in cases if n is not None}


def shape_key(kid, case):
    return tuple(case[:3]) if kid == "K1" else tuple(case[0])


def kernel_cases(torch, dtype):
    """(kernel id, label, kernel fn, plain fn, library fn or None, flops,
    bytes) at the serving path's shapes and one ragged shape each."""
    from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    item = torch.tensor([], dtype=dtype).element_size()
    cases = []

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    for label, (bc, r, lanes, ol, db), _ in SHAPES["K1"]:
        vol = rnd(bc, r, lanes)
        u = torch.rand(bc, 4, generator=gen, device=dev) * 2 - 1
        params = torch.stack([1 + 0.4 * u[:, 0], 0.4 * u[:, 1], 0.4 * u[:, 2],
                              20 * u[:, 3]], dim=-1)
        cases.append((
            "K1", label,
            lambda v=vol, p=params, d=db, o=ol: cuda_resample.apply_interp_pass(v, p, d, o),
            lambda v=vol, p=params, d=db, o=ol: cuda_resample.interp_pass_plain(v, p, d, o),
            None, 10.0 * bc * r * ol, item * bc * (r * lanes + r * ol) + 16 * bc,
        ))

    def conv3d_lib(x, w):
        y = torch.nn.functional.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                                       padding=1)
        return y.permute(0, 2, 3, 4, 1)

    for label, (xs, co), _ in SHAPES["K2"]:
        x = rnd(*xs)
        w = rnd(3, 3, 3, xs[-1], co, scale=1.0 / math.sqrt(27 * xs[-1]))
        m = math.prod(xs[:-1])
        cases.append((
            "K2", label,
            lambda x=x, w=w: cuda_conv3d.nc_conv3d(x, w),
            lambda x=x, w=w: cuda_conv3d.nc_conv3d_plain(x, w),
            lambda x=x, w=w: conv3d_lib(x, w),
            2.0 * m * co * 27 * xs[-1], item * (x.numel() + w.numel() + m * co),
        ))

    def conv2d_lib(x, w):
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
        return y.permute(0, 2, 3, 1)

    for label, (xs, co), _ in SHAPES["K3"]:
        x = rnd(*xs)
        w = rnd(3, 3, xs[-1], co, scale=1.0 / math.sqrt(9 * xs[-1]))
        tiles = xs[0] * (xs[1] // 2) * (xs[2] // 2)
        cases.append((
            "K3", label,
            lambda x=x, w=w: cuda_winograd.wino_conv2d(x, w),
            lambda x=x, w=w: cuda_winograd.wino_conv2d_plain(x, w),
            lambda x=x, w=w: conv2d_lib(x, w),
            2.0 * 16 * tiles * xs[-1] * co,
            item * (x.numel() + 16 * xs[-1] * co + math.prod(xs[:-1]) * co),
        ))
    return cases


def run_kernel_checks(torch, failures):
    """Checks and times every case; returns the rows, keyed by kernel id,
    label and dtype name."""
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for kid, label, kern, plain, lib, flops, nbytes in kernel_cases(torch, dtype):
            got = kern()
            ref = plain()
            torch.cuda.synchronize()
            scale = max(float(ref.float().abs().max()), 1e-30)
            err = float((got.float() - ref.float()).abs().max())
            ok = bool(torch.isfinite(got.float()).all()) and err <= KERNEL_TOL[dname] * scale
            kms = time_ms(torch, kern, 20)
            pms = time_ms(torch, plain, 5)
            lms = time_ms(torch, lib, 20) if lib is not None else None
            bms, by = bound(flops, nbytes, dname)
            row = dict(kernel=kid, shape=label, dtype=dname, max_abs_err=err,
                       max_abs_ref=scale, tol=KERNEL_TOL[dname] * scale, ok=ok,
                       ms=kms, plain_ms=pms, library_ms=lms, bound_ms=bms, bound_by=by)
            rows[kid, label, dname] = row
            log(("kernel " if (kid, label) in MAIN_CASES else "ragged ") + json.dumps(row))
            if not ok:
                failures.append(f"{kid} {label} {dname}: err {err:.3e} > "
                                f"{KERNEL_TOL[dname] * scale:.3e}")
            del got, ref
    return rows


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


def _counted():
    from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd

    return {"K1": cuda_resample, "K2": cuda_conv3d, "K3": cuda_winograd}


def reset_counts():
    for mod in _counted().values():
        mod.launches = 0
        mod.launches_by_shape.clear()


def read_counts():
    """({kernel id: launches}, {kernel id: {shape key: launches}})."""
    mods = _counted()
    return ({k: m.launches for k, m in mods.items()},
            {k: dict(m.launches_by_shape) for k, m in mods.items()})


def check_counts(failures, what, by_shape, n_fwd):
    """Launches per batch-8 forward at each main-path shape, from a run of
    ``n_fwd`` forwards; fails on any other count or shape."""
    per_fwd = {}
    for kid, shapes in SHAPES.items():
        seen = dict(by_shape[kid])
        for label, case, n in shapes:
            if n is None:
                continue
            got = seen.pop(shape_key(kid, case), 0)
            per_fwd[kid, label] = got // n_fwd
            if got != n * n_fwd:
                failures.append(f"{what}: {kid} launched {got} times at {label}, "
                                f"expected {n} x {n_fwd} forwards")
        if seen:
            failures.append(f"{what}: {kid} launched at unexpected shapes {seen}")
    return per_fwd


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
        out["bfloat16"]["profile"] = profile_forward(
            torch, lambda: shader_forward(net, vox, pose, compute_dtype=torch.bfloat16,
                                          resample="multipass"))
    return out, per_fwd


def profile_forward(torch, fwd, top: int = 12):
    """Device time by kernel name over one forward (torch.profiler), and the
    device's busy share of the forward's wall time."""
    from torch.profiler import ProfilerActivity, profile

    fwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fwd()
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
    """Route the three kernel wrappers to their plain versions (on the card)."""

    def __enter__(self):
        from rendernet_tpu_torch.ops import cuda_conv3d, cuda_resample, cuda_winograd

        self.saved = [(cuda_resample, "apply_interp_pass", cuda_resample.interp_pass_plain),
                      (cuda_conv3d, "nc_conv3d", cuda_conv3d.nc_conv3d_plain),
                      (cuda_winograd, "wino_conv2d", cuda_winograd.wino_conv2d_plain)]
        self.saved = [(m, n, getattr(m, n), p) for m, n, p in self.saved]
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
    rows = run_kernel_checks(torch, failures)
    with tempfile.TemporaryDirectory() as tmp:
        main_out, per_fwd = run_main_path(torch, failures, tmp)

    kernels = []
    for (kid, label, dname), r in rows.items():
        if (kid, label) not in MAIN_CASES:
            continue
        src, replaces = REPO_SOURCES[kid]
        kernels.append({
            "name": f"{kid} {label} {dname}", "route": "cuda",
            "source": src, "replaces": replaces, "launches": per_fwd[dname][kid, label],
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
