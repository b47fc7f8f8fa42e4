"""Run one cell of the benchmark once, on the card.

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (import, the port's kernels built or found built, the seed's inputs
and weights made on the device, the cell's first steps or warm-up requests)
is timed from the process's start as ``setup_s``. Then the window runs for
``--seconds``: with ``--trace 0`` the result holds the cell's end-to-end
metrics; with ``--trace 1`` a traced stretch follows the window and the
result holds the cell's per-layer metrics, read from the profiler's trace
and the port's launch counters. Last, with the program's state freed, the
reference checks what the timed path produced (``compare.py``), and the
last line of standard output is one JSON object. Earlier lines: ``clock``
(nvidia-smi beside the window), ``work`` (operations per step or request,
counted least and direct), ``trace`` (the stretch's rate against the
window's). The numbers compared, each with its limit, are also the last
lines of standard error.

Exits 3 without a result where there is no CUDA card (or fewer than the cell
asks for): it never falls back to the CPU. Exits 4 without a result if JAX,
Flax or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Run as a script, this folder heads sys.path, and its modules (trace.py,
# clock.py, ...) would shadow top-level modules of the same names: they are
# imported as the package portbench instead.
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
BANNED = ("jax", "jaxlib", "flax", "rendernet_tpu")


def loaded_banned() -> list:
    """Loaded modules whose whole top-level name is a banned one (the port's
    ``rendernet_tpu_torch`` begins with ``rendernet_tpu`` and is not)."""
    return sorted({m.split(".")[0] for m in list(sys.modules) if m.split(".")[0] in BANNED})


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _traced(mode, cell, win):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import counters, trace

    units = cell["mix"]["traced_units"]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if mode.dev.type == "cuda" else [])
    before = counters.snapshot()
    with profile(activities=acts, with_stack=True) as prof:
        with record_function(trace.MARKER):
            t0 = time.perf_counter()
            mode.stretch(units)
            dt = time.perf_counter() - t0
    launches = counters.delta(before)
    tr = trace.load(prof)
    del prof
    if mode.dev.type == "cuda":
        torch.cuda.synchronize()
    reading = trace.Reading(tr, launches, units, mode.kind, mode.dtype, mode.flops_per_unit(),
                            win["units"] / win["seconds"])
    return reading, trace.breakdown(tr), dt


def main(argv=None, device=None, cell_override=None, cfg_override=None) -> int:
    """One run. ``device``, ``cell_override`` and ``cfg_override`` are for
    the CPU tests, which drive a run at a small size without a card."""
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cache = ROOT / ".portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")

    import torch

    from portbench import clock, compare, registry, work

    cell = {**registry.workload(args.workload), **(cell_override or {})}
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), found {have};"
                  " it does not run on the CPU", file=sys.stderr)
            return 3
        device = "cuda"
        torch.set_num_threads(2)
    cfg = {**registry.config(cell["config"]), **(cfg_override or {})}
    mode = registry.mode(cell["mode"])(cell, cfg, args.seed, device)
    mode.setup()
    setup_s = time.perf_counter() - T0
    cuda = mode.dev.type == "cuda"
    print("setup " + json.dumps({"setup_s": setup_s, **mode.setup_phases}), flush=True)

    sampler = clock.Sampler() if cuda else None
    try:
        win = mode.window(args.seconds)
    finally:
        clk = sampler.stop() if sampler else {"samples": 0}
    print("clock " + json.dumps(clk), flush=True)
    flops = mode.flops_per_unit()
    rate = win["units"] / win["seconds"]
    peak = work.PEAK_FLOPS["bfloat16"]
    print("work " + json.dumps({"per_unit": flops, "units": win["units"],
                                "mfu_direct": 100.0 * flops["direct"] * rate / peak,
                                "mfu_least": 100.0 * flops["least"] * rate / peak}), flush=True)

    bench = registry.manifest()
    metrics, extra = {}, {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu", "count": cell["chips"]}
    if args.trace:
        reading, brk, dt = _traced(mode, cell, win)
        print("trace " + json.dumps({"units": reading.units, "seconds": dt,
                                     "traced_frames_per_s": reading.units * mode.frames_per_unit / dt,
                                     "window_frames_per_s": rate * mode.frames_per_unit}),
              flush=True)
        for m in registry.metrics_of(args.workload, "per_layer", bench):
            read, suffix = registry.metric_reader(m["name"])
            v = read(reading, suffix)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info["busy_s"] = reading.busy_us * 1e-6
        device_info["window_s"] = reading.window_us * 1e-6
        extra["breakdown"] = brk
    else:
        for m in registry.metrics_of(args.workload, "end_to_end", bench):
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in win["metrics"]:
                v, unit = win["metrics"][m["name"]]
                metrics[m["name"]] = {"value": v, "unit": unit}
    device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated()) if cuda else 0

    mode.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = mode.check()
    correct, compared = compare.judge(numbers, cell["limits"])
    banned = loaded_banned()
    if banned:
        print(f"portbench: loaded after the window: {banned}", file=sys.stderr)
        return 4
    print("check " + json.dumps(numbers), flush=True)
    result = {"correct": correct, "attempted": win["units"], "failed": 0, "metrics": metrics,
              "device": device_info, **extra, "compared": compared}
    print(json.dumps(result), flush=True)
    for name, (v, limit) in compared.items():
        print(f"compared {name} {v!r} limit {limit!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
