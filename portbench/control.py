"""The control of a cell's correctness check: the reference in the
program's place in fp8 (``reference/quant.py``), the precision below the
cells' bfloat16. It has to come out as not correct.

    python portbench/control.py --workload <cell> --seeds 1,2,3 [--seconds 2]

For each seed, in one process: the cell's set-up (the program's first
steps, or a short window of requests at the cell's load), the program's
numbers and the control's (or, with ``--fault``, the numbers of the program
with that fault planted, ``faults.py``), each against the cell's limits; one
JSON line a seed. Not part of a benchmark run; ``tests/test_pb_control.py``
runs it on the card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))


def run_seed(cell_name: str, seed: int, seconds: float, device="cuda", fault=None) -> dict:
    """One seed: the program's numbers and the control's; with ``fault``
    (planted once in the process by :func:`main`), the faulty program's
    instead of the control's."""
    import torch

    from portbench import compare, registry
    from portbench.reference.quant import fp8

    cell = registry.workload(cell_name)
    cfg = registry.config(cell["config"])
    mode = registry.mode(cell["mode"])(cell, cfg, seed, device)
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    mode.setup()
    if mode.kind == "render":
        mode.window(seconds)
    mode.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    program = mode.check()
    ok_p, _ = compare.judge(program, cell["limits"])
    out = {"cell": cell_name, "seed": seed, "fault": fault, "program": program,
           "program_correct": ok_p}
    if not fault:
        control = mode.control(fp8)
        out.update(control=control, control_correct=compare.judge(control, cell["limits"])[0])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", default=None, help="plant this fault (faults.py) instead")
    args = p.parse_args(argv)
    if args.fault:
        from portbench import faults, registry

        cell = registry.workload(args.workload)
        kind = registry.mode(cell["mode"]).kind
        faults.plant(kind, registry.config(cell["config"])["model"], args.fault)
    for s in args.seeds.split(","):
        print(json.dumps(run_seed(args.workload, int(s), args.seconds, fault=args.fault)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
