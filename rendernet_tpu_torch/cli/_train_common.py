"""What the two trainer CLIs share: JAX's arguments plus ``--device``."""
from __future__ import annotations

import argparse


def build_parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("config", type=str, help="path to a JSON training config")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--no-mesh", action="store_true",
                   help="accepted for the JAX CLI's sake: the port trains on one card")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-process coordinator address host:port (not ported yet)")
    p.add_argument("--num-processes", type=int, default=None, help="(not ported yet)")
    p.add_argument("--process-id", type=int, default=None, help="(not ported yet)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain PyTorch path)")
    return p


def run(argv, doc: str, train) -> int:
    """Parse ``argv``, refuse the multi-process options, and call ``train``
    (``train_shader`` or ``train_texture``) on the JSON config."""
    args = build_parser(doc).parse_args(argv)
    if any(v is not None for v in (args.coordinator, args.num_processes, args.process_id)):
        raise NotImplementedError("multi-process training (--coordinator, --num-processes, "
                                  "--process-id) is not ported yet (ROADMAP.md queue 1 item 6)")
    from rendernet_tpu_torch.train.config import TrainConfig

    train(TrainConfig.from_json(args.config), max_steps=args.max_steps,
          use_mesh=not args.no_mesh, device=args.device,
          progress=lambda step, loss: step % 20 == 0 and print(f"Step {step} Loss {float(loss)}"))
    return 0
