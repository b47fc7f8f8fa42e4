"""What the two trainer CLIs share: JAX's arguments plus ``--device``."""
from __future__ import annotations

import argparse


def build_parser(doc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("config", type=str, help="path to a JSON training config")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--no-mesh", action="store_true",
                   help="disable the data-parallel mesh (refused with more than one process)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="multi-process coordinator address host:port (or a tcp:// / file:// "
                        "URL; or set JAX_COORDINATOR_ADDRESS, or launch with torchrun)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda, the rank's card in a process group; "
                        "'cpu' runs the plain PyTorch path)")
    return p


def run(argv, doc: str, train) -> int:
    """Parse ``argv``, join the process group the multi-process options (or
    torchrun's environment) name, as JAX's CLIs call ``initialize_multihost``,
    and call ``train`` (``train_shader`` or ``train_texture``) on the JSON
    config; the group is torn down on the way out."""
    import torch.distributed as dist

    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.train.distributed import initialize_multihost

    args = build_parser(doc).parse_args(argv)
    joined = initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                  device=args.device)
    try:
        train(TrainConfig.from_json(args.config), max_steps=args.max_steps,
              use_mesh=not args.no_mesh, device=args.device,
              progress=lambda step, loss: step % 20 == 0 and print(f"Step {step} Loss {float(loss)}"))
    finally:
        if joined:
            dist.destroy_process_group()
    return 0
