"""Shader-workload trainer CLI: ``python -m rendernet_tpu_torch.cli
train-shader config.json [--max-steps N] [--device cpu]``
(RenderNet_Shader.py invocation parity). Trains on the CUDA card unless
``--device cpu``; on several processes (one per card) with ``--coordinator
host:port --num-processes N --process-id i`` on each, or under torchrun."""
from __future__ import annotations

from rendernet_tpu_torch.cli._train_common import build_parser as _build_parser
from rendernet_tpu_torch.cli._train_common import run


def build_parser():
    return _build_parser(__doc__)


def main(argv=None) -> int:
    from rendernet_tpu_torch.train.loop import train_shader

    return run(argv, __doc__, train_shader)


if __name__ == "__main__":
    main()
