"""Texture/normal face trainer CLI: ``python -m rendernet_tpu_torch.cli
train-texture config.json [--max-steps N] [--device cpu]``
(RenderNet_Texture_Face_Normal.py parity). Trains on the CUDA card unless
``--device cpu``; on several processes (one per card) with ``--coordinator
host:port --num-processes N --process-id i`` on each, or under torchrun."""
from __future__ import annotations

from rendernet_tpu_torch.cli._train_common import build_parser as _build_parser
from rendernet_tpu_torch.cli._train_common import run


def build_parser():
    return _build_parser(__doc__)


def main(argv=None) -> int:
    from rendernet_tpu_torch.train.loop import train_texture

    return run(argv, __doc__, train_texture)


if __name__ == "__main__":
    main()
