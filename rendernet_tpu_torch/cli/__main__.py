"""Dispatcher: ``python -m rendernet_tpu_torch.cli <command> [args...]``."""
from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "render": "rendernet_tpu_torch.cli.demo",
    "train-shader": "rendernet_tpu_torch.cli.train_shader",
    "train-texture": "rendernet_tpu_torch.cli.train_texture",
    "reconstruct": "rendernet_tpu_torch.cli.reconstruct",
    "pack-tar": "rendernet_tpu_torch.cli.pack_tar",
    "convert": "rendernet_tpu_torch.cli.convert",
}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:")
        for name in COMMANDS:
            print(f"  {name}")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command: {cmd!r}; one of {list(COMMANDS)}", file=sys.stderr)
        return 2
    return importlib.import_module(COMMANDS[cmd]).main(rest)


if __name__ == "__main__":
    sys.exit(main())
