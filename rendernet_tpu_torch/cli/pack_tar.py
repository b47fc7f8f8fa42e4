"""Pack an image directory into a training tar (tools/create_TAR.py parity):
``python -m rendernet_tpu_torch.cli pack-tar --images_path DIR --save_path
images.tar``. Host work only, as the JAX CLI's; it takes ``--device`` as
the port's other CLIs do and checks it the same way (the card unless
``--device cpu``), so that one command line moves between them."""
from __future__ import annotations

import argparse
import glob
import os
import tarfile


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--images_path", type=str, required=True)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--file_format", type=str, default="*.png")
    p.add_argument("--to_compress", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' on a machine with no card)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from rendernet_tpu_torch import resolve_device

    resolve_device(args.device)
    mode = "w:gz" if args.to_compress else "w"
    all_images = sorted(glob.glob(os.path.join(args.images_path, args.file_format)))
    print(f"Found {len(all_images)} images")
    with tarfile.open(args.save_path, mode) as tar:
        for item in all_images:
            tar.add(item, arcname=os.path.basename(item), recursive=False)
    print(f"Wrote {args.save_path}")
    return 0


if __name__ == "__main__":
    main()
