"""Weight and checkpoint conversion CLI (PyTorch port).

Counterpart of ``rendernet_tpu/cli/convert.py`` (the
``demo/RenderNet_converter.py`` analog). Subcommands:

  ckpt-to-npz   -- a training checkpoint of the port (``train/checkpoint.py``)
                   -> one flat ``.npz`` of JAX's parameter paths and layouts;
                   a ``params_latest.npz`` beside the checkpoint is preferred.
  npz-to-refdir -- a flat ``.npz`` -> a reference ``*.txt.npz`` directory.
  refdir-to-npz -- a reference weight directory -> a flat ``.npz`` (``--model``
                   names the network whose parameter paths it fills).
  pb-to-npz     -- a frozen TensorFlow GraphDef (the reference's released
                   format; needs tensorflow) -> a flat ``.npz``.
  freeze        -- a flat ``.npz`` or a reference weight directory -> a frozen
                   ``torch.export`` artifact of the shader render with the
                   weights as its state (``compat/frozen.py``; the
                   ``demo/RenderNet_converter.py:3-18`` frozen-``.pb`` analog),
                   which ``render --frozen`` runs with no model code.

The ``--model`` templates are the port's freshly initialised networks, built
on the CPU (only their parameter paths and shapes are read). ``freeze``
traces on ``--device`` (the card unless ``--device cpu``).
"""
from __future__ import annotations

import argparse
import os

MODELS = ["shader", "texture", "recon-renderer", "shape-decoder", "recon-texture"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    c1 = sub.add_parser("ckpt-to-npz")
    c1.add_argument("checkpoint", type=str)
    c1.add_argument("out", type=str)

    c2 = sub.add_parser("npz-to-refdir")
    c2.add_argument("npz", type=str)
    c2.add_argument("out_dir", type=str)

    c3 = sub.add_parser("refdir-to-npz")
    c3.add_argument("weight_dir", type=str)
    c3.add_argument("out", type=str)
    c3.add_argument("--model", type=str, default="shader", choices=MODELS)

    c5 = sub.add_parser("pb-to-npz")
    c5.add_argument("pb", type=str, help="frozen GraphDef (the reference's released format)")
    c5.add_argument("out", type=str)
    c5.add_argument("--model", type=str, default="shader", choices=MODELS)
    c5.add_argument("--out_channels", type=int, default=3,
                    help="shader head width (the released demo pb is the 3-channel "
                         "normal-map net)")
    c5.add_argument("--allow-missing", action="store_true",
                    help="tolerate params the pb doesn't provide (they keep the "
                         "template's init; a WARNING reports the count)")

    c4 = sub.add_parser("freeze")
    c4.add_argument("weights", type=str, help=".npz params file or reference *.txt.npz weight dir")
    c4.add_argument("out", type=str)
    c4.add_argument("--batch", type=int, default=1)
    c4.add_argument("--voxel_size", type=int, default=64)
    c4.add_argument("--out_channels", type=int, default=3)
    c4.add_argument("--platforms", type=str, default="",
                    help="comma-separated devices the artifact is checked on (cpu, cuda; "
                         "default: the CPU and, where there is one, the card)")
    c4.add_argument("--device", type=str, default=None,
                    help="torch device to trace on (default: cuda)")
    return p


def template(model: str, out_channels: int = 1):
    """The flat JAX-layout parameter dict of ``model``'s fresh network (on
    the CPU): its paths and shapes are the template a conversion fills."""
    from rendernet_tpu_torch.compat.jax_params import jax_params_from_module

    if model == "shader":
        from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params

        net = init_shader_params(0, ShaderConfig(out_channels=out_channels), device="cpu")
    elif model == "texture":
        from rendernet_tpu_torch.models.texture_face import (TextureFaceConfig,
                                                             init_texture_face_params)

        net = init_texture_face_params(0, TextureFaceConfig(), device="cpu")
    else:
        from rendernet_tpu_torch.models import decoders

        init = {"recon-renderer": decoders.init_recon_rendernet_params,
                "shape-decoder": decoders.init_shape_decoder_params,
                "recon-texture": decoders.init_recon_texture_decoder_params}[model]
        net = init(0, device="cpu")
    return jax_params_from_module(net)


def load_weights(weights: str, out_channels: int):
    """A flat ``.npz`` as it is, or a reference weight directory on the
    shader's template (missing keys keep the template's values)."""
    from rendernet_tpu_torch.compat.jax_params import load_params_npz
    from rendernet_tpu_torch.compat.tf_import import (load_reference_weight_dir,
                                                      params_from_weight_dict)

    if os.path.isdir(weights):
        return params_from_weight_dict(template("shader", out_channels),
                                       load_reference_weight_dir(weights), strict=False)
    return load_params_npz(weights)


def main(argv=None):
    args = build_parser().parse_args(argv)

    from rendernet_tpu_torch.compat.jax_params import jax_params_from_state_dict, load_params_npz
    from rendernet_tpu_torch.compat.tf_import import (export_reference_weight_dir,
                                                      load_reference_weight_dir,
                                                      params_from_weight_dict)
    from rendernet_tpu_torch.train.checkpoint import restore_checkpoint, save_params_npz

    if args.cmd == "freeze":
        from rendernet_tpu_torch import resolve_device
        from rendernet_tpu_torch.compat.frozen import freeze_shader_render, save_frozen
        from rendernet_tpu_torch.models.shader import ShaderConfig

        device = resolve_device(args.device)
        platforms = [p for p in args.platforms.split(",") if p.strip()] or None
        frozen = freeze_shader_render(load_weights(args.weights, args.out_channels),
                                      ShaderConfig(out_channels=args.out_channels),
                                      batch=args.batch, voxel_size=args.voxel_size,
                                      platforms=platforms, device=device)
        save_frozen(frozen, args.out)
        print(f"froze shader render ({','.join(frozen.platforms)}) to {args.out}")
    elif args.cmd == "ckpt-to-npz":
        # training runs write a params npz beside the checkpoint: prefer it
        sibling = os.path.join(os.path.dirname(args.checkpoint), "params_latest.npz")
        if os.path.exists(sibling):
            params = load_params_npz(sibling)
        else:
            params = jax_params_from_state_dict(restore_checkpoint(args.checkpoint)["params"])
        save_params_npz(args.out, params)
        print(f"wrote {len(params)} entries to {args.out}")
    elif args.cmd == "npz-to-refdir":
        params = load_params_npz(args.npz)
        export_reference_weight_dir(params, args.out_dir)
        print(f"wrote {len(params)} weight files to {args.out_dir}")
    elif args.cmd == "pb-to-npz":
        from rendernet_tpu_torch.compat.pb_import import params_from_frozen_pb

        params = params_from_frozen_pb(template(args.model, args.out_channels), args.pb,
                                       strict=not args.allow_missing)
        save_params_npz(args.out, params)
        print(f"wrote {len(params)} params to {args.out}")
    else:
        params = params_from_weight_dict(template(args.model),
                                         load_reference_weight_dir(args.weight_dir),
                                         strict=False)
        save_params_npz(args.out, params)
        print(f"wrote {len(params)} params to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
