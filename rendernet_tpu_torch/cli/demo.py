"""Phong-shading render CLI (PyTorch port).

Counterpart of ``rendernet_tpu/cli/demo.py``: read a 64^3 binvox, render a
normal map for an (azimuth, elevation, radius) pose with the shader net,
Phong-composite it on the host and save a PNG; ``--rotate`` sweeps the
azimuth over 0..355 degrees in steps of 5, ``--sweep_batch`` frames per
forward. Weights come from a flat ``.npz`` of the JAX package's parameter
paths or a reference-format directory of ``*.txt.npz`` files
(``--weights``); without them a seeded random network runs. ``--frozen``
runs a ``torch.export`` artifact from ``convert freeze`` instead, with no
model code. Runs on the CUDA card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os

import numpy as np

AMBIENT_IN = 0.1
K_DIFFUSE = 0.9
LIGHT_COL = np.array([[1.0, 1.0, 1.0]])


def compute_pose_param(azimuth, elevation, radius):
    """Degrees/radius -> (azimuth_rad, theta_rad, scale)."""
    phi = azimuth * math.pi / 180.0
    theta = (90 - elevation) * math.pi / 180.0
    return np.array([[phi, theta, 3.3 / radius]], np.float32)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.ArgumentDefaultsHelpFormatter
    )
    p.add_argument("--voxel_path", type=str, required=True, help="64^3 .binvox file")
    p.add_argument("--azimuth", type=float, default=250)
    p.add_argument("--elevation", type=float, default=60)
    p.add_argument("--light_azimuth", type=float, default=250)
    p.add_argument("--light_elevation", type=float, default=60)
    p.add_argument("--radius", type=float, default=3.3)
    p.add_argument("--render_dir", type=str, default="./render")
    p.add_argument("--rotate", action="store_true",
                   help="render a full 360-degree azimuth sweep (step 5)")
    p.add_argument("--sweep_batch", type=int, default=8,
                   help="frames per forward in --rotate sweeps")
    p.add_argument("--gif", type=str, default="",
                   help="with --rotate: also write the sweep as a GIF here (needs PIL)")
    p.add_argument("--weights", type=str, default="",
                   help=".npz of the JAX package's flat parameter paths, or a reference "
                        "*.txt.npz weight dir")
    p.add_argument("--frozen", type=str, default="",
                   help="frozen torch.export artifact from `convert freeze` (no model code "
                        "or weights needed: the reference's frozen-.pb demo path, "
                        "RenderNet_demo.py:23-30)")
    p.add_argument("--out_channels", type=int, default=None,
                   help="shader head channels (3 = normal-map demo net; default 3)")
    p.add_argument("--arch", type=str, default="",
                   help="ShaderConfig overrides as a JSON file or inline JSON")
    p.add_argument("--fast", action="store_true",
                   help="route the wide res-stack convs through the fused Winograd "
                        "kernel (batches >= 8)")
    p.add_argument("--resample", type=str, default="exact", choices=["exact", "multipass"],
                   help="voxel resample: exact trilinear or the multipass kernel")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain PyTorch path)")
    return p


def _load_arch(text: str, cfg_cls) -> dict:
    if os.path.exists(text):
        with open(text) as f:
            text = f.read()
    arch = {k: tuple(v) if isinstance(v, list) else v for k, v in json.loads(text).items()}
    bad = set(arch) - {f.name for f in dataclasses.fields(cfg_cls)}
    if bad:
        raise SystemExit(f"--arch: unknown ShaderConfig fields {sorted(bad)}")
    return arch


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from rendernet_tpu_torch import resolve_device
    from rendernet_tpu_torch.io.binvox import load_binvox
    from rendernet_tpu_torch.ops.phong import np_generate_light_pos, np_phong_composite
    from rendernet_tpu_torch.utils.image import save_gif, save_image, to_uint8

    device = resolve_device(args.device)
    if args.frozen:
        from rendernet_tpu_torch.compat.frozen import load_frozen

        if args.weights:
            print("NOTE: --frozen overrides --weights (the artifact's baked-in params are used)")
        if args.resample != "exact":
            print("NOTE: --frozen ignores --resample (the artifact's pipeline was fixed at "
                  "freeze time)")
        # its state holds the weights; no model code is imported
        render = frozen = load_frozen(args.frozen, device=device)
    else:
        render = _live_renderer(args, device)

    os.makedirs(args.render_dir, exist_ok=True)
    voxel = load_binvox(args.voxel_path).reshape(1, 64, 64, 64, 1)
    model_name = os.path.basename(args.voxel_path).split(".binvox")[0]
    light_dir = np_generate_light_pos(args.light_elevation, args.light_azimuth)
    vox_cache = {}  # batch size -> voxel batch on the device

    def render_batch(azimuths, counts):
        poses = torch.from_numpy(np.concatenate(
            [compute_pose_param(a, args.elevation, args.radius) for a in azimuths]
        )).to(device)
        if len(azimuths) not in vox_cache:
            vox_cache[len(azimuths)] = torch.from_numpy(
                np.repeat(voxel, len(azimuths), axis=0)).to(device)
        with torch.no_grad():
            maps = render(vox_cache[len(azimuths)], poses).cpu().numpy()
        if maps.shape[-1] == 1:
            imgs = maps[:, :, :, 0]
        else:
            imgs = np_phong_composite(maps, light_dir, LIGHT_COL, AMBIENT_IN, K_DIFFUSE)
        out = []
        for azimuth, count, img in zip(azimuths, counts, imgs):
            if count is None:  # tail padding
                continue
            name = (f"{count:03d}_{model_name}_pose_{azimuth:f}_{args.elevation:f}_"
                    f"{args.radius:f}_light_{args.light_azimuth:f}_"
                    f"{args.light_elevation:f}.png")
            path = os.path.join(args.render_dir, name)
            save_image(to_uint8(img, 255.0), path)
            print(path)
            out.append(img)
        return out

    if args.rotate:
        # a frozen artifact has a fixed batch (`convert freeze --batch`);
        # live nets batch the sweep by --sweep_batch
        bs = frozen.in_shapes[0][0] if args.frozen else max(1, args.sweep_batch)
        azimuths = [float(a) for a in np.arange(0.0, 360.0, 5.0)]
        frames = []
        for start in range(0, len(azimuths), bs):
            chunk = azimuths[start:start + bs]
            counts = list(range(start, start + len(chunk)))
            while len(chunk) < bs:  # pad the tail: reuse the last pose
                chunk = chunk + [chunk[-1]]
                counts = counts + [None]
            frames.extend(render_batch(chunk, counts))
        if args.gif:
            save_gif([to_uint8(f, 255.0) for f in frames], args.gif)
            print(args.gif)
    else:
        chunk, counts = [args.azimuth], [0]
        if args.frozen:  # pad to the artifact's fixed batch
            n = frozen.in_shapes[0][0]
            chunk, counts = chunk + [args.azimuth] * (n - 1), counts + [None] * (n - 1)
        render_batch(chunk, counts)
    return 0


def _live_renderer(args, device):
    """``(voxels, poses) -> normal maps`` of the shader net (``--arch``,
    ``--out_channels``) with ``--weights`` (a flat ``.npz`` or a reference
    weight directory) or, without them, seeded random weights."""
    from rendernet_tpu_torch.compat.jax_params import (jax_params_from_module, load_jax_params,
                                                       load_params_npz)
    from rendernet_tpu_torch.compat.tf_import import (load_reference_weight_dir,
                                                      params_from_weight_dict)
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward
    from rendernet_tpu_torch.nn import layers

    if args.fast:
        layers.WINOGRAD_2D = "pallas"
    arch = _load_arch(args.arch, ShaderConfig) if args.arch else {}
    if ("out_channels" in arch and args.out_channels is not None
            and arch["out_channels"] != args.out_channels):
        raise SystemExit(f"--out_channels {args.out_channels} conflicts with the --arch "
                         f"file's out_channels={arch['out_channels']}; drop one")
    out_channels = 3 if args.out_channels is None else args.out_channels
    cfg = ShaderConfig(**{"out_channels": out_channels, **arch})
    net = init_shader_params(0, cfg, device=device)
    if args.weights and os.path.isdir(args.weights):
        load_jax_params(net, params_from_weight_dict(
            jax_params_from_module(net), load_reference_weight_dir(args.weights), strict=False))
    elif args.weights:
        load_jax_params(net, load_params_npz(args.weights))
    else:
        print("NOTE: no --weights given; rendering with a seeded random net")
    return lambda vox, poses: shader_forward(net, vox, poses, resample=args.resample)


if __name__ == "__main__":
    raise SystemExit(main())
