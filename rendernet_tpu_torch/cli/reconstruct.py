"""Inverse-rendering CLI (PyTorch port).

Counterpart of ``rendernet_tpu/cli/reconstruct.py``: read the
reconstruction JSON config, load the three pretrained networks (the
reference's ``*.txt.npz`` weight directories, ``weight_dir`` and
``weight_dir_decoder``; ``--random-weights`` runs seeded random ones), build
the shaded target from the ground-truth albedo and normal PNGs with the
host-side Phong composite, and run the coarse-to-fine latent search,
writing ``shaded_target.png``, per-epoch and per-chunk PNG + binvox dumps,
``metrics.jsonl`` and ``loss_history.npz`` into ``sample_save``. Runs on
the CUDA card, in bf16 with the multipass warp, unless ``--device cpu``
(float32, exact warp).
"""
from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", type=str, help="reconstruction JSON config")
    p.add_argument("--random-weights", action="store_true",
                   help="use seeded random nets (pipeline smoke mode)")
    p.add_argument("--dump-every", type=int, default=100,
                   help="intermediate dump/log interval in inner steps (the reference "
                        "dumps every 100); 0 disables")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs the plain PyTorch path)")
    return p


def _read_target(path: str, res: int) -> np.ndarray:
    """An RGB(A) PNG as ``[1, res, res, 3]`` in [0, 1], resized bilinearly
    (PIL) when it has another size."""
    from rendernet_tpu_torch.utils.image import decode_image

    with open(path, "rb") as f:
        img = decode_image(f.read())[:, :, :3]
    if img.shape[:2] != (res, res):
        from PIL import Image

        img = np.asarray(Image.fromarray(img).resize((res, res), Image.BILINEAR))
    return img.reshape(1, res, res, 3) / 255.0


def load_reference_weights(model, weight_dir: str, weight_dir_decoder: str) -> None:
    """Fill the three networks of ``model`` in place from the reference's
    weight directories: the renderer and the texture decoder from
    ``weight_dir``, the shape decoder from ``weight_dir_decoder``. Keys the
    directories lack keep the networks' own values, as in the JAX CLI
    (``params_from_weight_dict(strict=False)``)."""
    from rendernet_tpu_torch.compat.jax_params import jax_params_from_module, load_jax_params
    from rendernet_tpu_torch.compat.tf_import import (
        load_reference_weight_dir,
        params_from_weight_dict,
    )

    wd_render = load_reference_weight_dir(weight_dir)
    wd_decoder = load_reference_weight_dir(weight_dir_decoder)
    for net, wd in ((model.decoder, wd_decoder), (model.texture, wd_render),
                    (model.renderer, wd_render)):
        load_jax_params(net, params_from_weight_dict(jax_params_from_module(net), wd,
                                                     strict=False))


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    from rendernet_tpu_torch import resolve_device
    from rendernet_tpu_torch.io.binvox import save_binvox
    from rendernet_tpu_torch.models.decoders import (
        init_recon_rendernet_params,
        init_recon_texture_decoder_params,
        init_shape_decoder_params,
    )
    from rendernet_tpu_torch.ops.phong import np_phong_composite
    from rendernet_tpu_torch.recon.inverse import (
        ReconConfig,
        ReconModel,
        recon_forward,
        reconstruct,
    )
    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.utils.image import save_image, to_uint8

    device = resolve_device(args.device)
    cfg = TrainConfig.from_json(args.config)
    rcfg = ReconConfig(
        compute_dtype="bfloat16" if device.type == "cuda" else "float32",
        z_dim=cfg.z_dim,
        batch_size=cfg.batch_size,
        inner_steps=cfg.inner_step,
        max_epochs=cfg.max_epochs,
        new_size=cfg.new_size,
        shape_eta=cfg.shape_eta,
        pose_eta=cfg.pose_eta,
        tex_eta=cfg.tex_eta,
        light_eta=cfg.light_eta,
        light_elevation=(90 - cfg.target_elevation_light) * math.pi / 180.0,
    )
    os.makedirs(cfg.sample_save, exist_ok=True)

    model = ReconModel(
        decoder=init_shape_decoder_params(0, z_dim=rcfg.z_dim, device=device),
        texture=init_recon_texture_decoder_params(1, device=device),
        renderer=init_recon_rendernet_params(2, new_size=rcfg.new_size, device=device),
    )
    if not args.random_weights:
        load_reference_weights(model, cfg.weight_dir, cfg.weight_dir_decoder)

    # the shaded target from the ground-truth albedo and normal (:435-447)
    res = 4 * rcfg.new_size
    target = _read_target(cfg.target_albedo, res)
    target_normal = _read_target(cfg.target_normal, res)
    elevation_gt = (90 - cfg.target_elevation_light) * math.pi / 180.0
    azimuth_gt = cfg.target_azimuth_light * math.pi / 180.0
    light_dir = np.array([[np.sin(elevation_gt) * np.cos(azimuth_gt),
                           np.sin(elevation_gt) * np.sin(azimuth_gt),
                           np.cos(elevation_gt)]])
    shading = np_phong_composite(target_normal, light_dir, np.array([[1.0, 1.0, 1.0]]), 0.0,
                                 1.0, background_col="white", with_mask=True)
    target_compos = target * shading
    save_image(to_uint8(target_compos[0], 255.0),
               os.path.join(cfg.sample_save, "shaded_target.png"))
    target_batch = torch.as_tensor(np.tile(target_compos, (rcfg.batch_size, 1, 1, 1)),
                                   dtype=torch.float32, device=device)

    metrics_path = os.path.join(cfg.sample_save, "metrics.jsonl")

    def save_best(latents, best, tag):
        with torch.no_grad():
            compos, _, _, shape = recon_forward(model, latents, rcfg)
        save_image(to_uint8(compos[best].float().cpu().numpy(), 255.0),
                   os.path.join(cfg.sample_save, tag + ".png"))
        save_binvox(shape[best].float().cpu().numpy().reshape(64, 64, 64) > cfg.threshold,
                    os.path.join(cfg.sample_save, tag + ".binvox"))

    def dump(epoch, latents, losses):
        best = int(losses.argmin())
        pose_deg = latents.pose[best].cpu().numpy() * 180.0 / math.pi
        save_best(latents, best, f"epoch{epoch}_p{pose_deg[0]:.1f}_t{90 - pose_deg[1]:.1f}"
                                 f"_loss{losses[best]:.5f}")
        print(f"epoch {epoch}: best hypothesis {best} loss {losses[best]:.5f}")

    def inner_dump(epoch, inner_step, latents, losses_chunk):
        """Per-chunk losses into metrics.jsonl, and a best-hypothesis dump at
        each chunk boundary inside the epoch (:497-519)."""
        final = losses_chunk[-1]
        best = int(final.argmin())
        with open(metrics_path, "a") as f:
            f.write(json.dumps({"epoch": epoch, "inner_step": inner_step,
                                "losses": [float(x) for x in final], "best": best}) + "\n")
        if inner_step < rcfg.inner_steps:  # the epoch's end is dump()'s
            save_best(latents, best, f"epoch{epoch}_step{inner_step}")

    dump_every = args.dump_every if args.dump_every > 0 else None
    if dump_every is not None and rcfg.inner_steps % dump_every:
        dump_every = None  # one chunk per epoch
    latents, history, curves = reconstruct(
        model, target_batch, rcfg, callback=dump, dump_every=dump_every,
        inner_callback=inner_dump if dump_every is not None else None)
    np.savez(os.path.join(cfg.sample_save, "loss_history.npz"), final=history, curves=curves)
    print("Reconstruction done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
