"""Train and eval steps of the shader workload.

Counterpart of the shader parts of ``rendernet_tpu/train/steps.py``
(:55-305). Loss semantics mirror the reference graphs: greyscale is the
summed-per-image BCE, mean over the batch (RenderNet_Shader.py:160-161, with
the 1e-6 log guards); RGB is the mean squared error (:163).

The JAX package jits one pure step per patch size and donates the state.
Here a step is eager PyTorch: the parameters are the network's own tensors,
updated in place, and the optimizer state is replaced each step; nothing in
a step reads the device from the host, so consecutive steps queue on the
card. The resample runs outside autograd (the shader step differentiates
neither voxels nor pose), and at a patch size below ``new_size`` the crop is
fused into it as in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rendernet_tpu_torch.models.shader import ShaderConfig, ShaderRenderNet, init_shader_params
from rendernet_tpu_torch.ops.crops import crop_image, random_crop_offsets
from rendernet_tpu_torch.ops.cuda_resample import (
    rotate_resample_camera_patch_multipass,
    rotate_resample_to_camera_multipass,
)
from rendernet_tpu_torch.ops.resample import (
    rotate_resample_camera_patch,
    rotate_resample_to_camera,
)
from rendernet_tpu_torch.train.config import TrainConfig
from rendernet_tpu_torch.train.optim import GradientTransformation, apply_updates, make_optimizer

__all__ = [
    "TrainState",
    "create_shader_state",
    "make_shader_train_step",
    "make_shader_eval_step",
    "shader_loss_from_images",
    "step_seeds",
]


@dataclasses.dataclass
class TrainState:
    """``params`` is the network (its parameters are updated in place);
    ``opt_state`` the optimizer's state; ``step`` a host int."""

    params: ShaderRenderNet
    opt_state: object
    step: int = 0


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _resample_method(cfg: TrainConfig, device: torch.device) -> str:
    """``"auto"``: the multipass pass plan (K1) on CUDA, the exact path on the
    CPU, as JAX's ``auto`` takes multipass on a TPU."""
    if cfg.resample == "auto":
        return "multipass" if device.type == "cuda" else "exact"
    if cfg.resample not in ("exact", "multipass"):
        raise ValueError(f"resample must be 'auto', 'exact' or 'multipass', got {cfg.resample!r}")
    return cfg.resample


@torch.no_grad()
def _resample_full(voxels, poses, cfg: TrainConfig):
    """Full camera-aligned grid via the configured resample."""
    if _resample_method(cfg, voxels.device) == "multipass":
        return rotate_resample_to_camera_multipass(
            voxels, poses, new_size=cfg.new_size, max_scale=cfg.pose_scale_limit,
            compute_dtype=_dtype(cfg.compute_dtype))
    return rotate_resample_to_camera(voxels, poses, new_size=cfg.new_size)


@torch.no_grad()
def _resample_patch(voxels, poses, offsets, patch_size: int, cfg: TrainConfig):
    """Cropped camera-aligned patch; both paths fuse the crop into the
    resample (the exact path gathers only the window; the multipass path's
    last pass of each cropped axis emits only the window)."""
    if _resample_method(cfg, voxels.device) == "multipass":
        return rotate_resample_camera_patch_multipass(
            voxels, poses, offsets, patch_size, new_size=cfg.new_size,
            max_scale=cfg.pose_scale_limit, compute_dtype=_dtype(cfg.compute_dtype))
    return rotate_resample_camera_patch(voxels, poses, offsets, patch_size,
                                        new_size=cfg.new_size)


def _as_f32_image(images: torch.Tensor) -> torch.Tensor:
    """uint8 in [0, 255] (the compact host-to-device feed) or float in [0, 1]."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 255.0
    return images.to(torch.float32)


def shader_loss_from_images(pred: torch.Tensor, target: torch.Tensor,
                            greyscale: bool) -> torch.Tensor:
    pred = pred.to(torch.float32)
    target = target.to(torch.float32)
    if greyscale:
        bce = target * torch.log(1e-6 + pred) + (1.0 - target) * torch.log(1e-6 + 1.0 - pred)
        return torch.mean(-torch.sum(bce, dim=(1, 2, 3)))
    return torch.mean((pred - target) ** 2)


def create_shader_state(seed, model_cfg: ShaderConfig, cfg: TrainConfig,
                        device=None) -> Tuple[TrainState, GradientTransformation]:
    """A fresh network (seed: an int or a CPU ``torch.Generator``) on
    ``device`` (CUDA unless the caller asks for the CPU), the optimizer and
    its state."""
    net = init_shader_params(seed, model_cfg, device=device)
    tx = make_optimizer(cfg.e_eta, cfg.decay_steps, cfg.decay_rate,
                        skip_nonfinite=cfg.skip_nonfinite_updates,
                        moment_dtype=cfg.moment_dtype)
    return TrainState(net, tx.init(dict(net.named_parameters()))), tx


def step_seeds(rng: int, step: int) -> Tuple[int, int]:
    """(crop seed, dropout seed) of one step: the step's counterpart of
    ``fold_in(rng, step)`` and ``split``, from numpy's ``SeedSequence``."""
    crop, drop = np.random.SeedSequence([int(rng) & 0xFFFFFFFF, int(step)]).generate_state(2)
    return int(crop), int(drop)


def make_shader_train_step(model_cfg: ShaderConfig, cfg: TrainConfig,
                           tx: GradientTransformation, patch_size: int, mesh=None):
    """Build the training step for one patch size:

        step(state, voxels [B,64,64,64,1], images [B,512,512,C] in [0,1] or
             uint8, poses [B,3], rng: int, offsets=None) -> (state, loss)

    ``loss`` is a 0-d fp32 tensor on the device (reading it waits for the
    step). At ``patch_size < new_size`` the step crops at ``offsets`` (u0,
    v0) when given, else at offsets drawn from the step's crop seed
    (:func:`step_seeds`); dropout draws from its dropout seed.
    ``cfg.grad_accum_steps > 1`` splits the batch into that many
    microbatches, sums their fp32 gradients and applies one update, with
    the crop and the dropout seed shared, as in JAX. A ``mesh`` or the bf16
    all-reduce belong to distributed training, which is not ported yet.
    """
    if mesh is not None or cfg.allreduce_dtype == "bfloat16":
        raise NotImplementedError("distributed training (a mesh, the bf16 all-reduce) "
                                  "is not ported yet")
    cdt = _dtype(cfg.compute_dtype)
    greyscale = cfg.is_greyscale
    accum = cfg.grad_accum_steps

    def loss_fn(net, voxels, images, poses, offsets, drop_seed):
        voxels = voxels.to(torch.float32)
        images = _as_f32_image(images)
        if patch_size == cfg.new_size:
            vox_c = _resample_full(voxels, poses, cfg)
            img_c = images
        else:
            vox_c = _resample_patch(voxels, poses, offsets, patch_size, cfg)
            img_c = crop_image(images, offsets, patch_size, images.shape[1] // cfg.new_size)
        gen = None
        if model_cfg.keep_prob < 1.0:
            gen = torch.Generator(device=voxels.device).manual_seed(drop_seed)
        pred = net(vox_c.to(cdt), train=True, generator=gen, cfg=model_cfg)
        return shader_loss_from_images(pred, img_c, greyscale)

    def step(state: TrainState, voxels, images, poses, rng: int,
             offsets: Optional[Sequence[int]] = None):
        net = state.params
        params = dict(net.named_parameters())
        crop_seed, drop_seed = step_seeds(rng, state.step)
        if patch_size != cfg.new_size and offsets is None:
            offsets = random_crop_offsets(torch.Generator().manual_seed(crop_seed),
                                          cfg.new_size, patch_size)
        b = voxels.shape[0]
        if b % accum:
            raise ValueError(f"batch size {b} not divisible by grad_accum={accum}")
        mb = b // accum
        loss_sum, grad_sum = None, None
        for i in range(accum):
            sl = slice(i * mb, (i + 1) * mb)
            loss = loss_fn(net, voxels[sl], images[sl], poses[sl], offsets, drop_seed)
            grads = torch.autograd.grad(loss, list(params.values()))
            if accum == 1:
                loss_sum, grad_sum = loss.detach(), grads
                break
            grads = [g.to(torch.float32) for g in grads]
            if grad_sum is None:
                loss_sum, grad_sum = loss.detach().to(torch.float32), grads
            else:
                loss_sum = loss_sum + loss.detach()
                grad_sum = [s + g for s, g in zip(grad_sum, grads)]
        if accum > 1:
            scale = 1.0 / accum
            loss_sum = loss_sum * scale
            grad_sum = [g * scale for g in grad_sum]
        grads = dict(zip(params, grad_sum))
        updates, opt_state = tx.update(grads, state.opt_state, params)
        apply_updates(params, updates)
        return TrainState(net, opt_state, state.step + 1), loss_sum

    return step


def make_shader_eval_step(model_cfg: ShaderConfig, cfg: TrainConfig):
    """Full-resolution inference step: (net, voxels, poses) -> images
    ``[B, 4N, 4N, C]`` fp32, no dropout, no gradients."""
    cdt = _dtype(cfg.compute_dtype)

    @torch.no_grad()
    def step(net: ShaderRenderNet, voxels, poses):
        cam = _resample_full(voxels.to(torch.float32), poses, cfg)
        return net(cam.to(cdt), cfg=model_cfg)

    return step
