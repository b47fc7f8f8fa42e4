"""Train and eval steps of the shader and texture/face workloads.

Counterpart of ``rendernet_tpu/train/steps.py``. Loss semantics mirror the
reference graphs: greyscale is the summed-per-image BCE, mean over the
batch (RenderNet_Shader.py:160-161, with the 1e-6 log guards); RGB is the
mean squared error (:163); the texture/face loss is MSE(albedo) +
MSE(normal) (RenderNet_Texture_Face_Normal.py:182-183).

The JAX package jits one pure step per patch size and donates the state.
Here a step is eager PyTorch: the parameters are the network's own tensors,
updated in place, as are Adam's moments on the card
(``optim.update_and_apply``); nothing in a step reads the device from the
host, so consecutive steps queue on the card. The shape grid's resample
runs outside autograd (no step differentiates voxels or pose), and at a
patch size below ``new_size`` the crop is fused into it as in JAX. The
texture step's decoded texture grid is warped under autograd, so its
gradient reaches the decoder through K4's voxel cotangent.

Data parallelism: a step built with a ``mesh`` whose data axis is above 1
(``train.distributed.make_mesh``) runs on each rank on that rank's rows and
all-reduces the loss and the gradients after accumulation, before the
update (``distributed.all_reduce_mean``; the gradients in bf16 with
``cfg.allreduce_dtype="bfloat16"``, as JAX's shard_map path), so every
rank applies the same update. The crop comes from the shared step seed;
the dropout seed is folded with the rank, as JAX's ``fold_in(axis_index)``.

Spatial sharding: with a model axis above 1 each rank of a model group
takes its rows of the voxels and the images (JAX's ``P("data", "model")``),
all-gathers them over the model axis, warps its slab of the camera grid's
rows with e_conv1's halo and renders its slab of the image rows
(``models/shader.py``). Its loss is its rows' share: greyscale, the BCE
summed over its rows per image, mean over its batch rows; RGB, its
squared errors over the whole image's element count. The loss and the
gradients (partial sums over the rows, since every gradient is linear in
the cotangents) are summed over the model axis in fp32, then averaged over
the data axis as without one (in ``cfg.allreduce_dtype``; JAX's bf16 path
reduces over ``data`` only, so the model-axis sum stays fp32). The crop is
shared, and the dropout seed is folded with the data rank only, so the
ranks of a model group draw the rows of one mask. The texture step shards
the same way (:func:`texture_loss`): every rank decodes the whole texture
grid, and the model-axis sum of the gradients completes the decoder's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from rendernet_tpu_torch.models.shader import (
    ShaderConfig,
    ShaderRenderNet,
    init_shader_params,
    slab_rows,
)
from rendernet_tpu_torch.models.texture_face import (
    TextureFaceConfig,
    TextureFaceRenderNet,
    init_texture_face_params,
    texture_decoder,
)
from rendernet_tpu_torch.ops.crops import crop_image, random_crop_offsets
from rendernet_tpu_torch.ops.cuda_resample import (
    rotate_resample_camera_patch_multipass,
    rotate_resample_to_camera_multipass,
)
from rendernet_tpu_torch.ops.resample import (
    rotate_resample_camera_patch,
    rotate_resample_to_camera,
)
from rendernet_tpu_torch.train import distributed
from rendernet_tpu_torch.train.config import TrainConfig
from rendernet_tpu_torch.train.optim import (
    GradientTransformation,
    make_optimizer,
    update_and_apply,
)
from rendernet_tpu_torch.utils.spans import span

__all__ = [
    "TrainState",
    "create_shader_state",
    "make_shader_train_step",
    "make_shader_eval_step",
    "create_texture_state",
    "make_texture_train_step",
    "texture_loss",
    "shader_loss_from_images",
    "step_seeds",
]


@dataclasses.dataclass
class TrainState:
    """``params`` is the network (its parameters are updated in place);
    ``opt_state`` the optimizer's state; ``step`` a host int."""

    params: ShaderRenderNet | TextureFaceRenderNet
    opt_state: object
    step: int = 0


# Texture step: resample the channel-concatenated shape + texture grid in
# ONE warp when their resolutions match (the warp is linear and per
# channel, so the result is the same), as JAX's module switch of the same
# name (steps.py:59-68). Off by default, as in JAX: the fused form drags
# the shape channel into the differentiated warp, whose adjoint (K4) then
# runs on 5 channels instead of 4.
FUSE_TEXTURE_RESAMPLE = False


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


def _resample_full(voxels, poses, cfg: TrainConfig):
    """Full camera-aligned grid via the configured resample (differentiable
    where grad mode is on)."""
    with span("warp"):
        if _resample_method(cfg, voxels.device) == "multipass":
            return rotate_resample_to_camera_multipass(
                voxels, poses, new_size=cfg.new_size, max_scale=cfg.pose_scale_limit,
                compute_dtype=_dtype(cfg.compute_dtype))
        return rotate_resample_to_camera(voxels, poses, new_size=cfg.new_size)


def _resample_patch(voxels, poses, offsets, patch_size: int, cfg: TrainConfig, rows=None):
    """Cropped camera-aligned patch; both paths fuse the crop into the
    resample (the exact path gathers only the window; the multipass path's
    last pass of each cropped axis emits only the window). ``rows``: only
    those rows of the patch (a rank's slab and halo)."""
    with span("warp"):
        if _resample_method(cfg, voxels.device) == "multipass":
            return rotate_resample_camera_patch_multipass(
                voxels, poses, offsets, patch_size, new_size=cfg.new_size,
                max_scale=cfg.pose_scale_limit, compute_dtype=_dtype(cfg.compute_dtype),
                rows=rows)
        return rotate_resample_camera_patch(voxels, poses, offsets, patch_size,
                                            new_size=cfg.new_size, rows=rows)


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


def _step_offsets(state: TrainState, rng: int, patch_size: int, cfg: TrainConfig, offsets,
                  mesh):
    """(crop offsets or None, dropout seed) of one step (:func:`step_seeds`);
    with a data axis above 1 the dropout seed is folded with the data rank,
    so no two data ranks draw the same mask (the crop stays shared; the
    ranks of a model axis share the seed)."""
    crop_seed, drop_seed = step_seeds(rng, state.step)
    if mesh is not None and mesh.shape["data"] > 1:
        rank = torch.distributed.get_rank(mesh.group)
        drop_seed = int(np.random.SeedSequence([drop_seed, rank]).generate_state(1)[0])
    if patch_size != cfg.new_size and offsets is None:
        offsets = random_crop_offsets(torch.Generator().manual_seed(crop_seed),
                                      cfg.new_size, patch_size)
    return offsets, drop_seed


def _data_parallel(mesh):
    """The mesh when the step reduces over ranks (its data or model axis
    above 1), else None. A step without a mesh inside a group of more than
    one rank raises: its ranks would train apart. ``allreduce_dtype`` takes
    effect only with a data axis above 1, as JAX's
    ``_use_bf16_allreduce``."""
    n = distributed.world()[1]
    if mesh is None:
        if n > 1:
            raise RuntimeError(f"a train step without a mesh in a process group of {n} ranks: "
                               "each rank would train apart; build it with "
                               "mesh=train.distributed.make_mesh()")
        return None
    return mesh if mesh.shape["data"] > 1 or mesh.shape["model"] > 1 else None


def _apply_step(state: TrainState, tx: GradientTransformation, batch: int, accum: int,
                micro_loss, mesh, allreduce_dtype: str) -> Tuple[TrainState, torch.Tensor]:
    """One update from ``micro_loss(slice) -> loss`` over ``accum``
    microbatches of a batch of ``batch``: their fp32 gradients summed and
    averaged, as JAX's ``_accumulated_value_and_grad``; with a
    ``mesh`` the loss and the gradients are then summed over its model axis
    (fp32) and averaged over its data axis (the gradients moved in
    ``allreduce_dtype``)."""
    net = state.params
    params = dict(net.named_parameters())
    if batch % accum:
        raise ValueError(f"batch size {batch} not divisible by grad_accum={accum}")
    mb = batch // accum
    loss_sum, grad_sum = None, None
    for i in range(accum):
        loss = micro_loss(slice(i * mb, (i + 1) * mb))
        with span("backward"):
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
    if mesh is not None and mesh.shape["model"] > 1:
        *grad_sum, loss_sum = distributed.model_sum([*grad_sum, loss_sum], mesh)
    if mesh is not None and mesh.shape["data"] > 1:
        grad_sum = distributed.all_reduce_mean(grad_sum, mesh, _dtype(allreduce_dtype))
        loss_sum = distributed.all_reduce_mean([loss_sum], mesh)[0]
    with span("update"):
        opt_state = update_and_apply(tx, dict(zip(params, grad_sum)), state.opt_state, params)
    return TrainState(net, opt_state, state.step + 1), loss_sum


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
    the crop and the dropout seed shared, as in JAX. ``mesh``: data
    parallelism and spatial sharding (the module docstring); each rank
    passes its own rows (of the batch; with a model axis also of the
    voxels' and images' axis 1), and ``loss`` is the global batch's. Under
    spatial sharding the patch must divide by 2 x the model axis.
    """
    mesh = _data_parallel(mesh)
    shard = None
    if mesh is not None and mesh.shape["model"] > 1:
        shard = distributed.spatial_sharding(mesh, 5)
        slab_rows(shard, patch_size)  # refuses a patch the slabs cannot split
    cdt = _dtype(cfg.compute_dtype)
    greyscale = cfg.is_greyscale

    def loss_fn(net, voxels, images, poses, offsets, drop_seed):
        voxels = voxels.to(torch.float32)
        with span("loss"):
            images = _as_f32_image(images)
        with torch.no_grad():
            if shard is not None:
                voxels, images = shard.gather(voxels), shard.gather(images)
                at = (0, 0) if offsets is None else offsets
                vox_c = _resample_patch(voxels, poses, at, patch_size, cfg,
                                        rows=slab_rows(shard, patch_size))
                img_c = crop_image(images, at, patch_size, images.shape[1] // cfg.new_size,
                                   shard.rows(patch_size))
            elif patch_size == cfg.new_size:
                vox_c = _resample_full(voxels, poses, cfg)
                img_c = images
            else:
                vox_c = _resample_patch(voxels, poses, offsets, patch_size, cfg)
                img_c = crop_image(images, offsets, patch_size, images.shape[1] // cfg.new_size)
        gen = None
        if model_cfg.keep_prob < 1.0:
            gen = torch.Generator(device=voxels.device).manual_seed(drop_seed)
        pred = net(vox_c.to(cdt), train=True, generator=gen, cfg=model_cfg, shard=shard,
                   extended=shard is not None)
        with span("loss"):
            loss = shader_loss_from_images(pred, img_c, greyscale)
            if shard is not None and not greyscale:
                loss = loss / shard.size  # the rank's share of the whole image's mean
        return loss

    def step(state: TrainState, voxels, images, poses, rng: int,
             offsets: Optional[Sequence[int]] = None):
        with span("train_step"):
            offsets, drop_seed = _step_offsets(state, rng, patch_size, cfg, offsets, mesh)
            return _apply_step(state, tx, voxels.shape[0], cfg.grad_accum_steps,
                               lambda sl: loss_fn(state.params, voxels[sl], images[sl],
                                                  poses[sl], offsets, drop_seed),
                               mesh, cfg.allreduce_dtype)

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


# ---------------------------------------------------------------------------
# texture / face workload
# ---------------------------------------------------------------------------
def create_texture_state(seed, model_cfg: TextureFaceConfig, cfg: TrainConfig,
                         device=None) -> Tuple[TrainState, GradientTransformation]:
    """A fresh texture/face network (decoder and renderer) on ``device``, the
    optimizer and its state; see :func:`create_shader_state`."""
    net = init_texture_face_params(seed, model_cfg, device=device)
    tx = make_optimizer(cfg.e_eta, cfg.decay_steps, cfg.decay_rate,
                        skip_nonfinite=cfg.skip_nonfinite_updates,
                        moment_dtype=cfg.moment_dtype)
    return TrainState(net, tx.init(dict(net.named_parameters()))), tx


def texture_loss(net: TextureFaceRenderNet, model_cfg: TextureFaceConfig, cfg: TrainConfig,
                 patch_size: int, voxels, images, normals, textures, poses,
                 offsets: Optional[Sequence[int]] = None,
                 drop_seed: int = 0, shard=None) -> torch.Tensor:
    """The texture step's loss (``loss_fn`` of JAX's
    ``make_texture_train_step``, :330-370): decode the texture grid in the
    compute dtype, cast it to float32 and warp it under autograd (K1
    forward, K4 backward); warp the shape grid outside autograd; at
    ``patch_size < new_size`` crop both warps, the images and the normals
    at ``offsets``; concatenate, run the two heads and return MSE(albedo)
    + MSE(normal). With :data:`FUSE_TEXTURE_RESAMPLE` the two grids share
    one differentiated warp where their resolutions match.

    ``shard`` (an ``ops/halo.py`` ``RowShard``): ``voxels``, ``images`` and
    ``normals`` are this rank's rows (axis 1), gathered over the model axis;
    the warps emit the rank's slab of the patch's camera rows with e_conv1's
    halo (offsets (0, 0) at the full grid), the heads render its image
    rows, and the loss is the rank's share: its rows' squared errors over
    the whole patch's element count. Every rank decodes the whole texture
    grid (the decoder has no dropout), so its parameter gradients are the
    rank's partial sums, linear in its partial cotangent of the grid: the
    step's model-axis sum of all gradients completes them. The grid's
    cotangent itself is not summed (that would count the decoder's
    gradients once per rank)."""
    cdt = _dtype(cfg.compute_dtype)
    voxels = voxels.to(torch.float32)
    with span("loss"):
        images = _as_f32_image(images)
        normals = _as_f32_image(normals)
    rows = None
    if shard is not None:
        voxels, images, normals = (shard.gather(t) for t in (voxels, images, normals))
        offsets = (0, 0) if offsets is None else offsets
        rows = slab_rows(shard, patch_size)
    tex_grid = texture_decoder(net, textures.to(cdt)).to(torch.float32)
    fused = FUSE_TEXTURE_RESAMPLE and voxels.shape[1:4] == tex_grid.shape[1:4]

    def warp(grid):
        if patch_size == cfg.new_size and shard is None:
            return _resample_full(grid, poses, cfg)
        return _resample_patch(grid, poses, offsets, patch_size, cfg, rows=rows)

    if fused:
        both_c = warp(torch.cat([voxels, tex_grid], dim=4))
    else:
        with torch.no_grad():
            shape_c = warp(voxels)
        both_c = torch.cat([shape_c, warp(tex_grid)], dim=4)
    if patch_size == cfg.new_size and shard is None:
        img_c, nrm_c = images, normals
    else:
        factor = images.shape[1] // cfg.new_size
        slab = None if shard is None else shard.rows(patch_size)
        img_c = crop_image(images, offsets, patch_size, factor, slab)
        nrm_c = crop_image(normals, offsets, patch_size, factor, slab)
    gen = None
    if model_cfg.keep_prob < 1.0:
        gen = torch.Generator(device=voxels.device).manual_seed(drop_seed)
    albedo, normal = net(both_c.to(cdt), train=True, generator=gen, cfg=model_cfg, shard=shard,
                         extended=shard is not None)
    with span("loss"):
        loss = (shader_loss_from_images(albedo, img_c, greyscale=False)
                + shader_loss_from_images(normal, nrm_c, greyscale=False))
        return loss if shard is None else loss / shard.size  # the rank's share of the means


def make_texture_train_step(model_cfg: TextureFaceConfig, cfg: TrainConfig,
                            tx: GradientTransformation, patch_size: int, mesh=None):
    """Build the texture/face training step for one patch size:

        step(state, voxels [B,64,64,64,1], images [B,512,512,3],
             normals [B,512,512,3] (both in [0,1] or uint8),
             textures [B,texture_dim], poses [B,3], rng: int, offsets=None)
        -> (state, loss)

    Crops, dropout seeds, grad accumulation and ``mesh`` as
    :func:`make_shader_train_step`; the loss is :func:`texture_loss`. Under
    spatial sharding each rank passes its rows of the voxels, images and
    normals (axis 1) and the whole textures and poses of its batch rows;
    the patch must divide by 2 x the model axis."""
    mesh = _data_parallel(mesh)
    shard = None
    if mesh is not None and mesh.shape["model"] > 1:
        shard = distributed.spatial_sharding(mesh, 5)
        slab_rows(shard, patch_size)  # refuses a patch the slabs cannot split

    def step(state: TrainState, voxels, images, normals, textures, poses, rng: int,
             offsets: Optional[Sequence[int]] = None):
        with span("train_step"):
            offsets, drop_seed = _step_offsets(state, rng, patch_size, cfg, offsets, mesh)
            return _apply_step(
                state, tx, voxels.shape[0], cfg.grad_accum_steps,
                lambda sl: texture_loss(state.params, model_cfg, cfg, patch_size, voxels[sl],
                                        images[sl], normals[sl], textures[sl], poses[sl],
                                        offsets, drop_seed, shard), mesh, cfg.allreduce_dtype)

    return step
