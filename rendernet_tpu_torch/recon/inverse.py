"""Gradient-based inverse rendering (PyTorch): recover shape latent, pose,
texture latent and light from one shaded image.

Counterpart of ``rendernet_tpu/recon/inverse.py``, which follows
Reconstruct_RenderNet_Face.py of the reference: three frozen networks
(shape decoder, texture decoder, two-head renderer) and trainable latents
only; the forward decodes shape and texture, warps both into the camera
grid, renders albedo and normals and multiplies the albedo by the Phong
composite of the normals; a per-hypothesis MSE; SGD with four learning
rates; a coarse-to-fine search over 5 pose hypotheses that ride the batch
axis, with 200 inner steps per epoch and best-of-batch selection.

JAX runs the inner loop as one ``lax.scan``; here it is a Python loop of
eager steps on the card. ``resample="auto"`` is the multipass warp (K1
forward, K4 backward) on CUDA and the exact trilinear warp on the CPU, as
JAX's "auto" is multipass on a TPU.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from rendernet_tpu_torch import resolve_device
from rendernet_tpu_torch.models.decoders import (
    ReconRenderNet,
    ReconTextureDecoder,
    ShapeDecoder3D,
)
from rendernet_tpu_torch.ops.cuda_resample import rotate_resample_to_camera_multipass
from rendernet_tpu_torch.ops.phong import generate_light_pos, phong_composite
from rendernet_tpu_torch.ops.resample import rotate_resample_to_camera

__all__ = [
    "ReconConfig",
    "Latents",
    "ReconModel",
    "recon_forward",
    "recon_per_sample_loss",
    "make_recon_step",
    "create_param_center",
    "initial_latents",
    "subdivided_latents",
    "reconstruct",
]


@dataclasses.dataclass(frozen=True)
class ReconConfig:
    """The JAX config's fields and defaults (see its notes on each):
    ``grid_shape`` "cross" (axis-decoupled hypotheses) or "corners" (the
    reference's X); ``el_eta_scale`` multiplies the elevation's pose
    gradient; ``halve_mode`` "always" (the reference) or "on_center" (halve
    the search box only when the center hypothesis wins); ``sequence_axes``
    searches azimuth first and opens the elevation box at the first center
    win; ``warmup_freeze_epochs`` zeroes the texture and light rates for
    the first epochs. ``resample``: "auto", "multipass" or "exact";
    ``compute_dtype``: the networks' dtype, "float32" or "bfloat16"
    (latent updates and the loss stay float32)."""

    z_dim: int = 200
    texture_dim: int = 199
    batch_size: int = 5
    inner_steps: int = 200
    max_epochs: int = 10
    shape_eta: float = 0.8
    pose_eta: float = 0.01
    tex_eta: float = 0.8
    light_eta: float = 0.4
    light_elevation: float = 0.0
    ambient: float = 0.0
    k_diffuse: float = 1.0
    new_size: int = 128
    resample: str = "auto"
    compute_dtype: str = "float32"
    phi_range0: float = 60.0
    theta_range0: float = 30.0
    phi_mid0: float = 270.0
    theta_mid0: float = 90.0
    grid_shape: str = "cross"
    el_eta_scale: float = 1.0
    halve_mode: str = "always"
    sequence_axes: bool = False
    warmup_freeze_epochs: int = 0


class Latents(NamedTuple):
    """The trainable variables, one row per hypothesis (float32)."""

    vector: torch.Tensor  # [B, z_dim]
    pose: torch.Tensor  # [B, 3] (azimuth, elevation, scale), radians
    texture: torch.Tensor  # [B, texture_dim]
    light: torch.Tensor  # [B, 1] light azimuth, radians


class ReconModel(NamedTuple):
    """The three pretrained networks; :func:`make_recon_step` freezes them
    (no parameter requires grad, so no weight gradient is ever computed)."""

    decoder: ShapeDecoder3D
    texture: ReconTextureDecoder
    renderer: ReconRenderNet


def _dtype(cfg: ReconConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def recon_forward(model: ReconModel, latents: Latents, cfg: ReconConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The differentiable pipeline -> (composite, albedo, normal, shape)."""
    b = latents.vector.shape[0]
    cdt = _dtype(cfg)
    shape = model.decoder(latents.vector.to(cdt))
    tex = model.texture(latents.texture.to(cdt))
    light_dir = generate_light_pos(latents.light, cfg.light_elevation, b)

    method = cfg.resample
    if method == "auto":
        method = "multipass" if latents.vector.is_cuda else "exact"
    if method == "multipass":
        # The warp's data rides the compute dtype; geometry and the pose
        # gradient stay float32 in the kernels.
        warp = functools.partial(rotate_resample_to_camera_multipass, compute_dtype=cdt)
    elif method == "exact":
        warp = rotate_resample_to_camera
    else:
        raise ValueError(f"resample must be 'auto', 'multipass' or 'exact', got {method!r}")
    shape_cam = warp(shape, latents.pose, new_size=cfg.new_size)
    tex_cam = warp(tex.float(), latents.pose, new_size=cfg.new_size)
    both = torch.cat([shape_cam, tex_cam], dim=4)

    albedo, normal = model.renderer(both.to(cdt))
    light_col = torch.ones((b, 3), dtype=torch.float32, device=albedo.device)
    shading = phong_composite(normal, light_dir, light_col, cfg.ambient, cfg.k_diffuse,
                              black_background=False, with_mask=True)
    return albedo * shading, albedo, normal, shape


def recon_per_sample_loss(model: ReconModel, latents: Latents, target: torch.Tensor,
                          cfg: ReconConfig) -> torch.Tensor:
    """Per-hypothesis MSE against the shaded target image -> ``[B]``."""
    compos, _, _, _ = recon_forward(model, latents, cfg)
    return torch.mean((target - compos) ** 2, dim=(1, 2, 3))


def _freeze(model: ReconModel) -> None:
    for net in model:
        net.requires_grad_(False).eval()


def make_recon_step(model: ReconModel, cfg: ReconConfig, scan_steps: Optional[int] = None,
                    loss_fn=None):
    """The optimisation step, as ``run(latents, target)``.

    Without ``scan_steps``: one SGD step -> (latents, per-sample loss [B]).
    With it: ``scan_steps`` steps in a loop -> (latents, loss history [T,
    B]). Per-group learning rates as in the reference. ``loss_fn(model,
    latents, target, cfg) -> [B]`` swaps the forward model (default
    :func:`recon_per_sample_loss`). Freezes ``model``."""
    if loss_fn is None:
        loss_fn = recon_per_sample_loss
    _freeze(model)

    def one_step(latents: Latents, target: torch.Tensor):
        leaves = [t.detach().requires_grad_(True) for t in latents]
        with torch.enable_grad():
            per_sample = loss_fn(model, Latents(*leaves), target, cfg)
            grads = torch.autograd.grad(per_sample.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
        pose_scale = torch.ones(3, device=latents.pose.device)  # no copy from the host
        pose_scale[1] = cfg.el_eta_scale
        with torch.no_grad():
            new = Latents(
                vector=latents.vector - cfg.shape_eta * grads[0],
                pose=latents.pose - cfg.pose_eta * pose_scale * grads[1],
                texture=latents.texture - cfg.tex_eta * grads[2],
                light=latents.light - cfg.light_eta * grads[3],
            )
        return new, per_sample.detach()

    if scan_steps is None:
        return one_step

    def run(latents: Latents, target: torch.Tensor):
        history = []
        for _ in range(scan_steps):
            latents, per_sample = one_step(latents, target)
            history.append(per_sample)
        return latents, torch.stack(history)

    return run


def create_param_center(phi_mid: float, phi_range: float, theta_mid: float,
                        theta_range: float, batch_size: int = 5,
                        shape: str = "corners") -> np.ndarray:
    """5 pose hypotheses spanning the search box (degrees in, radians out):
    "corners" is the reference's X (the box's corners and its center,
    Reconstruct_RenderNet_Face.py:304-318, with the %360 azimuth wrap);
    "cross" a + of (phi +- range/2, theta_mid), the center and (phi_mid,
    theta +- range/2)."""
    phi_min = ((phi_mid - phi_range * 0.5) % 360) * math.pi / 180.0
    phi_max = ((phi_mid + phi_range * 0.5) % 360) * math.pi / 180.0
    theta_min = (90 - (theta_mid - theta_range * 0.5)) * math.pi / 180.0
    theta_max = (90 - (theta_mid + theta_range * 0.5)) * math.pi / 180.0
    phi_mid_r = phi_mid * math.pi / 180.0
    theta_mid_r = (90 - theta_mid) * math.pi / 180.0
    if shape == "corners":
        grid = [(phi_min, theta_min), (phi_min, theta_max), (phi_mid_r, theta_mid_r),
                (phi_max, theta_min), (phi_max, theta_max)]
    elif shape == "cross":
        grid = [(phi_min, theta_mid_r), (phi_max, theta_mid_r), (phi_mid_r, theta_mid_r),
                (phi_mid_r, theta_min), (phi_mid_r, theta_max)]
    else:
        raise ValueError(f"unknown grid shape {shape!r}")
    params = np.zeros((batch_size, 3), np.float32)
    for i in range(batch_size):
        phi, theta = grid[i % len(grid)]
        params[i] = (phi, theta, 1.0)
    return params


def initial_latents(cfg: ReconConfig, seed: int = 0, device=None) -> Latents:
    """First-epoch latents (:461-465): z = 0.5, a standard-normal texture
    code from ``np.random.default_rng(seed)`` (the JAX package's numbers),
    light azimuths linspaced over [230, 320] degrees; on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    pose = create_param_center(cfg.phi_mid0, cfg.phi_range0, cfg.theta_mid0, cfg.theta_range0,
                               cfg.batch_size, shape=cfg.grid_shape)
    light = np.linspace(230, 320, num=cfg.batch_size)[:, None] * math.pi / 180.0
    texture = rng.standard_normal((cfg.batch_size, cfg.texture_dim))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return Latents(vector=torch.full((cfg.batch_size, cfg.z_dim), 0.5, device=dev),
                   pose=t(pose), texture=t(texture), light=t(light))


def subdivided_latents(best: Latents, best_idx: int, phi_range: float, theta_range: float,
                       cfg: ReconConfig) -> Latents:
    """Next-epoch latents: the best hypothesis tiled, the pose box subdivided
    around it (:466-473, :530-534)."""
    best_pose_deg = best.pose[best_idx].detach().cpu().numpy() * 180.0 / math.pi
    phi_mid = float(best_pose_deg[0])
    theta_mid = 90.0 - float(best_pose_deg[1])
    pose = create_param_center(phi_mid, phi_range, theta_mid, theta_range, cfg.batch_size,
                               shape=cfg.grid_shape)

    def tile(x):
        return x[best_idx][None].repeat(cfg.batch_size, 1)

    return Latents(vector=tile(best.vector), pose=torch.as_tensor(pose, device=best.pose.device),
                   texture=tile(best.texture), light=tile(best.light))


def reconstruct(model: ReconModel, target: torch.Tensor, cfg: ReconConfig, seed: int = 0,
                callback=None, run=None, dump_every: Optional[int] = None,
                inner_callback=None, loss_fn=None, initial: Optional[Latents] = None
                ) -> Tuple[Latents, np.ndarray, np.ndarray]:
    """The coarse-to-fine reconstruction, on the device of ``target``.

    Returns ``(latents, final_losses [epochs, B], loss_curves [epochs,
    inner_steps, B])``. ``callback(epoch, latents, losses)`` fires after
    each epoch; ``dump_every=K`` (dividing ``inner_steps``) runs the inner
    loop in chunks of K steps and fires ``inner_callback(epoch, inner_step,
    latents, losses_chunk [K, B])`` after each. ``run`` reuses a runner of
    :func:`make_recon_step` (``scan_steps`` = ``dump_every`` when set, else
    ``inner_steps``). The center-win test ``best_idx % 5 == 2`` is the JAX
    package's, kept for parity."""
    chunk = dump_every or cfg.inner_steps
    if cfg.inner_steps % chunk:
        raise ValueError(f"dump_every={dump_every} must divide inner_steps={cfg.inner_steps}")
    if run is None:
        run = make_recon_step(model, cfg, scan_steps=chunk, loss_fn=loss_fn)
    run_frozen = None
    if cfg.warmup_freeze_epochs > 0:
        run_frozen = make_recon_step(model, dataclasses.replace(cfg, tex_eta=0.0, light_eta=0.0),
                                     scan_steps=chunk, loss_fn=loss_fn)
    latents = initial_latents(cfg, seed, device=target.device) if initial is None else initial
    phi_range, theta_range = cfg.phi_range0, cfg.theta_range0
    theta_pending = False
    if cfg.sequence_axes:
        if cfg.halve_mode != "on_center":
            raise ValueError("sequence_axes requires halve_mode='on_center'")
        theta_range = 0.0  # azimuth first; theta opens on the first center win
        theta_pending = cfg.theta_range0 > 0
        if initial is None:
            pose = create_param_center(cfg.phi_mid0, cfg.phi_range0, cfg.theta_mid0, 0.0,
                                       cfg.batch_size, shape=cfg.grid_shape)
            latents = latents._replace(pose=torch.as_tensor(pose, device=target.device))
    history, curves = [], []
    for epoch in range(cfg.max_epochs):
        epoch_run = (run_frozen if run_frozen is not None and epoch < cfg.warmup_freeze_epochs
                     else run)
        chunks = []
        for ci in range(cfg.inner_steps // chunk):
            latents, losses = epoch_run(latents, target)
            chunks.append(losses.cpu().numpy())
            if inner_callback is not None:
                inner_callback(epoch, (ci + 1) * chunk, latents, chunks[-1])
        curve = np.concatenate(chunks, axis=0)
        curves.append(curve)
        final = curve[-1]
        history.append(final)
        best_idx = int(final.argmin())
        if callback is not None:
            callback(epoch, latents, final)
        if epoch + 1 < cfg.max_epochs:
            if cfg.halve_mode == "always" or best_idx % 5 == 2:
                phi_range /= 2.0
                if theta_pending:
                    theta_range = cfg.theta_range0
                    theta_pending = False
                else:
                    theta_range /= 2.0
            latents = subdivided_latents(latents, best_idx, phi_range, theta_range, cfg)
    return latents, np.stack(history), np.stack(curves)
