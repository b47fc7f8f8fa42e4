"""Epoch-level training loops of the shader and texture/face workloads.

Counterpart of ``rendernet_tpu/train/loop.py`` (the runtime loops of
RenderNet_Shader.py:179-306 and RenderNet_Texture_Face_Normal.py:200-335):
the patch curriculum (``cfg.patch_size_for_epoch``), chunked streaming
through :func:`~rendernet_tpu_torch.data.prefetch.prefetch`, the uint8
feed cast on the card, ``cache_chunks``, sample dumps, per-epoch
validation L1, ``config.json`` and ``metrics.jsonl`` in the run dir (and
``tb/`` with ``cfg.tensorboard``), the non-finite guards, the profiler
window, checkpoint autosave and crash-resume.

One step per patch size is built and steps are dispatched eagerly; the loop
reads the loss on the host only where JAX's loop syncs (the pipelined
guard one step late, the logging points, checkpoints), so steps queue on
the card.

In a process group of more than one rank (``train.distributed``) each rank
trains on its card: the state is replicated from rank 0, each rank's loader
reads its stride of the tar (``shard=(rank, world)``) in batches of
``batch_size / world``, the step all-reduces the gradients, and validation
sums per rank before one all-reduce. Rank 0 alone writes the run dir
(config, metrics, TB, sample dumps, profiles, checkpoints, params). Every
rank must draw the same number of batches an epoch: the collectives of a
rank left without one time out.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from rendernet_tpu_torch import resolve_device
from rendernet_tpu_torch.data.loaders import data_loader, data_loader_image_texture_normal_face
from rendernet_tpu_torch.data.prefetch import prefetch
from rendernet_tpu_torch.models.shader import ShaderConfig
from rendernet_tpu_torch.models.texture_face import TextureFaceConfig
from rendernet_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
    save_params_npz,
)
from rendernet_tpu_torch.train.config import TrainConfig
from rendernet_tpu_torch.train.distributed import (
    is_chief,
    make_hybrid_mesh,
    process_shard,
    replicate,
    world,
)
from rendernet_tpu_torch.train.steps import (
    create_shader_state,
    create_texture_state,
    make_shader_eval_step,
    make_shader_train_step,
    make_texture_train_step,
)
from rendernet_tpu_torch.utils import spans
from rendernet_tpu_torch.utils.image import save_image, to_uint8

__all__ = ["train_shader", "train_texture"]


def _halt_if_rejecting(cfg: TrainConfig, run, state, global_step: int, epoch: int) -> None:
    """Halt once the optimizer has rejected ``skip_nonfinite_updates``
    consecutive updates (``reject_nonfinite`` never applies a bad update, so
    this is detection only). Reading the count waits for the card, so
    callers invoke this only where the loop syncs anyway."""
    consecutive = int(state.opt_state.notfinite_count)
    if consecutive == 0:
        return
    run.log(step=global_step, epoch=epoch, event="nonfinite_updates_rejected",
            consecutive=consecutive, total=int(state.opt_state.total_notfinite))
    if consecutive >= cfg.skip_nonfinite_updates:
        raise FloatingPointError(
            f"{consecutive} consecutive non-finite gradient updates as of step {global_step} "
            "(params remain clean: updates were rejected on the device); halting")


class _PipelinedGuard:
    """Run the non-finite-loss check one step late, so that its host read of
    the loss happens with the next step already queued on the card."""

    def __init__(self, cfg: TrainConfig, run):
        self.cfg, self.run = cfg, run
        self.pending = None  # (device loss, global_step, epoch)

    def push(self, loss, state, global_step: int, epoch: int) -> None:
        prev, self.pending = self.pending, (loss, global_step, epoch)
        if prev is not None:
            _guard_loss(self.cfg, self.run, state, prev[1], prev[2], float(prev[0]))

    def flush(self, state) -> None:
        if self.pending is not None:
            prev, self.pending = self.pending, None
            _guard_loss(self.cfg, self.run, state, prev[1], prev[2], float(prev[0]))


def _guard_loss(cfg: TrainConfig, run, state, global_step: int, epoch: int,
                loss: float) -> None:
    """With ``skip_nonfinite_updates`` the optimizer rejects bad updates on
    the device and the loop halts only on persistent failure; without it a
    non-finite loss halts at once."""
    if not (cfg.nan_guard and not np.isfinite(loss)):
        return
    if cfg.skip_nonfinite_updates > 0:
        _halt_if_rejecting(cfg, run, state, global_step, epoch)
        return
    run.log(step=global_step, epoch=epoch, loss=loss, event="non_finite_loss")
    raise FloatingPointError(f"non-finite loss {loss} at step {global_step}")


class _ProfileWindow:
    """A ``torch.profiler`` trace of steps ``[profile_start_step,
    profile_start_step + profile_steps)``, written as a Chrome trace into
    ``cfg.profile_dir`` (JAX's ``_profile_window``). The port's spans
    (``utils/spans.py``) are recorded inside the window, so the trace
    names each layer as a ``rn.<span>`` range."""

    def __init__(self, cfg: TrainConfig):
        self.cfg, self.prof, self.recording = cfg, None, None

    def __call__(self, global_step: int) -> None:
        cfg = self.cfg
        if not cfg.profile_dir or not is_chief():
            return
        if global_step == cfg.profile_start_step and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            self.recording = spans.recording()
            self.recording.__enter__()
        elif global_step == cfg.profile_start_step + cfg.profile_steps and self.prof is not None:
            self.stop()

    def stop(self) -> None:
        if self.prof is not None:
            prof, self.prof = self.prof, None
            rec, self.recording = self.recording, None
            rec.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            os.makedirs(self.cfg.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(self.cfg.profile_dir, "trace.json"))


def _check_pose_scales(poses: np.ndarray, cfg: TrainConfig) -> None:
    """Every pose scale must respect ``pose_scale_limit``, or the narrowed
    multipass adjoint band would lose taps."""
    if cfg.pose_scale_limit is None or poses.shape[-1] < 3:
        return
    top = float(np.max(poses[..., 2]))
    if top > cfg.pose_scale_limit:
        raise ValueError(f"pose scale {top:.4f} exceeds pose_scale_limit="
                         f"{cfg.pose_scale_limit}; raise the limit (or unset it): "
                         "gradients would be wrong")


def _maybe_resume(ckpt_path: str, state, run):
    """Restore the run dir's checkpoint if there is one (the reference's
    Supervisor auto-restore)."""
    if not os.path.exists(ckpt_path):
        return state
    try:
        state = restore_checkpoint(ckpt_path, state)
    except ValueError as e:
        raise RuntimeError(
            f"could not restore the checkpoint {ckpt_path} against the current "
            "optimizer-state structure. This happens when skip_nonfinite_updates was "
            "toggled between runs (it wraps the optimizer state). Start a fresh run dir "
            "(params carry over through its params_latest.npz) or restore with the "
            "original setting.") from e
    run.log(resumed_at_step=int(state.step))
    return state


def _auto_mesh(cfg: TrainConfig, use_mesh: bool, device):
    """JAX's ``_auto_mesh``: with more than one rank, the hybrid mesh over
    all of them; in one process, no mesh (one card). ``data_parallel`` above
    1 must be the number of ranks: PyTorch runs one process per card."""
    if not use_mesh:
        return None
    _, n = world()
    if (cfg.data_parallel or 1) > 1 and cfg.data_parallel != n:
        raise ValueError(
            f"data_parallel={cfg.data_parallel} with {n} process(es): PyTorch trains one "
            f"process per card, so launch {cfg.data_parallel} (torchrun --nproc-per-node "
            f"{cfg.data_parallel} -m rendernet_tpu_torch.cli train-shader cfg.json, or "
            "--coordinator host:port --num-processes N --process-id i on each)")
    return make_hybrid_mesh(device=device) if n > 1 else None


class _RunDir:
    """The run dir; rank 0 alone writes it."""

    def __init__(self, cfg: TrainConfig):
        self.root = cfg.sample_save
        self.chief = is_chief()
        self.metrics_path = os.path.join(self.root, "metrics.jsonl")
        self.tb = None
        self.last_fp = None  # the dead-step warning's last fingerprint
        if not self.chief:
            return
        os.makedirs(self.root, exist_ok=True)
        cfg.to_json(os.path.join(self.root, "config.json"))
        if cfg.tensorboard:
            from rendernet_tpu_torch.utils.tb import TBWriter

            self.tb = TBWriter(os.path.join(self.root, "tb"))

    def log(self, **kv):
        if not self.chief:
            return
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(kv) + "\n")
        if self.tb is not None:
            step = int(kv.get("step", kv.get("epoch", 0) or 0))
            for k, v in kv.items():
                if (k not in ("step", "epoch", "event") and isinstance(v, (int, float))
                        and not isinstance(v, bool)):
                    self.tb.scalar(k, float(v), step)
            self.tb.flush()

    def dump_pair(self, tag: str, step: int, pred: np.ndarray, target: np.ndarray):
        if not self.chief:
            return

        def u8(x):
            x = np.squeeze(x)
            return x if x.dtype == np.uint8 else to_uint8(x, 255.0)

        save_image(u8(pred), os.path.join(self.root, f"{tag}_{step}_pred.png"))
        save_image(u8(target), os.path.join(self.root, f"{tag}_{step}_target.png"))


def _dead_step_warning(run, state, global_step: int, epoch: int) -> None:
    """Saturation-death detection (JAX's loop.py:335): fingerprint one
    parameter with an fp32 abs-sum at each logging point and warn when two
    in a row are equal. Mirrored as it is, with its known weakness: the
    fingerprint of one leaf can repeat while other leaves move (ROADMAP.md
    queue 3)."""
    first = next(iter(state.params.parameters()))
    fp = float(first.detach().float().abs().sum())
    if fp == run.last_fp:
        run.log(step=global_step, epoch=epoch, event="dead_training_warning",
                detail="params unchanged since the last logging point: zero-update steps "
                       "(saturated outputs?); lower the lr")
    run.last_fp = fp


def _to_device(arrays, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def _run(cfg: TrainConfig, run, state, dev, make_step, loader_for_epoch, feed, on_log,
         on_epoch_end, max_steps, progress):
    """The epoch loop both workloads share. ``loader_for_epoch()`` yields
    chunks of this rank's entries whose first element is the images and
    whose second-to-last is the poses and last the names; ``feed(chunk)``
    returns the chunk's uint8 / float32 host arrays in step order;
    ``on_log`` runs at each logging point, ``on_epoch_end`` after each
    epoch."""
    ckpt = os.path.join(run.root, cfg.trained_model_name)
    steps = {}  # patch size -> step
    guard = _PipelinedGuard(cfg, run)
    profiler = _ProfileWindow(cfg)
    step_rng = cfg.seed + 1
    global_step = int(state.step)
    last_ckpt = time.time()
    chunk_cache = {}  # (chunk, batch) -> device arrays, with cfg.cache_chunks
    cache_cap_logged = False
    bs = process_shard(cfg.batch_size)[0]

    def checkpoint(params_too: bool):
        save_checkpoint(ckpt, state)
        if params_too:
            save_params_npz(os.path.join(run.root, "params_latest.npz"), state.params)

    try:
        for epoch in range(cfg.max_epochs):
            patch = cfg.patch_size_for_epoch(epoch)
            if patch not in steps:
                steps[patch] = make_step(patch)
            step_fn = steps[patch]
            for chunk_idx, chunk in enumerate(prefetch(loader_for_epoch(), cfg.prefetch_chunks)):
                poses, names = chunk[-2], chunk[-1]
                _check_pose_scales(poses, cfg)
                host = None
                for i in range(len(chunk[0]) // bs):
                    if cfg.cache_chunks and (chunk_idx, i) in chunk_cache:
                        batch = chunk_cache[chunk_idx, i]
                    else:
                        if host is None:
                            host = feed(chunk)
                        batch = _to_device([a[i * bs:(i + 1) * bs] for a in host], dev)
                        if cfg.cache_chunks:
                            # bounded: past the cap, stream (a real dataset
                            # cannot fill the card through the cache)
                            if len(chunk_cache) < cfg.cache_chunks_max_batches:
                                chunk_cache[chunk_idx, i] = batch
                            elif not cache_cap_logged:
                                cache_cap_logged = True
                                run.log(event="cache_chunks_cap",
                                        cached_batches=cfg.cache_chunks_max_batches)
                    profiler(global_step)
                    state, loss = step_fn(state, *batch, step_rng)
                    global_step += 1
                    guard.push(loss, state, global_step, epoch)
                    if progress is not None:
                        # the device scalar: the callback decides whether to sync
                        progress(global_step, loss)
                    if global_step % cfg.sample_every_steps == 0:
                        run.log(step=global_step, epoch=epoch, loss=float(loss))
                        if cfg.skip_nonfinite_updates > 0:
                            _halt_if_rejecting(cfg, run, state, global_step, epoch)
                        on_log(state, batch, names[i * bs], global_step, epoch)
                    if time.time() - last_ckpt > cfg.checkpoint_secs:
                        # settle the guard first: never checkpoint params a
                        # pending non-finite loss would have halted on
                        guard.flush(state)
                        checkpoint(True)
                        last_ckpt = time.time()
                    if max_steps is not None and global_step >= max_steps:
                        guard.flush(state)
                        checkpoint(False)
                        return state
            guard.flush(state)
            # epoch boundaries checkpoint only when checkpoint_secs has elapsed
            if time.time() - last_ckpt > cfg.checkpoint_secs:
                checkpoint(False)
                last_ckpt = time.time()
            on_epoch_end(state, global_step, epoch)
    finally:
        profiler.stop()
    checkpoint(False)
    save_params_npz(os.path.join(run.root, "params_final.npz"), state.params)
    return state


def _u8(a: np.ndarray) -> np.ndarray:
    return np.clip(a, 0, 255).astype(np.uint8)


def _setup(cfg: TrainConfig, use_mesh: bool, device, create_state, model_cfg):
    """(run dir, mesh, state, optimizer, device, (local batch, shard)) of a
    run: the mesh (logged), the state created, resumed from the run dir's
    checkpoint and, on a mesh, replicated from rank 0."""
    dev = resolve_device(device)
    mesh = _auto_mesh(cfg, use_mesh, dev)
    run = _RunDir(cfg)
    _, n = world()
    if mesh is not None:
        run.log(event="mesh", layout="hybrid", devices=n, processes=n)
    state, tx = create_state(cfg.seed, model_cfg, cfg, device=dev)
    state = _maybe_resume(os.path.join(run.root, cfg.trained_model_name), state, run)
    if mesh is not None:
        state = replicate(mesh, state)
    local_bs, rank, n = process_shard(cfg.batch_size)
    return run, mesh, state, tx, dev, (local_bs, (rank, n) if n > 1 else None)


def train_shader(cfg: TrainConfig, model_cfg: Optional[ShaderConfig] = None,
                 max_steps: Optional[int] = None, use_mesh: bool = True,
                 progress: Optional[Callable[[int, torch.Tensor], None]] = None,
                 device=None):
    """Run shader training from a TrainConfig on ``device`` (CUDA unless
    the caller asks for the CPU; in a process group, the rank's card);
    returns the final TrainState. ``use_mesh=False`` builds no mesh, which
    a group of more than one rank refuses (its ranks would train apart)."""
    model_cfg = model_cfg or ShaderConfig(out_channels=cfg.image_channels,
                                          keep_prob=cfg.keep_prob, new_size=cfg.new_size)
    run, mesh, state, tx, dev, (local_bs, shard) = _setup(cfg, use_mesh, device,
                                                          create_shader_state, model_cfg)
    eval_step = make_shader_eval_step(model_cfg, cfg)

    def loader():
        return data_loader(cfg.image_path, cfg.model_path, batch_size=local_bs,
                           batches_chunk=cfg.batches_chunk, flatten=cfg.is_greyscale,
                           img_res=cfg.img_res, voxel_res=cfg.voxel_res, shard=shard)

    def feed(chunk):
        images, voxels, poses, _ = chunk
        return voxels.astype(np.uint8), _u8(images), poses

    def on_log(state, batch, name, global_step, epoch):
        if not run.chief:
            return
        if cfg.dead_step_warn:
            _dead_step_warning(run, state, global_step, epoch)
        pred = eval_step(state.params, batch[0], batch[2])
        run.dump_pair(f"train_{name}", global_step, pred[0].float().cpu().numpy(),
                      batch[1][0].cpu().numpy())

    def on_epoch_end(state, global_step, epoch):
        if not (cfg.image_path_valid and os.path.exists(cfg.image_path_valid)):
            return
        # per-batch L1s stay on the card; each rank sums its stride of the
        # validation tar, then one all-reduce of [sum, count] and one host read
        total = torch.zeros(2, dtype=torch.float32, device=dev)
        for images, voxels, poses, _ in data_loader(
                cfg.image_path_valid, cfg.model_path, batch_size=local_bs,
                validation_mode=True, flatten=cfg.is_greyscale, img_res=cfg.img_res,
                voxel_res=cfg.voxel_res, shard=shard):
            vox, pose, target = _to_device(
                (voxels, poses, (images / 255.0).astype(np.float32)), dev)
            total[0] += torch.mean(torch.abs(target - eval_step(state.params, vox, pose)))
            total[1] += 1
        if mesh is not None:
            torch.distributed.all_reduce(total, group=mesh.group)
        l1_sum, l1_n = total.tolist()
        if l1_n:
            run.log(step=global_step, epoch=epoch, valid_l1=l1_sum / l1_n)

    return _run(cfg, run, state, dev, lambda patch: make_shader_train_step(
        model_cfg, cfg, tx, patch, mesh=mesh), loader, feed, on_log, on_epoch_end, max_steps,
        progress)


def train_texture(cfg: TrainConfig, model_cfg: Optional[TextureFaceConfig] = None,
                  max_steps: Optional[int] = None, use_mesh: bool = True,
                  progress: Optional[Callable[[int, torch.Tensor], None]] = None,
                  device=None):
    """Run texture/normal face training on ``device``; returns the final
    TrainState. As JAX's, it logs the loss at each logging point and dumps
    no samples; processes and ``use_mesh`` as :func:`train_shader`."""
    model_cfg = model_cfg or TextureFaceConfig(keep_prob=cfg.keep_prob, new_size=cfg.new_size)
    run, mesh, state, tx, dev, (local_bs, shard) = _setup(cfg, use_mesh, device,
                                                          create_texture_state, model_cfg)

    def loader():
        return data_loader_image_texture_normal_face(
            cfg.image_path, cfg.model_path, cfg.texture_path, cfg.normal_path,
            batch_size=local_bs, batches_chunk=cfg.batches_chunk, img_res=cfg.img_res,
            voxel_res=cfg.voxel_res, shard=shard)

    def feed(chunk):
        images, normals, voxels, textures, poses, _ = chunk
        return voxels.astype(np.uint8), _u8(images), _u8(normals), textures, poses

    return _run(cfg, run, state, dev, lambda patch: make_texture_train_step(
        model_cfg, cfg, tx, patch, mesh=mesh), loader, feed, lambda *a: None, lambda *a: None,
        max_steps, progress)
