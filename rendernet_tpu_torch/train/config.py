"""Typed training configuration, JSON-compatible with the reference configs.

The port's own copy of ``rendernet_tpu/train/config.py`` (pure Python; the
port imports nothing of the JAX package). The reference reads a flat JSON
dict at import time (RenderNet_Shader.py:19) with keys documented in
README.md:42-155. ``TrainConfig.from_json`` accepts those exact files
(config_RenderNet.json etc.) and layers typed defaults and validation on
top. The fields and defaults are the JAX package's, so one JSON file
configures both; fields that belong to slices the port has not reached
(the loop, data, distribution, reconstruction) are kept and read by
nothing here yet.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

__all__ = ["TrainConfig"]


def _as_bool(v) -> bool:
    if isinstance(v, str):
        return v.lower() == "true"
    return bool(v)


@dataclasses.dataclass
class TrainConfig:
    # --- data ---
    image_path: str = ""
    image_path_valid: str = ""
    model_path: str = ""
    normal_path: str = ""  # face workload only
    texture_path: str = ""  # face workload only
    is_greyscale: bool = True
    img_res: int = 512
    voxel_res: int = 64

    # --- schedule ---
    batch_size: int = 1
    batches_chunk: int = 1
    max_epochs: int = 1000
    e_eta: float = 1e-5
    decay_steps: int = 100_000
    decay_rate: float = 0.96
    keep_prob: float = 1.0
    threshold: float = 0.1
    curriculum_epochs: int = 5  # patch 32 before, 64 after (Shader.py:204-207)

    # --- run management ---
    sample_save: str = "./runs/shader"
    trained_model_name: str = "3d2d_renderer"
    checkpoint_secs: int = 7200
    sample_every_steps: int = 600
    gpu: int = 0  # accepted for config compatibility; the device is the caller's

    # --- knobs with no reference counterpart ---
    compute_dtype: str = "bfloat16"
    # Resample: "auto" = the multipass pass plan (K1 kernel) on CUDA / the
    # exact gather path on the CPU; "exact" forces direct trilinear
    # (bit-parity with the reference); "multipass" forces the fast path.
    resample: str = "auto"
    # Static upper bound on the pose scale (view_params[:, 2] = 3.3/radius,
    # tools/data_util.py:111-118). When set, the multipass backward narrows
    # its adjoint band (6 -> 4 taps at 1.2), and a pose above it resamples
    # to NaN (ops/cuda_resample.py:build_pass_plan).
    pose_scale_limit: Optional[float] = None
    # Mirror numeric metrics into TensorBoard event files under
    # <sample_save>/tb (scalar parity with the reference's tf.summary
    # writes, RenderNet_Shader.py:169-173): the training loop's option.
    tensorboard: bool = True
    # Profiling: when profile_dir is set, a profiler trace of steps
    # [profile_start_step, profile_start_step + profile_steps) is written
    # there as trace.json (the training loop's option), with the port's
    # spans (utils/spans.py) as rn.<span> ranges naming each layer.
    profile_dir: str = ""
    profile_start_step: int = 10
    profile_steps: int = 5
    data_parallel: Optional[int] = None  # None, or the number of processes (one per card)
    nan_guard: bool = True  # halt with a clear error on non-finite loss
    # Failure recovery: when > 0, updates with non-finite gradients are
    # ALWAYS rejected on the device (train.optim.reject_nonfinite) — params
    # and optimizer state cannot be poisoned. The loop halts with a clear
    # error once this many CONSECUTIVE updates were rejected, checked at
    # sync points (non-finite losses, periodic logging, checkpoint
    # writes); a burst that self-clears between sync points is tolerated
    # by design (params were never touched).
    # NOTE: toggling this changes the optimizer-state pytree, so a run
    # directory checkpointed with the other setting will not auto-resume;
    # start a fresh run dir (params migrate via params_latest.npz).
    skip_nonfinite_updates: int = 0
    # Warn (metrics.jsonl event "dead_training_warning") when parameters
    # stop changing between logging points — the all-finite failure mode
    # the non-finite guards cannot see: bf16 sigmoid saturation zeroes
    # every gradient and freezes the run while the loss stays finite
    # (a failure mode seen in the JAX package's training runs).
    dead_step_warn: bool = True
    # Adam moment-buffer storage dtype ("float32" | "bfloat16"). bf16
    # halves the optimizer state (~0.95 GB at the 237 M-param shader net);
    # the update arithmetic is fp32 either way
    # (train.optim.scale_by_adam_moments). Default float32, as in JAX.
    moment_dtype: str = "float32"
    # Cross-device gradient all-reduce dtype ("float32" | "bfloat16"): a
    # step on a mesh whose data axis is above 1 (train.distributed) moves
    # its gradients in it; fp32 otherwise, as in JAX.
    allreduce_dtype: str = "float32"
    # Cache device-resident batches across epochs (small, deterministic
    # datasets only — eliminates repeat host->device transfers entirely).
    # At most ``cache_chunks_max_batches`` batches are kept — a fixed count
    # bound, not a memory-aware check; past the cap, later batches stream
    # normally — a real-dataset run cannot OOM the device through the cache.
    cache_chunks: bool = False
    cache_chunks_max_batches: int = 256
    # Gradient accumulation: split each batch into this many microbatches,
    # accumulate fp32 gradients across them, apply ONE optimizer
    # update. Exact same update as the full batch (shared crop/dropout rng,
    # mean-reduced losses) with 1/N the activation memory — big batches on
    # small chips. batch_size must divide evenly.
    grad_accum_steps: int = 1
    # Background input pipeline of the training loop: decode up to this
    # many chunks ahead on a host thread. 0 = synchronous.
    prefetch_chunks: int = 2
    new_size: int = 128
    seed: int = 0

    # --- reconstruction workload keys (config_reconstruction_RenderNet.json) ---
    z_dim: int = 200
    inner_step: int = 200
    shape_eta: float = 0.8
    pose_eta: float = 0.01
    tex_eta: float = 0.8
    light_eta: float = 0.4
    weight_dir: str = ""
    weight_dir_decoder: str = ""
    target_albedo: str = ""
    target_normal: str = ""
    target_azimuth_light: float = 294.0
    target_elevation_light: float = 105.0

    @classmethod
    def from_json(cls, path: str, **overrides) -> "TrainConfig":
        with open(path) as f:
            raw: Dict[str, Any] = json.load(f)
        return cls.from_dict(raw, **overrides)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any], **overrides) -> "TrainConfig":
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        for key, value in {**raw, **overrides}.items():
            if key not in fields:
                continue  # tolerate unknown keys like the reference does
            if fields[key].type in ("bool", bool):
                value = _as_bool(value)
            kwargs[key] = value
        cfg = cls(**kwargs)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.img_res != 4 * self.new_size:
            raise ValueError(
                f"img_res ({self.img_res}) must be 4x the camera grid size "
                f"({self.new_size}): the decoder chain upsamples exactly 4x"
            )
        if not 0.0 < self.keep_prob <= 1.0:
            raise ValueError("keep_prob must be in (0, 1]")
        if self.moment_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"moment_dtype must be 'float32' or 'bfloat16', got "
                f"{self.moment_dtype!r}"
            )
        if self.allreduce_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"allreduce_dtype must be 'float32' or 'bfloat16', got "
                f"{self.allreduce_dtype!r}"
            )

    def to_json(self, path: str) -> None:
        """Snapshot the config into the run dir (provenance habit of
        RenderNet_Shader.py:199)."""
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @property
    def image_channels(self) -> int:
        return 1 if self.is_greyscale else 3

    def patch_size_for_epoch(self, epoch: int) -> int:
        """Patch curriculum: new_size//4 early, new_size//2 after
        (RenderNet_Shader.py:204-207)."""
        return self.new_size // 4 if epoch < self.curriculum_epochs else self.new_size // 2
