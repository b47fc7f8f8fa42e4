"""Entry points for a quick check of the port: a forward of the shader model
and a data-parallel dry run (the counterpart of the repository root's
``__graft_entry__.py``, which stays the JAX package's).

    python -c "from rendernet_tpu_torch import graft_entry; graft_entry.dryrun_multichip(2)"
"""
from __future__ import annotations

import os
import tempfile

__all__ = ["entry", "dryrun_multichip"]


def entry(device=None):
    """(fn, example_args): a bf16 forward of the full shader model (a 64^3
    voxel grid and a pose to a 512^2 image through the whole
    rotate / resample / render pipeline) on ``device`` (the card unless the
    caller asks for the CPU), with a seeded network."""
    import torch

    from rendernet_tpu_torch import resolve_device
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward

    dev = resolve_device(device)
    net = init_shader_params(0, ShaderConfig(), device=dev)
    voxels = torch.zeros((1, 64, 64, 64, 1), dtype=torch.float32, device=dev)
    pose = torch.tensor([[4.36, 0.52, 1.0]], dtype=torch.float32, device=dev)

    @torch.no_grad()
    def fn(net, voxels, pose):
        return shader_forward(net, voxels, pose, compute_dtype=torch.bfloat16)

    return fn, (net, voxels, pose)


def _dryrun_rank(rank: int, n: int, init: str, device, model_cfg, out: str) -> None:
    import numpy as np
    import torch

    from rendernet_tpu_torch.train import distributed
    from rendernet_tpu_torch.train.config import TrainConfig
    from rendernet_tpu_torch.train.steps import create_shader_state, make_shader_train_step

    distributed.initialize_multihost(init, n, rank, device=device)
    try:
        mesh = distributed.make_mesh(device=device)
        cfg = TrainConfig(batch_size=n, img_res=128, new_size=32, compute_dtype="float32",
                          is_greyscale=True, e_eta=1e-4)
        state, tx = create_shader_state(0, model_cfg, cfg, device=mesh.device)
        state = distributed.replicate(mesh, state)
        step = make_shader_train_step(model_cfg, cfg, tx, 16, mesh=mesh)
        rng = np.random.default_rng(0)  # the global batch; this rank takes its row
        batch = ((rng.random((n, 16, 16, 16, 1)) > 0.7).astype(np.float32),
                 rng.random((n, 128, 128, 1)).astype(np.float32),
                 np.stack([rng.uniform(0, 6.28, n), rng.uniform(-1, 1, n), np.ones(n)],
                          axis=1).astype(np.float32))
        local, _, _ = distributed.process_shard(n)
        batch = distributed.shard_batch(mesh, tuple(a[rank * local:(rank + 1) * local]
                                                    for a in batch))
        _, loss = step(state, *batch, 1)
        loss = float(loss)
        if not np.isfinite(loss):
            raise FloatingPointError(f"rank {rank}: non-finite loss {loss}")
        if rank == 0:
            with open(out, "w") as f:
                f.write(repr(loss))
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None, model_cfg=None) -> float:
    """One shader training step over ``n_devices`` ranks (spawned processes,
    one process group): the batch sharded one sample per rank, the
    parameters replicated from rank 0, the gradients all-reduced; tiny
    shapes (new_size 32, patch 16; ``model_cfg`` default
    ``ShaderConfig(new_size=32)``, full widths). Ranks run on ``device``
    (their cards by default, sharing them past the card count; ``"cpu"``).
    Returns the loss, which must be finite; raises if any rank fails."""
    from rendernet_tpu_torch.models.shader import ShaderConfig
    from rendernet_tpu_torch.train.distributed import launch

    model_cfg = model_cfg or ShaderConfig(new_size=32)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "loss")
        launch(_dryrun_rank, n_devices, (n_devices, f"file://{tmp}/init", device, model_cfg, out))
        with open(out) as f:
            loss = float(f.read())
    print(f"dryrun_multichip({n_devices}): dp ok, loss={loss:.4f}")
    return loss
