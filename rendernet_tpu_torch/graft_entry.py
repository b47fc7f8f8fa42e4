"""Entry points for a quick check of the port: a forward of the shader model
(:func:`entry`) and a multi-rank dry run (:func:`dryrun_multichip`), the
counterparts of the repository root's ``__graft_entry__.py``, which stays
the JAX package's. The dry run's phases: 1, one data-parallel train step;
with 4 or more ranks, an even number, on a ``(n / 2, 2)`` mesh, 2, the
dp + spatial forward (the grid's rows over the model axis, halo exchanges
through the conv stacks) and 2b, one dp + spatial train step (the batch
over data, the voxel and image rows over model); then 3, one data-parallel
texture/face train step, and 4, an inverse-rendering scan of two steps with
the pose hypotheses over the data axis, one per rank.

    python -c "from rendernet_tpu_torch import graft_entry; graft_entry.dryrun_multichip(4)"
"""
from __future__ import annotations

import json
import os
import tempfile

__all__ = ["entry", "dryrun_multichip", "DRYRUN_PHASES"]

# The phases of dryrun_multichip, by the keys of its result.
DRYRUN_PHASES = {"loss": "1: data-parallel train step",
                 "spatial_forward": "2: dp + spatial forward (output shape)",
                 "spatial_loss": "2b: dp + spatial train step",
                 "texture_loss": "3: data-parallel texture/face train step",
                 "recon_losses": "4: recon scan, hypotheses over data (loss history [T, n])"}


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
        arrays = ((rng.random((n, 16, 16, 16, 1)) > 0.7).astype(np.float32),
                  rng.random((n, 128, 128, 1)).astype(np.float32),
                  np.stack([rng.uniform(0, 6.28, n), rng.uniform(-1, 1, n), np.ones(n)],
                           axis=1).astype(np.float32))
        local, _, _ = distributed.process_shard(n)
        batch = distributed.shard_batch(mesh, tuple(a[rank * local:(rank + 1) * local]
                                                    for a in arrays))
        _, loss = step(state, *batch, 1)
        res = {"loss": float(loss)}
        if not np.isfinite(res["loss"]):
            raise FloatingPointError(f"rank {rank}: non-finite loss {res['loss']}")
        if n >= 4 and n % 2 == 0:
            res.update(_spatial_phases(rank, n, device, model_cfg, cfg, arrays))
        res.update(_texture_and_recon_phases(rank, n, mesh, cfg, arrays, rng))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def _spatial_phases(rank: int, n: int, device, model_cfg, cfg, arrays) -> dict:
    """Phases 2 and 2b on the ``(n / 2, 2)`` mesh: the forward of the whole
    batch with the raw grid's rows over the model axis (finite, gathered),
    and one train step with the batch over data and the voxel and image
    rows over model (its loss)."""
    import numpy as np
    import torch

    from rendernet_tpu_torch.models.shader import init_shader_params, shader_forward
    from rendernet_tpu_torch.train import distributed
    from rendernet_tpu_torch.train.steps import create_shader_state, make_shader_train_step

    mesh = distributed.make_mesh(n_data=n // 2, n_model=2, device=device)
    shard = distributed.spatial_sharding(mesh, 5)
    vox, images, poses = (torch.from_numpy(a).to(mesh.device) for a in arrays)
    net = init_shader_params(2, model_cfg, device=mesh.device)
    with torch.no_grad():
        img = shader_forward(net, shard.take(vox), poses, mesh=mesh, gather=True)
    if not bool(torch.isfinite(img).all()):
        raise FloatingPointError(f"rank {rank}: the dp + spatial forward is not finite")
    state, tx = create_shader_state(5, model_cfg, cfg, device=mesh.device)
    state = distributed.replicate(mesh, state)
    step = make_shader_train_step(model_cfg, cfg, tx, 16, mesh=mesh)
    d = rank // 2  # P("data", "model"): this data index's rows of the batch, then its slab
    local = n // mesh.shape["data"]
    rows = slice(d * local, (d + 1) * local)
    _, loss = step(state, shard.take(vox[rows]), shard.take(images[rows]), poses[rows], 6)
    loss = float(loss)
    if not np.isfinite(loss):
        raise FloatingPointError(f"rank {rank}: non-finite dp + spatial loss {loss}")
    return {"spatial_forward": list(img.shape), "spatial_loss": loss}


def _texture_and_recon_phases(rank: int, n: int, mesh, cfg, arrays, rng) -> dict:
    """Phase 3, one texture/face train step at ``TextureFaceConfig(new_size=32,
    tex_base=4, tex_grid=16)``, patch 16, with the batch sharded one sample
    per rank (textures, images and normals drawn after phase 1's arrays, as
    JAX's dry run draws them), and phase 4, a
    ``make_recon_step(scan_steps=2)`` run at ``ReconConfig(z_dim=16,
    batch_size=n, inner_steps=2, new_size=32, resample="exact")``, each
    rank on its hypothesis and its target; its loss history is gathered
    over the ranks."""
    import numpy as np
    import torch

    from rendernet_tpu_torch.models.decoders import (
        init_recon_rendernet_params,
        init_recon_texture_decoder_params,
        init_shape_decoder_params,
    )
    from rendernet_tpu_torch.models.texture_face import TextureFaceConfig
    from rendernet_tpu_torch.recon.inverse import (
        Latents,
        ReconConfig,
        ReconModel,
        initial_latents,
        make_recon_step,
    )
    from rendernet_tpu_torch.train import distributed
    from rendernet_tpu_torch.train.steps import create_texture_state, make_texture_train_step

    tex = (rng.random((n, 128, 128, 3)).astype(np.float32),
           rng.random((n, 128, 128, 3)).astype(np.float32),
           rng.random((n, 199)).astype(np.float32))
    mine = slice(rank, rank + 1)
    texture_cfg = TextureFaceConfig(new_size=32, tex_base=4, tex_grid=16)
    state, tx = create_texture_state(3, texture_cfg, cfg, device=mesh.device)
    state = distributed.replicate(mesh, state)
    step = make_texture_train_step(texture_cfg, cfg, tx, 16, mesh=mesh)
    vox, images, normals, codes, poses = distributed.shard_batch(
        mesh, tuple(a[mine] for a in (arrays[0], *tex, arrays[2])))
    _, loss = step(state, vox, images, normals, codes, poses, 4)
    tloss = float(loss)
    if not np.isfinite(tloss):
        raise FloatingPointError(f"rank {rank}: non-finite texture loss {tloss}")

    rcfg = ReconConfig(z_dim=16, batch_size=n, inner_steps=2, new_size=32, resample="exact")
    model = ReconModel(init_shape_decoder_params(7, z_dim=16, device=mesh.device),
                       init_recon_texture_decoder_params(8, device=mesh.device),
                       init_recon_rendernet_params(9, new_size=32, device=mesh.device))
    lat = initial_latents(rcfg, device=mesh.device)
    target = torch.from_numpy(rng.random((n, 128, 128, 3)).astype(np.float32)).to(mesh.device)
    run = make_recon_step(model, rcfg, scan_steps=rcfg.inner_steps, mesh=mesh)
    _, hist = run(Latents(*(t[mine] for t in lat)), target[mine])
    parts = [torch.empty_like(hist) for _ in range(n)]
    torch.distributed.all_gather(parts, hist.contiguous())
    losses = torch.cat(parts, dim=1).cpu().numpy()
    if losses.shape != (rcfg.inner_steps, n) or not np.isfinite(losses).all():
        raise FloatingPointError(f"rank {rank}: recon loss history {losses}")
    return {"texture_loss": tloss, "recon_losses": losses.tolist()}


def dryrun_multichip(n_devices: int, device=None, model_cfg=None) -> dict:
    """The dry run over ``n_devices`` ranks (spawned processes, one process
    group), tiny shapes (new_size 32, patch 16; ``model_cfg`` default
    ``ShaderConfig(new_size=32)``, full widths), ranks on ``device`` (their
    cards by default, sharing them past the card count; ``"cpu"``):
    phase 1, one shader train step with the batch sharded one sample per
    rank, the parameters replicated from rank 0 and the gradients
    all-reduced; with ``n_devices`` >= 4 and even, phases 2 and 2b on a
    ``(n / 2, 2)`` mesh; then phase 3, one texture/face train step on the
    data-parallel mesh and phase 4, an inverse-rendering scan with one pose
    hypothesis per rank (:data:`DRYRUN_PHASES`). Returns rank 0's results (``loss``,
    ``spatial_forward`` / ``spatial_loss``, ``texture_loss``,
    ``recon_losses``), which must be finite; raises if any rank fails."""
    from rendernet_tpu_torch.models.shader import ShaderConfig
    from rendernet_tpu_torch.train.distributed import launch

    model_cfg = model_cfg or ShaderConfig(new_size=32)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        launch(_dryrun_rank, n_devices, (n_devices, f"file://{tmp}/init", device, model_cfg, out))
        with open(out) as f:
            res = json.load(f)
    print(f"dryrun_multichip({n_devices}): dp ok, loss={res['loss']:.4f}")
    if "spatial_loss" in res:
        print(f"dryrun_multichip({n_devices}): dp+spatial ok, out={tuple(res['spatial_forward'])}")
        print(f"dryrun_multichip({n_devices}): dp+spatial TRAIN ok, "
              f"loss={res['spatial_loss']:.4f}")
    print(f"dryrun_multichip({n_devices}): texture dp ok, loss={res['texture_loss']:.4f}")
    print(f"dryrun_multichip({n_devices}): recon scan ok, "
          f"loss={sum(res['recon_losses'][-1]) / n_devices:.4f}")
    return res
