"""Data parallelism on ``torch.distributed``.

Counterpart of ``rendernet_tpu/train/distributed.py``. JAX lays a
``('data', 'model')`` mesh over the devices of its processes, shards the
batch over ``data`` and lets XLA emit the gradient all-reduce. PyTorch runs
one process (a rank) per card: a rank holds its own rows of the global batch
as a plain tensor on its card (JAX's multi-process input branch), and the
train step all-reduces the gradients itself, once per step after gradient
accumulation and before the optimizer's update (:func:`all_reduce_mean`):
one flat buffer in fp32, or in bf16 with ``TrainConfig.allreduce_dtype``
(JAX's shard_map path), summed by the collective and divided by the world
size (gloo has no average). Every rank then applies the same update.

The backend is NCCL where every rank of a host has a card of its own, else
gloo: on the CPU, and where ranks share a card (gloo stages CUDA tensors
through the host). Every collective runs under the group's ``timeout``, so a
rank that stops fails the others instead of hanging them.

The gradient all-reduce moves :func:`gradient_bytes` per step: 4 bytes per
parameter in fp32, 2 in bf16.

Spatial sharding: a mesh with a ``model`` axis above 1 (:func:`make_mesh`)
lays the ranks out as JAX's ``reshape(n_data, n_model)``, ``rank = d *
n_model + m``, and splits the camera grid's rows (axis 1 of ``[B, H, W, D,
C]``) and the image rows over the ranks of each model group
(:func:`spatial_sharding`, ``ops/halo.py``). Each rank warps and renders
its own rows; every conv and deconv extends its slab by the rows it reads
from its neighbours (a halo exchange, the counterpart of the ones XLA
inserts), the elementwise ops and the projection unit (a 1x1 conv over
depth and channels, local in the rows) need none. The train step sums the
loss and the gradients over the model axis in fp32 (each rank's are
partial sums over its rows) before the data axis's mean. The same holds
for the texture/face model (forward and train step; every rank decodes
the whole texture grid, and the gradient sum completes the decoder's) and
for inverse rendering (``recon_forward``, ``make_recon_step``, which sums
the per-sample losses and the latent gradients over the model axis, and
``reconstruct``, which also gathers each epoch's losses and latents over
the data axis, where the pose hypotheses split).
:func:`gather_rows` assembles the whole tensor. ``data_sharding`` has no
counterpart: a rank's tensor is its shard.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Any, Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from rendernet_tpu_torch.ops.halo import RowShard, neighbour_groups

__all__ = [
    "DEFAULT_TIMEOUT",
    "Mesh",
    "initialize_multihost",
    "world",
    "is_chief",
    "rank_device",
    "make_mesh",
    "make_hybrid_mesh",
    "spatial_sharding",
    "gather_rows",
    "shard_batch",
    "shard_host_local_batch",
    "process_shard",
    "replicate",
    "all_reduce_mean",
    "model_sum",
    "gradient_bytes",
    "launch",
]

# Every collective of the group waits at most this long for the other ranks.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def world() -> Tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_chief() -> bool:
    """True on rank 0, and in a run of one process: the rank that writes."""
    return world()[0] == 0


def rank_device() -> torch.device:
    """The card of this rank: ``cuda:{local rank % cards}``, where the local
    rank is torchrun's ``LOCAL_RANK`` or else the rank. Ranks beyond the
    host's cards share them."""
    return _card(world()[0])


def _card(rank: int) -> torch.device:
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def _env(*names: str) -> Optional[str]:
    for n in names:
        if os.environ.get(n):
            return os.environ[n]
    return None


def _is_local(url: str) -> bool:
    """Whether every rank of a group initialised at ``url`` runs on this host
    (a file store, or a loopback coordinator)."""
    if url.startswith("file://"):
        return True
    host = url.split("://", 1)[1].rsplit(":", 1)[0].strip("[]")  # "" for env://
    return host in ("localhost", "::1") or host.startswith("127.")


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device=None) -> bool:
    """Join this process to a process group; True when it did.

    A no-op (False) when a group is already up, or when nothing names a
    coordinator: neither ``coordinator_address`` nor ``JAX_COORDINATOR_ADDRESS``
    / ``COORDINATOR_ADDRESS`` nor torchrun's ``MASTER_ADDR`` (then joined
    through ``env://``). The address is ``host:port`` (TCP) or a URL
    (``tcp://...``, ``file://...``). The world size and rank come from the
    arguments, else ``JAX_NUM_PROCESSES`` / ``WORLD_SIZE`` and
    ``JAX_PROCESS_ID`` / ``RANK``; a world size or rank without a coordinator
    raises ``ValueError``.

    ``device`` is where this rank trains (default: its card,
    :func:`rank_device`; ``"cpu"`` for the CPU). On CUDA the rank binds to
    that card, and the backend is NCCL unless the ranks on this host
    outnumber its cards (torchrun's ``LOCAL_WORLD_SIZE``; every rank when
    the coordinator is local): NCCL refuses two ranks on one card, so they
    take gloo. The CPU takes gloo."""
    if dist.is_initialized():
        return False
    addr = coordinator_address or _env("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = "env://"  # torchrun's rendezvous (its store may be the agent's)
    if addr is None:
        if num_processes is not None or process_id is not None:
            raise ValueError(
                "a process count or id needs a coordinator: pass --coordinator host:port (or "
                "set JAX_COORDINATOR_ADDRESS, or launch with torchrun)")
        return False
    n = num_processes if num_processes is not None else _env("JAX_NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None else _env("JAX_PROCESS_ID", "RANK")
    if n is None or rank is None:
        raise ValueError(f"coordinator {addr!r} given without the number of processes and "
                         "this process's id (--num-processes, --process-id)")
    n, rank = int(n), int(rank)
    if not 0 <= rank < n:
        raise ValueError(f"process id {rank} is outside 0..{n - 1}")
    url = addr if "://" in addr else f"tcp://{addr}"
    dev = torch.device("cuda" if device is None else device)
    backend = "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA rank on a machine with no card; pass device='cpu' "
                               "(CLI: --device cpu) to train on the CPU")
        cards = torch.cuda.device_count()
        torch.cuda.set_device(dev if dev.index is not None else _card(rank))
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n if _is_local(url) else cards))
        backend = "nccl" if local <= cards else "gloo"
    dist.init_process_group(backend, init_method=url, world_size=n, rank=rank,
                            timeout=DEFAULT_TIMEOUT)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``('data', 'model')`` mesh over the ranks: ``shape`` maps each axis
    to its size, as JAX's ``Mesh.shape``; ``group`` is the data axis's
    process group (this rank's and the ranks at its model index; None in a
    run of one process), ``model_group`` the model axis's (None without a
    model axis), ``model_pairs`` the groups of its adjacent ranks (the halo
    exchange's) and ``model_rank`` this rank's index on it; ``device`` this
    rank's device."""

    shape: Mapping[str, int]
    group: Any
    device: torch.device
    axis_names: Tuple[str, str] = ("data", "model")
    model_group: Any = None
    model_rank: int = 0
    model_pairs: Tuple[Any, ...] = ()


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None) -> Mesh:
    """The ``('data', 'model')`` mesh over every rank of the group (one rank
    in a run of one process), laid out as JAX's ``reshape(n_data,
    n_model)``: rank ``d * n_model + m`` sits at data index ``d`` and model
    index ``m``, the model axis minormost. ``n_data`` defaults to the world
    size over ``n_model``; ``n_data * n_model`` must be the world size
    (PyTorch runs one process per card), else ``ValueError``. Every rank
    creates every group, in the same order. ``device``: this rank's
    (default :func:`rank_device` in a group, else the card; ``"cpu"``)."""
    from rendernet_tpu_torch import resolve_device

    rank, n = world()
    if n_model < 1 or n % n_model:
        raise ValueError(f"a model axis of {n_model} over {n} process(es)")
    if n_data is None:
        n_data = n // n_model
    if n_data * n_model != n:
        raise ValueError(
            f"a ({n_data}, {n_model}) mesh over {n} process(es): PyTorch runs one process per "
            f"card, so launch {n_data * n_model} processes (torchrun --nproc-per-node "
            f"{n_data * n_model}, or --coordinator / --num-processes / --process-id on each)")
    dev = resolve_device(device)
    if n_model == 1:
        return Mesh({"data": n, "model": 1}, dist.group.WORLD if dist.is_initialized() else None,
                    dev)
    data_group = model_group = None
    model_pairs = ()
    for m in range(n_model):  # the data axis's groups, then the model axis's
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):  # each model axis's group and its neighbour pairs
        line = [d * n_model + m for m in range(n_model)]
        g, pairs = dist.new_group(line), neighbour_groups(line)
        if rank // n_model == d:
            model_group, model_pairs = g, pairs
    return Mesh({"data": n_data, "model": n_model}, data_group, dev,
                model_group=model_group, model_rank=rank % n_model, model_pairs=model_pairs)


def make_hybrid_mesh(n_model: int = 1, device=None) -> Mesh:
    """The mesh over every rank, in rank order (node-major under torchrun and
    ``--process-id`` numbering). JAX lays its data axis out DCN-major so
    that the all-reduce crosses hosts once per slice; NCCL picks its own
    rings and trees within and across nodes, so the layout is the same as
    :func:`make_mesh`'s (a model group is ``n_model`` consecutive ranks)."""
    return make_mesh(n_model=n_model, device=device)


def spatial_sharding(mesh: Mesh, ndim: int, axis: int = 1) -> RowShard:
    """Axis ``axis`` of ``ndim``-D tensors sharded over the mesh's model
    axis, JAX's ``NamedSharding(mesh, P(None, 'model', ...))``: a
    :class:`~rendernet_tpu_torch.ops.halo.RowShard` that answers this
    rank's rows of a whole tensor (``take``, ``rows``) and of its own
    (``local_rows``). Axis 1 only, as JAX's callers shard (the camera
    grid's and the images' rows); another raises ``NotImplementedError``."""
    if axis != 1:
        raise NotImplementedError(f"spatial sharding of axis {axis}: the port shards axis 1 "
                                  "(the rows), as JAX's callers do")
    if ndim < 2:
        raise ValueError(f"a {ndim}-D tensor has no axis 1")
    return RowShard(mesh.model_rank, mesh.shape["model"], mesh.model_group, axis,
                    mesh.model_pairs)


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: int = 1) -> torch.Tensor:
    """The whole tensor from this rank's rows ``x`` along ``axis`` (an
    all-gather over the model axis, in model order), as JAX gives a
    sharded array to its reader; ``x`` itself without a model axis. Not
    differentiated."""
    return spatial_sharding(mesh, x.dim(), axis).gather(x)


def shard_host_local_batch(mesh: Mesh, batch):
    """This rank's rows of the global batch (global = world x local, in rank
    order along axis 0) as tensors on the rank's device. ``batch``: an array
    or tensor, or a tuple, list or dict of them."""
    def put(x):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        return x.to(mesh.device)

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(put(x) for x in batch)
    return put(batch)


def shard_batch(mesh: Mesh, batch):
    """The batch on this rank's device. As JAX's multi-process branch, the
    input is this rank's shard (:func:`shard_host_local_batch`); in a run of
    one process it is the whole batch."""
    return shard_host_local_batch(mesh, batch)


def process_shard(batch_size: int) -> Tuple[int, int, int]:
    """(local batch, rank, world size) for a global batch size; the loaders
    stride the dataset by (rank, world size) so each rank reads a disjoint
    subset."""
    rank, n = world()
    if batch_size % n:
        raise ValueError(f"global batch {batch_size} not divisible by {n} processes")
    return batch_size // n, rank, n


def replicate(mesh: Mesh, state):
    """Make every rank's ``TrainState`` equal to rank 0's: its parameters,
    buffers, optimizer state and step, in one broadcast of their bytes over
    the whole world (over the data group alone, which is the world,
    without a model axis). Returns the state (its tensors overwritten in
    place)."""
    from rendernet_tpu_torch.train.checkpoint import _flatten

    if mesh.group is None or mesh.shape["data"] * mesh.shape["model"] == 1:
        return state
    net = state.params
    leaves = ([t.detach() for t in net.parameters()] + list(net.buffers())
              + _flatten(state.opt_state)[1])
    step = torch.tensor([int(state.step)], dtype=torch.int64, device=mesh.device)
    leaves.append(step)
    if any(t.device != mesh.device for t in leaves):
        raise ValueError(f"replicate: the state is not on the mesh's device {mesh.device}")
    flat = torch.cat([t.view(-1).view(torch.uint8) for t in leaves])
    dist.broadcast(flat, src=0, group=mesh.group if mesh.shape["model"] == 1 else None)
    off = 0
    with torch.no_grad():
        for t in leaves:
            dst = t.view(-1).view(torch.uint8)
            dst.copy_(flat[off:off + dst.numel()])
            off += dst.numel()
    return dataclasses.replace(state, step=int(step.item()))


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh,
                    dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """The mean over the data axis of each tensor, as fp32 tensors of the
    same shapes: the tensors are cast to ``dtype`` into one flat buffer,
    summed by one all-reduce over ``mesh.group``, cast to fp32 and divided
    by the axis's size."""
    sizes = [t.numel() for t in tensors]
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    flat = flat.to(torch.float32).div_(mesh.shape["data"])
    return [c.view(t.shape) for c, t in zip(torch.split(flat, sizes), tensors)]


def model_sum(tensors: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """The sum over the model axis of each tensor, as fp32 tensors of the
    same shapes (one flat fp32 buffer, one all-reduce over
    ``mesh.model_group``): under spatial sharding each rank's loss and
    gradients are partial sums over its rows."""
    sizes = [t.numel() for t in tensors]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.model_group)
    return [c.view(t.shape) for c, t in zip(torch.split(flat, sizes), tensors)]


def gradient_bytes(net: torch.nn.Module, dtype: torch.dtype = torch.float32) -> int:
    """Bytes that one gradient all-reduce of ``net`` moves into each rank:
    its parameter count times the all-reduce dtype's size."""
    return sum(p.numel() for p in net.parameters()) * torch.empty((), dtype=dtype).element_size()


def launch(fn: Callable, nprocs: int, args: tuple = (), timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` fresh (spawned) processes and
    wait for all of them, at most ``timeout`` seconds. Raises if a rank
    fails (the others are then stopped) or the time runs out; ``fn`` must be
    importable by name (a module-level function)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.01)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks of {getattr(fn, '__name__', fn)} did not "
                                   f"finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
