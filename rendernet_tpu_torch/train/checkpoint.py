"""Checkpoint and weight persistence (PyTorch).

Counterpart of ``rendernet_tpu/train/checkpoint.py``, two of its three
mechanisms:

  1. Checkpoints of the whole ``TrainState`` (the network's state dict, the
     optimizer state, the step), the crash-resume path: one ``torch.save``
     file written beside its name and renamed into place, so a crash never
     leaves half a checkpoint (JAX writes an Orbax directory). The
     optimizer state is stored as its tensors in order, and restoring it
     needs a target of the same structure, as JAX's numbered leaves do.
  2. Flat ``.npz`` parameter archives under JAX's TF-scope keys and layouts
     (``compat/jax_params.py``): a params npz written by either package
     loads into the other.

In a process group both writers run on rank 0 alone, as JAX's chief-only
writes (the state is replicated, so rank 0's is every rank's); every rank
restores onto its own device.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from rendernet_tpu_torch.compat import jax_params
from rendernet_tpu_torch.train.distributed import is_chief

__all__ = ["save_checkpoint", "restore_checkpoint", "save_params_npz", "load_params_npz"]


def _flatten(tree) -> Tuple[Any, List[torch.Tensor]]:
    """(structure, tensor leaves in order) of a tree of NamedTuples, tuples,
    lists and dicts; the structure names each container's type and keys."""
    leaves: List[torch.Tensor] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            leaves.append(t)
            return "T"
        if isinstance(t, dict):
            return ("dict", tuple((k, walk(v)) for k, v in t.items()))
        if isinstance(t, (tuple, list)):
            return (type(t).__name__, tuple(walk(v) for v in t))
        raise TypeError(f"cannot checkpoint a {type(t).__name__} in the optimizer state")

    return walk(tree), leaves


def _unflatten(like, leaves: List[torch.Tensor]):
    """``like`` with its tensor leaves replaced, in order, by ``leaves``
    (each moved to the device and dtype of the leaf it replaces)."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, torch.Tensor):
            return next(it).to(device=t.device, dtype=t.dtype)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        vals = [walk(v) for v in t]
        if hasattr(t, "_fields"):
            return type(t)(*vals)
        return type(t)(vals)

    return walk(like)


def save_checkpoint(path: str, state) -> None:
    """Write ``state`` (a ``train.steps.TrainState``) to the file ``path``,
    atomically; on rank 0 only."""
    if not is_chief():
        return
    structure, leaves = _flatten(state.opt_state)
    payload = {"params": {k: v.detach().cpu() for k, v in state.params.state_dict().items()},
               "opt_structure": repr(structure),
               "opt_leaves": [t.detach().cpu() for t in leaves],
               "step": int(state.step)}
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, target=None):
    """Read a checkpoint; with ``target`` (a ``TrainState`` of the same
    network and optimizer) load it into ``target``'s network in place and
    return a ``TrainState`` with the saved optimizer state and step, else
    return the raw payload. Raises ``ValueError`` when the optimizer state's
    structure differs from the target's (``skip_nonfinite_updates``
    toggled between runs wraps it). The tensors are read onto the target's
    device (the CPU without a target)."""
    device = next(target.params.parameters()).device if target is not None else "cpu"
    payload = torch.load(os.path.abspath(path), map_location=device, weights_only=True)
    if target is None:
        return payload
    structure, _ = _flatten(target.opt_state)
    if repr(structure) != payload["opt_structure"]:
        raise ValueError("the checkpoint's optimizer state does not match the target's "
                         "structure")
    target.params.load_state_dict(payload["params"])
    opt_state = _unflatten(target.opt_state, payload["opt_leaves"])
    return type(target)(target.params, opt_state, payload["step"])


def save_params_npz(path: str, params: Union[nn.Module, Dict[str, Any]]) -> None:
    """Save a network (or a flat JAX param dict) as one ``.npz`` of JAX's
    flat TF-scope keys and layouts, atomically; on rank 0 only."""
    if not is_chief():
        return
    flat = jax_params.jax_params_from_module(params) if isinstance(params, nn.Module) else params
    tmp = f"{os.path.abspath(path)}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:  # np.savez would append .npz to a name
        np.savez(f, **{k: np.asarray(v) for k, v in flat.items()})
    os.replace(tmp, path)


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """The flat JAX param dict of a params ``.npz`` (either package's);
    ``compat.jax_params.load_jax_params`` loads it into a network."""
    return jax_params.load_params_npz(path)
