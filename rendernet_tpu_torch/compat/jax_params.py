"""Carry weights between the JAX package's flat parameter dicts and the
port's modules.

The JAX package keeps parameters as ``{tf_scope_path: array}``
(``encoder/e_conv1/e_conv1/weights``) in HWIO / DHWIO layout, with TF's
conv-transpose kernels as spatial + (out, in), and saves them as one
``.npz`` (``train/checkpoint.py:83-93``). The port names the same tensor
``encoder.e_conv1.e_conv1.weight`` in OIHW / OIDHW layout (conv-transpose:
(in, out) + spatial, PyTorch's ConvTranspose layout). Both kernel layouts
map by the same permutation: the last two axes move to the front,
reversed; for a fully connected weight (JAX (in, out), the port (out, in),
PyTorch's Linear layout) that permutation is the transpose. Loading is
strict: a missing, unexpected or misshapen key raises.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from rendernet_tpu_torch.nn.layers import to_jax_layout, to_torch_layout

__all__ = [
    "tf_path_to_torch",
    "torch_name_to_tf",
    "load_jax_params",
    "jax_params_from_module",
    "load_params_npz",
    "save_params_npz",
]

_LEAF_TO_TORCH = {"weights": "weight", "biases": "bias"}
_LEAF_TO_TF = {v: k for k, v in _LEAF_TO_TORCH.items()}


def tf_path_to_torch(path: str) -> str:
    *scopes, leaf = path.split("/")
    return ".".join(scopes + [_LEAF_TO_TORCH.get(leaf, leaf)])


def torch_name_to_tf(name: str) -> str:
    *scopes, leaf = name.split(".")
    return "/".join(scopes + [_LEAF_TO_TF.get(leaf, leaf)])


def load_jax_params(net: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Copy a JAX flat param dict into ``net`` in place; returns ``net``."""
    state = net.state_dict()
    given = {tf_path_to_torch(k): k for k in flat}
    missing = sorted(torch_name_to_tf(k) for k in set(state) - set(given))
    unexpected = sorted(given[k] for k in set(given) - set(state))
    if missing or unexpected:
        raise KeyError(f"JAX params do not match the network: missing {missing}, "
                       f"unexpected {unexpected}")
    with torch.no_grad():
        for name, path in given.items():
            arr = torch.from_numpy(np.array(flat[path], np.float32))
            if arr.dim() >= 2:
                arr = to_torch_layout(arr)
            if tuple(arr.shape) != tuple(state[name].shape):
                raise ValueError(f"{path}: shape {tuple(np.shape(flat[path]))} does not "
                                 f"match the network's {tuple(state[name].shape)} "
                                 "(in its own layout)")
            state[name].copy_(arr)
    return net


def jax_params_from_module(net: nn.Module) -> Dict[str, np.ndarray]:
    """The JAX flat param dict (TF paths, JAX layouts) of ``net``."""
    return {
        torch_name_to_tf(name):
            (to_jax_layout(t) if t.dim() >= 2 else t).detach().cpu().contiguous().numpy()
        for name, t in net.state_dict().items()
    }


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """Read a flat param ``.npz`` as written by ``save_params_npz``."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_params_npz(path: str, params: Dict[str, np.ndarray]) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
