"""The reference's weight-directory format (numpy only).

The port's copy of ``rendernet_tpu/compat/tf_import.py``. The
reference keeps pretrained weights as one ``<key>.txt.npz`` per tensor in a
directory (array under ``arr_0``), keyed by the TF scope path with the top
scope dropped and '/' replaced by '_' (``tools/model_util.py:26-39``:
``e_conv1_e_conv1_weights``, ``Image_e_conv6_1_alpha``,
``g_zP_g_gc1_weights``). The JAX package's flat parameter paths mirror the
TF scopes and layouts, so translating is a key mapping; the port's modules
then load the flat dict with ``compat.jax_params.load_jax_params``.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterable, Optional

import numpy as np

__all__ = [
    "load_reference_weight_dir",
    "npz_key_for_path",
    "params_from_weight_dict",
    "weight_dict_from_params",
    "export_reference_weight_dir",
]

Params = Dict[str, np.ndarray]

_TOP_SCOPES = ("encoder", "texture_encoder")


def load_reference_weight_dir(weight_dir: str) -> Dict[str, np.ndarray]:
    """Read a directory of ``*.txt.npz`` files into {key: array}: the key is
    the file name up to its first '.', the value its ``arr_0``."""
    out: Dict[str, np.ndarray] = {}
    for path in glob.glob(os.path.join(weight_dir, "*.txt.npz")):
        with np.load(path) as data:
            out[os.path.basename(path).split(".")[0]] = data["arr_0"]
    return out


def npz_key_for_path(path: str) -> str:
    """Parameter path -> reference key: a leading 'encoder/' or
    'texture_encoder/' goes, the rest joins with '_'
    (``encoder/Image/e_conv6_1/alpha -> Image_e_conv6_1_alpha``)."""
    parts = path.split("/")
    if parts[0] in _TOP_SCOPES:
        parts = parts[1:]
    return "_".join(parts)


def params_from_weight_dict(template: Params, weight_dict: Dict[str, np.ndarray],
                            strict: bool = True) -> Params:
    """Fill a flat parameter dict (paths and shapes from ``template``) from a
    reference weight dict. An array of the right size but another shape is
    reshaped. ``strict`` raises on a missing key or a size mismatch;
    otherwise a missing key keeps the template's value and a misfit array
    is passed on as it is, for the strict module loader to refuse."""
    out: Params = {}
    missing = []
    for path, value in template.items():
        key = npz_key_for_path(path)
        value = np.asarray(value)
        if key in weight_dict:
            arr = np.asarray(weight_dict[key], np.float32)
            if arr.shape != value.shape:
                if arr.size == value.size:
                    arr = arr.reshape(value.shape)
                elif strict:
                    raise ValueError(f"shape mismatch for {path} ({key}): "
                                     f"{arr.shape} vs {value.shape}")
            out[path] = arr
        else:
            missing.append(key)
            out[path] = value
    if strict and missing:
        raise KeyError(f"weight dict missing {len(missing)} keys, e.g. {missing[:5]}")
    return out


def weight_dict_from_params(params: Params) -> Dict[str, np.ndarray]:
    """A flat parameter dict -> the reference's keyed weight dict."""
    return {npz_key_for_path(p): np.asarray(v) for p, v in params.items()}


def export_reference_weight_dir(params: Params, out_dir: str,
                                keys: Optional[Iterable[str]] = None) -> None:
    """Write a flat parameter dict as a reference weight directory: one
    ``<key>.txt.npz`` per tensor, under ``arr_0`` (``tf_import.py:100-110``);
    with ``keys``, only those."""
    os.makedirs(out_dir, exist_ok=True)
    for key, arr in weight_dict_from_params(params).items():
        if keys is not None and key not in keys:
            continue
        np.savez(os.path.join(out_dir, key + ".txt.npz"), arr)
