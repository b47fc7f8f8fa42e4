"""Weights from a frozen TensorFlow GraphDef (``.pb``).

Counterpart of ``rendernet_tpu/compat/pb_import.py``. The reference
releases its pretrained demo network as a frozen GraphDef
(``convert_variables_to_constants(["encoder/output"])``,
``demo/RenderNet_converter.py:3-18``). Freezing names each Const after the
variable it replaced, the TF scope path (``encoder/e_conv1/e_conv1/weights``),
which is the flat parameter path of both packages, so importing is a
name-keyed copy into a flat JAX-layout dict (TF's layouts), which
``compat.jax_params.load_jax_params`` loads into a network.

TensorFlow is imported inside :func:`load_frozen_graphdef_weights` only,
to parse the protobuf: importing this module, or the port, never imports
it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

__all__ = ["load_frozen_graphdef_weights", "params_from_frozen_pb"]


def load_frozen_graphdef_weights(pb_path: str) -> Dict[str, np.ndarray]:
    """Every Const tensor of a frozen ``.pb`` as {node name: array}."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise RuntimeError(
            "importing a frozen GraphDef requires tensorflow (CPU build is "
            "enough); alternatively export the reference checkpoint to "
            "*.txt.npz files and use load_reference_weight_dir"
        ) from e

    gd = tf.compat.v1.GraphDef()
    with open(pb_path, "rb") as f:
        gd.ParseFromString(f.read())
    out: Dict[str, np.ndarray] = {}
    for node in gd.node:
        if node.op == "Const" and "value" in node.attr:
            try:
                out[node.name] = np.asarray(tf.make_ndarray(node.attr["value"].tensor))
            except Exception:
                continue  # non-tensor consts (shape metadata, say)
    return out


def params_from_frozen_pb(template: Dict[str, Any], pb_path: str,
                          strict: bool = True) -> Dict[str, np.ndarray]:
    """A frozen pb's Const weights on ``template``'s parameter paths (a
    ``/read`` suffix on a name is accepted). ``strict`` raises on template
    paths the pb lacks; otherwise they keep the template's values, with a
    warning that counts them. A shape mismatch always raises."""
    consts = load_frozen_graphdef_weights(pb_path)
    out: Dict[str, np.ndarray] = {}
    missing = []
    for path, value in template.items():
        src = consts.get(path)
        if src is None:
            src = consts.get(path + "/read")
        if src is None:
            missing.append(path)
            out[path] = np.asarray(value)
            continue
        want = tuple(np.shape(value))
        if tuple(src.shape) != want:
            raise ValueError(f"{path}: pb tensor shape {src.shape} != template {want}")
        out[path] = src.astype(np.asarray(value).dtype)
    if missing:
        if strict:
            raise KeyError(f"frozen pb is missing {len(missing)} params, e.g. {missing[:5]}")
        print(f"WARNING: frozen pb provided {len(template) - len(missing)}/{len(template)} "
              f"params; {len(missing)} keep template init, e.g. {missing[:3]}")
    return out
