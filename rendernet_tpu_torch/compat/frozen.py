"""Frozen deployment artifacts via ``torch.export`` (``.pt2``).

Counterpart of ``rendernet_tpu/compat/frozen.py``, which freezes with
``jax.export``. The reference deploys by freezing a trained checkpoint
into a GraphDef ``.pb`` (``demo/RenderNet_converter.py:3-18``) that
``RenderNet_demo.py:23-30`` loads and runs with no model code. Here
:func:`freeze_fn` exports a module with its parameters as the program's
state, :func:`save_frozen` writes the ``.pt2`` file and :func:`load_frozen`
returns a runnable module on a device, importing nothing of the models.

As in JAX, the frozen pipeline is the **exact** pure-op path: the trace
runs with every kernel route forced to its plain version
(``_plain_routes``; the ctypes kernels read ``data_ptr()`` and cannot
be traced) and ``resample="exact"``. The sub-pixel deconvs stay, as
JAX's frozen graph keeps them: they are plain ops. Shapes are static per
artifact; freeze one per deployment batch size (the demo's is 1).

JAX's ``platforms`` (lowering targets) becomes the devices the artifact is
checked to run on at freeze time, ``"cpu"`` and ``"cuda"``: the program is
moved to each and run on the example inputs. A TPU has no ``torch.export``
runtime; ``"tpu"`` is refused.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
from typing import Callable, List, Sequence, Tuple

import torch
from torch import nn

__all__ = [
    "Frozen",
    "freeze_fn",
    "freeze_shader_render",
    "save_frozen",
    "load_frozen",
]

DEVICES = ("cpu", "cuda")
_META = "rendernet_frozen.json"


@dataclasses.dataclass
class Frozen:
    """An exported program, the devices it was checked on, and its inputs'
    shapes (``in_avals`` in JAX)."""

    program: torch.export.ExportedProgram
    platforms: Tuple[str, ...]
    in_shapes: List[Tuple[int, ...]]


@contextlib.contextmanager
def _plain_routes():
    """Every conv on its plain version: the kernel routes (K2, K3, K5) and
    the rewrites behind flags off; the flags are restored on exit, also
    when the body raises."""
    from rendernet_tpu_torch.nn import layers

    names = ("CUDA_CONV3D", "CUDA_CONV2D", "WINOGRAD_2D", "PHASE_CONV3D", "DEPTH_PACK")
    saved = {n: getattr(layers, n) for n in names}
    try:
        for n in names:
            setattr(layers, n, False)
        yield
    finally:
        for n, v in saved.items():
            setattr(layers, n, v)


class _Fn(nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn  # a module's parameters become the program's state

    def forward(self, *args):
        return self.fn(*args)


def _platforms(platforms) -> Tuple[str, ...]:
    if platforms is None:
        return ("cpu", "cuda") if torch.cuda.is_available() else ("cpu",)
    out = tuple(p.strip().lower() for p in platforms)
    bad = [p for p in out if p not in DEVICES]
    if bad:
        raise ValueError(f"frozen artifacts run on {DEVICES}, not {bad}: a torch.export "
                         "program has no TPU runtime (TPU artifacts are the JAX package's "
                         "jax.export ones)")
    return out


def _moved(program: torch.export.ExportedProgram, device: torch.device):
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(program, device)


def freeze_fn(fn: Callable, example_args: Tuple, *,
              platforms: Sequence[str] | None = None) -> Frozen:
    """Export ``fn(*example_args)`` (a module, or a callable closing over
    what it needs) under ``_plain_routes`` and ``torch.no_grad``, then
    run it on each of ``platforms`` (default: the CPU and, where there is
    one, the card), which must give finite outputs. ``example_args`` fix the
    static input shapes."""
    devices = _platforms(platforms)
    with _plain_routes(), torch.no_grad():
        program = torch.export.export(_Fn(fn).eval(), tuple(example_args))
        for dev in devices:
            d = torch.device(dev)
            out = _moved(program, d).module()(*(a.to(d) for a in example_args))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if not bool(torch.isfinite(t).all()):
                    raise RuntimeError(f"the frozen program gives non-finite values on {dev}")
    return Frozen(program, devices, [tuple(a.shape) for a in example_args])


def freeze_shader_render(params, cfg=None, *, batch: int = 1, voxel_size: int = 64,
                         platforms: Sequence[str] | None = None, device=None) -> Frozen:
    """Freeze the shader render pipeline with the parameters as the
    program's state: ``(voxels[batch, S, S, S, 1] f32, pose[batch, 3] f32)
    -> image``, the named feeds of the reference's frozen graph
    (``"real_model_in:0"`` / ``"view_name:0"`` -> ``"encoder/output:0"``).
    ``params`` is a ``ShaderRenderNet`` (traced on its device) or a flat
    JAX-layout parameter dict for ``cfg`` (default ``ShaderConfig()``),
    loaded onto ``device`` (the card unless the caller asks for the CPU).
    Exact resample, fp32."""
    from rendernet_tpu_torch.models.shader import ShaderConfig, init_shader_params, shader_forward

    if isinstance(params, nn.Module):
        net = params
    else:
        from rendernet_tpu_torch.compat.jax_params import load_jax_params

        net = load_jax_params(init_shader_params(0, cfg or ShaderConfig(), device=device),
                              params)

    class _Render(nn.Module):
        def __init__(self):
            super().__init__()
            self.net = net

        def forward(self, voxels, pose):
            return shader_forward(self.net, voxels, pose, resample="exact")

    dev = next(net.parameters()).device
    vox = torch.zeros((batch, voxel_size, voxel_size, voxel_size, 1), device=dev)
    pose = torch.zeros((batch, 3), device=dev)
    pose[:, 2] = 1.0
    return freeze_fn(_Render(), (vox, pose), platforms=platforms)


def save_frozen(frozen: Frozen, path: str) -> None:
    """Write the artifact to ``path`` (``torch.export.save``, atomic), with
    its platforms and input signature beside the program."""
    meta = {"platforms": list(frozen.platforms), "in_shapes": [list(s) for s in frozen.in_shapes]}
    buf = io.BytesIO()
    torch.export.save(frozen.program, buf, extra_files={_META: json.dumps(meta)})
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load_frozen(path: str, device=None) -> torch.nn.Module:
    """Load an artifact as a runnable module on ``device`` (the card unless
    the caller asks for the CPU), which must be one it was checked on. The
    module carries ``platforms`` and ``in_shapes``. Imports no model
    code."""
    from rendernet_tpu_torch import resolve_device

    dev = resolve_device(device)
    extra = {_META: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    if dev.type not in meta["platforms"]:
        raise ValueError(f"{path} was checked on {meta['platforms']}, not on {dev.type}")
    mod = _moved(program, dev).module()
    for p in mod.parameters():
        p.requires_grad_(False)
    mod.platforms = tuple(meta["platforms"])
    mod.in_shapes = [tuple(s) for s in meta["in_shapes"]]
    return mod
