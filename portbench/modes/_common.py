"""What both modes share: the port's network built around the benchmark's
weights, the cell's route flags, and the reference's parameter shapes."""
from __future__ import annotations

import dataclasses
import importlib
import time

import torch

from portbench import weights as weights_mod
from portbench.reference import nets

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def shapes_of(cfg: dict):
    return nets.shader_shapes(cfg) if cfg["model"] == "shader" else nets.texface_shapes(cfg)


def make_weights(cfg: dict, seed: int, device):
    return weights_mod.make_weights(shapes_of(cfg), seed, device)


def set_routes(route: dict) -> None:
    """The cell's module flags, ``{"package.module.NAME": value}``."""
    for path, value in route.items():
        mod, _, attr = path.rpartition(".")
        m = importlib.import_module(mod)
        if not hasattr(m, attr):
            raise AttributeError(f"{mod} has no flag {attr}")
        setattr(m, attr, value)


def model_config(cfg: dict):
    """The port's ``ShaderConfig`` / ``TextureFaceConfig`` at the
    configuration's sizes."""
    if cfg["model"] == "shader":
        from rendernet_tpu_torch.models.shader import ShaderConfig as C
    else:
        from rendernet_tpu_torch.models.texture_face import TextureFaceConfig as C
    kw = {f.name: cfg[f.name] for f in dataclasses.fields(C) if f.name in cfg}
    kw["enc_channels"] = tuple(kw["enc_channels"])
    return C(**kw)


def build_net(cfg: dict, seed: int, device, clock=None):
    """The port's network with the benchmark's weights: every name must
    match. The network is built on ``device`` with the port's initializers
    (``nn/init.py``) making empty tensors, since every parameter is
    overwritten: the port has no way to build a network without drawing
    its weights leaf by leaf on the host."""
    clock = clock or Phases(torch.device(device))
    mcfg = model_config(cfg)
    if cfg["model"] == "shader":
        from rendernet_tpu_torch.models.shader import ShaderRenderNet as N
    else:
        from rendernet_tpu_torch.models.texture_face import TextureFaceRenderNet as N
    from rendernet_tpu_torch.nn import init as port_init

    clock.mark("import")
    saved = port_init.xavier_uniform, port_init.normal
    port_init.xavier_uniform = lambda shape, generator: torch.empty(tuple(shape))
    port_init.normal = lambda shape, generator, stddev=0.02: torch.empty(tuple(shape))
    try:
        with torch.device(device):
            net = N(mcfg, torch.Generator())
    finally:
        port_init.xavier_uniform, port_init.normal = saved
    clock.mark("modules")
    weights = make_weights(cfg, seed, device)
    clock.mark("weights")
    net.load_state_dict(weights, strict=True)
    return net.eval(), mcfg


def train_config(cfg: dict, cell: dict):
    from rendernet_tpu_torch.train.config import TrainConfig

    t = cfg["train"]
    return TrainConfig(batch_size=cell["mix"]["batch"], e_eta=t["e_eta"],
                       decay_steps=t["decay_steps"], decay_rate=t["decay_rate"],
                       is_greyscale=t["is_greyscale"], moment_dtype=t["moment_dtype"],
                       compute_dtype=cell["compute_dtype"], resample=cell["resample"],
                       img_res=cfg["new_size"] * cfg["image_factor"], new_size=cfg["new_size"])


class Phases:
    """Seconds of each phase of a set-up, each ending in a synchronise."""

    def __init__(self, dev):
        self.dev, self.seconds, self.t = dev, {}, time.perf_counter()

    def mark(self, name: str) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        t = time.perf_counter()
        self.seconds[name] = t - self.t
        self.t = t
