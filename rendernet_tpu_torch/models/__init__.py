"""Models of the port."""
from __future__ import annotations

import torch


def param_shapes(cfg) -> dict:
    """{name: shape} of the parameters of the network that ``cfg`` (a
    ``ShaderConfig`` or a ``TextureFaceConfig``) configures, built on the
    meta device: no memory and no values."""
    from rendernet_tpu_torch.models import shader, texture_face

    net = (shader.ShaderRenderNet if isinstance(cfg, shader.ShaderConfig)
           else texture_face.TextureFaceRenderNet)
    with torch.device("meta"):
        return {k: tuple(p.shape) for k, p in net(cfg, None).named_parameters()}
