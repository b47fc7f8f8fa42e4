"""Seeded weights under the port's parameter names, made on the device.

The initializers are the reference layer library's: Glorot-uniform
convolution and transposed-convolution kernels (TF's fans: the receptive
field times in + out), normal(0.02) fully connected weights, biases 0.001
and PReLU slopes 0. All uniform draws are one call on a generator on the
device, all normal draws another; each kernel is a scaled slice.
"""
from __future__ import annotations

import math
from typing import Dict

import torch


def make_weights(spec: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` for every ``name: shape`` of ``spec``: the
    same seed and device give the same weights."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    kernels = [(k, s) for k, s in spec.items() if k.endswith(".weight") and len(s) > 2]
    dense = [(k, s) for k, s in spec.items() if k.endswith(".weight") and len(s) == 2]
    uni = torch.rand(sum(math.prod(s) for _, s in kernels), generator=gen, device=device)
    nrm = torch.randn(sum(math.prod(s) for _, s in dense) or 1, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    for k, s in kernels:
        n = math.prod(s)
        limit = math.sqrt(6.0 / ((s[0] + s[1]) * math.prod(s[2:])))
        out[k] = (uni[off:off + n].view(s) * 2.0 - 1.0) * limit
        off += n
    off = 0
    for k, s in dense:
        n = math.prod(s)
        out[k] = nrm[off:off + n].view(s) * 0.02
        off += n
    for k, s in spec.items():
        if k.endswith(".bias"):
            out[k] = torch.full(s, 0.001, device=device)
        elif k.endswith(".alpha"):
            out[k] = torch.zeros(s, device=device)
    missing = set(spec) - set(out)
    if missing:
        raise ValueError(f"no initializer for {sorted(missing)[:4]}")
    return {k: out[k] for k in spec}
