"""Weight initializers of the reference layer library (PyTorch).

Counterpart of ``rendernet_tpu/nn/init.py``: Glorot-uniform conv weights
with TF's fan convention (the last two dims are (in, out), the leading dims
the receptive field), and constant biases. Values come from a
``torch.Generator``, so they follow the same distributions as the JAX
initializers, not the same numbers; tests carry JAX's weights across
instead (``compat/jax_params.py``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["xavier_uniform", "constant", "zeros"]


def _fans(shape: Sequence[int]) -> tuple[float, float]:
    if len(shape) < 2:
        return float(shape[0]), float(shape[0])
    receptive = math.prod(shape[:-2])
    return float(shape[-2] * receptive), float(shape[-1] * receptive)


def xavier_uniform(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Glorot uniform for a TF-layout ``shape`` (spatial..., in, out)."""
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(tuple(shape), generator=generator) * 2.0 - 1.0) * limit


def constant(shape: Sequence[int], value: float) -> torch.Tensor:
    return torch.full(tuple(shape), float(value))


def zeros(shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape))
