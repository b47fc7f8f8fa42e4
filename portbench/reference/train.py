"""The reference's training: the losses of the two workloads and the
reference optimizer (``RenderNet_Shader.py:160-167``: Adam with beta1 0.5,
TF's beta2 0.999 and eps 1e-8, at the staircase schedule's first rate),
followed over the first steps of a run from the same weights and inputs.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple

import torch

from portbench.reference.nets import Params


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Greyscale: the per-image sum of the guarded BCE, mean over the batch."""
    bce = target * torch.log(1e-6 + pred) + (1.0 - target) * torch.log(1e-6 + 1.0 - pred)
    return torch.mean(-torch.sum(bce, dim=(1, 2, 3)))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


class Readings(NamedTuple):
    """Per step: the loss; per parameter: the first step's gradient norm and
    the norm of the change after the last step followed."""

    losses: List[float]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def follow(params0: Params, steps: int, batch: int, chunk: int,
           loss_of: Callable[[Params, int, slice], torch.Tensor], opt: dict) -> Readings:
    """``steps`` Adam steps from ``params0`` (not modified). ``loss_of(p, t,
    rows)`` is step ``t``'s loss over ``rows`` of its batch, as a mean over
    those rows; the batch is taken ``chunk`` rows at a time and the chunks'
    gradients are summed with weights rows / batch, which is the whole
    batch's mean (all rows have one size)."""
    b1, b2, eps, lr = opt["b1"], opt["b2"], opt["eps"], opt["e_eta"]
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, grad_norms = [], {}
    for t in range(steps):
        for v in p.values():
            v.grad = None
        total = 0.0
        for r0 in range(0, batch, chunk):
            rows = slice(r0, min(r0 + chunk, batch))
            share = (rows.stop - rows.start) / batch
            loss = loss_of(p, t, rows) * share
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        c = t + 1
        bc1, bc2 = 1.0 - b1 ** c, 1.0 - b2 ** c
        rate = lr * opt["decay_rate"] ** math.floor(t / opt["decay_steps"])
        with torch.no_grad():
            for k, w in p.items():
                g = w.grad
                if t == 0:
                    grad_norms[k] = float(g.double().norm())
                m[k] = (1 - b1) * g + b1 * m[k]
                v2[k] = (1 - b2) * (g * g) + b2 * v2[k]
                w -= rate * ((m[k] / bc1) / (torch.sqrt(v2[k] / bc2) + eps))
    with torch.no_grad():
        change = {k: float((p[k] - params0[k]).double().norm()) for k in p}
    return Readings(losses, grad_norms, change)
