"""The numbers that decide ``correct``, each against its limit.

Training (the first steps, which the reference follows from the same
weights and inputs): ``loss_gap``, the largest relative gap of a step's
loss; ``grad_gap``, the worst parameter's gap between the program's and the
reference's norms of the first gradient, and ``grad_gap_median``, the
median parameter's (the worst is one of the cancelling bias sums of the
early layers, whose rounding swings from seed to seed); ``change_gap``, the
worst parameter's gap of the parameters' change over the steps followed. A norm's gap is measured
against the reference's norm of that parameter or of the median parameter,
whichever is larger. Parameters whose reference gradient is under a
thousandth of the median's move under Adam by round-off alone and are left
out of ``change_gap``.

Rendering (a sample of the window's requests): ``image_gap``, the largest
absolute difference of a served pixel from the reference's, and
``image_rel``, the worst image's RMS difference over the RMS of the
reference image about its mean.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import torch

SMALL_GRAD = 1e-3


def norm_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: Sequence[str] | None = None) -> Dict[str, float]:
    """Each parameter's gap between the two norms, against the larger of its
    reference norm and the median parameter's."""
    keys = list(ref) if keys is None else list(keys)
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def train_numbers(prog, ref) -> Dict[str, float]:
    """``prog`` and ``ref``: ``reference.train.Readings``."""
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]
    grad = norm_gaps(prog.grad_norms, ref.grad_norms)
    med = statistics.median(ref.grad_norms.values())
    moving = [k for k, g in ref.grad_norms.items() if g >= SMALL_GRAD * med]
    change = norm_gaps(prog.change_norms, ref.change_norms, moving)
    return {"loss_gap": max(loss_gaps), "grad_gap": max(grad.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap": max(change.values()), "_loss_gaps": loss_gaps,
            "_grad_leaf": max(grad, key=grad.get), "_change_leaf": max(change, key=change.get),
            "_left_out": len(ref.grad_norms) - len(moving)}


def image_numbers(pairs: List[Tuple[torch.Tensor, torch.Tensor]]) -> Dict[str, float]:
    """``pairs`` of (served, reference) images, float, one shape each."""
    gap = rel = 0.0
    for p, r in pairs:
        p, r = p.double(), r.double()
        d = (p - r).flatten(1)
        gap = max(gap, float(d.abs().max()))
        spread = (r - r.mean(dim=tuple(range(1, r.dim())), keepdim=True)).flatten(1)
        rel = max(rel, float((d.norm(dim=1) / spread.norm(dim=1).clamp_min(1e-30)).max()))
    return {"image_gap": gap, "image_rel": rel}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, list]]:
    """``correct`` (every limited number within its limit, none missing or
    not finite) and ``{name: [number, limit]}`` for the result line."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and abs(v) != float("inf") and v <= limit
        ok = ok and good
        out[name] = [v, limit]
    return ok, out
