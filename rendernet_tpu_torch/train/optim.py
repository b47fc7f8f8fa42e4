"""Optimizer construction: Adam with a staircase schedule, in optax's terms.

Counterpart of ``rendernet_tpu/train/optim.py``. Reference semantics
(RenderNet_Shader.py:166-167): ``tf.train.exponential_decay(e_eta, step,
decay_steps, 0.96, staircase=True)`` into ``AdamOptimizer(beta1=0.5)`` (TF
defaults beta2=0.999, eps=1e-8). The JAX package builds it from optax; this
module keeps optax's shape so the two compare step by step: a
:class:`GradientTransformation` is an ``init(params) -> state`` and an
``update(grads, state, params) -> (updates, state)`` over dicts of tensors,
and :func:`apply_updates` adds the updates to the parameters. The port
updates the parameters in place (``torch.no_grad``), where JAX returns new
arrays. ``tx.update`` replaces the moments by new tensors each step.
:func:`update_and_apply`, the training steps' entry, runs ``tx.apply``
where a transformation has one and its parameters lie on the card: that of
:func:`make_optimizer`'s Adam without :func:`reject_nonfinite` is one launch
of ``ops/cuda_adam.py``'s kernel, which updates the parameters and both
moments in place.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from rendernet_tpu_torch.ops import cuda_adam

__all__ = [
    "GradientTransformation",
    "AdamState",
    "ScheduleState",
    "RejectNonFiniteState",
    "exponential_staircase",
    "scale_by_adam",
    "scale_by_learning_rate",
    "chain",
    "reject_nonfinite",
    "make_optimizer",
    "apply_updates",
    "update_and_apply",
]

Tensors = Dict[str, torch.Tensor]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable
    # ``update`` and :func:`apply_updates` in one, in place on the card:
    # ``apply(grads, state, params) -> state``; None where they run apart.
    apply: Optional[Callable] = None


class AdamState(NamedTuple):
    count: torch.Tensor  # int32, on the parameters' device
    mu: Tensors
    nu: Tensors


class ScheduleState(NamedTuple):
    count: torch.Tensor


class RejectNonFiniteState(NamedTuple):
    notfinite_count: torch.Tensor  # consecutive rejected updates
    total_notfinite: torch.Tensor
    inner_state: object


def _count0(params: Tensors) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=next(iter(params.values())).device)


def exponential_staircase(init_value: float, decay_steps: int,
                          decay_rate: float = 0.96) -> Callable:
    """lr(step) = init * rate^floor(step / decay_steps) (optax's
    ``exponential_decay`` with ``staircase=True``), for an int step or an
    int32 tensor (then an fp32 tensor, computed on its device)."""
    def schedule(count):
        if decay_steps <= 0 or decay_rate == 0:
            return init_value
        if isinstance(count, torch.Tensor):
            c = count.to(torch.float32)
            decayed = init_value * torch.pow(decay_rate, torch.floor(c / decay_steps))
            return torch.where(c <= 0, torch.full_like(c, init_value), decayed)
        if count <= 0:
            return init_value
        return init_value * decay_rate ** math.floor(count / decay_steps)

    return schedule


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  moment_dtype: torch.dtype | None = None) -> GradientTransformation:
    """optax's ``scale_by_adam`` update rule, with both moment buffers stored
    in ``moment_dtype`` (the parameters' dtype when None). The moments are
    loaded, updated and bias-corrected in fp32 and stored back rounded
    (``scale_by_adam_moments``, :92-147), so with fp32 storage this is
    optax's rule. The count lives on the device, as the bias correction
    reads it, so a step never waits for the host."""

    def init(params: Tensors) -> AdamState:
        def zeros(p):
            return torch.zeros_like(p, dtype=moment_dtype or p.dtype)

        return AdamState(_count0(params), {k: zeros(p) for k, p in params.items()},
                         {k: zeros(p) for k, p in params.items()})

    def update(grads: Tensors, state: AdamState, params=None):
        count, bc1, bc2 = _bias_corrections(state.count, b1, b2)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            updates[k], m32, v32 = cuda_adam.adam_moments(g, state.mu[k], state.nu[k], bc1, bc2,
                                                          b1, b2, eps)
            mu[k] = m32.to(state.mu[k].dtype)
            nu[k] = v32.to(state.nu[k].dtype)
        return updates, AdamState(count, mu, nu)

    return GradientTransformation(init, update)


def _bias_corrections(count: torch.Tensor, b1: float, b2: float):
    """(count + 1, 1 - b1^(count + 1), 1 - b2^(count + 1)) on the count's
    device."""
    count = count + 1
    c = count.to(torch.float32)
    return count, 1.0 - torch.pow(b1, c), 1.0 - torch.pow(b2, c)


def scale_by_learning_rate(schedule: Callable) -> GradientTransformation:
    """Multiply by ``-schedule(count)``, the count read before its increment
    (optax's ``scale_by_schedule``)."""

    def init(params) -> ScheduleState:
        return ScheduleState(_count0(params))

    def update(updates: Tensors, state: ScheduleState, params=None):
        lr = -schedule(state.count)
        return {k: u * lr for k, u in updates.items()}, ScheduleState(state.count + 1)

    return GradientTransformation(init, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in txs)

    def update(updates, state, params=None):
        new = []
        for t, s in zip(txs, state):
            updates, s = t.update(updates, s, params)
            new.append(s)
        return updates, tuple(new)

    return GradientTransformation(init, update)


def reject_nonfinite(inner: GradientTransformation) -> GradientTransformation:
    """Reject updates whose gradients hold NaN/Inf, always
    (``optim.py:reject_nonfinite``): the updates become zeros and the inner
    state stays as it was, so parameters and moments cannot be poisoned;
    ``notfinite_count`` counts consecutive rejections and
    ``total_notfinite`` all of them. The choice is made on the device
    (``torch.where``) so the step never waits for a host read: the inner
    update is computed either way, and the rejected one discarded."""

    def init(params) -> RejectNonFiniteState:
        return RejectNonFiniteState(_count0(params), _count0(params), inner.init(params))

    def update(grads: Tensors, state: RejectNonFiniteState, params=None):
        finite = torch.stack([torch.isfinite(g).all() for g in grads.values()]).all()
        new_updates, new_inner = inner.update(grads, state.inner_state, params)
        updates = {k: torch.where(finite, u, torch.zeros_like(u)) for k, u in new_updates.items()}
        rejected = finite.logical_not().to(torch.int32)
        return updates, RejectNonFiniteState(
            torch.where(finite, torch.zeros_like(state.notfinite_count),
                        state.notfinite_count + 1),
            state.total_notfinite + rejected,
            _select(finite, new_inner, state.inner_state))

    return GradientTransformation(init, update)


def _select(pred: torch.Tensor, new, old):
    """``new`` where ``pred`` else ``old``, leaf by leaf (tensors, dicts and
    tuples of them)."""
    if isinstance(new, torch.Tensor):
        return torch.where(pred, new, old)
    if isinstance(new, dict):
        return {k: _select(pred, new[k], old[k]) for k in new}
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_select(pred, n, o) for n, o in zip(new, old)))
    return tuple(_select(pred, n, o) for n, o in zip(new, old))


def make_optimizer(e_eta: float, decay_steps: int, decay_rate: float = 0.96,
                   b1: float = 0.5, b2: float = 0.999, eps: float = 1e-8,
                   skip_nonfinite: int = 0,
                   moment_dtype: str = "float32") -> GradientTransformation:
    """The reference Adam (``optim.py:make_optimizer``): Adam(b1, b2, eps)
    scaled by the staircase schedule; ``moment_dtype="bfloat16"`` stores the
    moments in bf16; ``skip_nonfinite > 0`` adds :func:`reject_nonfinite`
    (the count is the training loop's halt threshold), whose rejected step
    keeps the old state, so it has no in-place ``apply``."""
    if moment_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"moment_dtype must be 'float32' or 'bfloat16', got {moment_dtype!r}")
    schedule = exponential_staircase(e_eta, decay_steps, decay_rate)
    mdt = None if moment_dtype == "float32" else torch.bfloat16
    tx = chain(scale_by_adam(b1=b1, b2=b2, eps=eps, moment_dtype=mdt),
               scale_by_learning_rate(schedule))
    if skip_nonfinite > 0:
        return reject_nonfinite(tx)
    return tx._replace(apply=_fused_adam(b1, b2, eps, schedule))


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``params[k] += updates[k]``, in place."""
    for k, p in params.items():
        p.add_(updates[k].to(p.dtype))


def _fused_adam(b1: float, b2: float, eps: float, schedule: Callable) -> Callable:
    """``apply`` of ``chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(
    schedule))`` on the card: the whole update in one launch of the fused
    kernel (``ops/cuda_adam.py``), bit for bit the same, with the parameters
    and both moments updated in place; the returned state holds the same
    moment tensors as ``state``."""

    def apply(grads: Tensors, state, params: Tensors):
        adam, sched = state
        count, bc1, bc2 = _bias_corrections(adam.count, b1, b2)
        lr = -schedule(sched.count)
        names = list(params)
        cuda_adam.adam_([params[k] for k in names], [grads[k].contiguous() for k in names],
                        [adam.mu[k] for k in names], [adam.nu[k] for k in names], bc1, bc2, lr,
                        b1=b1, b2=b2, eps=eps)
        return AdamState(count, adam.mu, adam.nu), ScheduleState(sched.count + 1)

    return apply


def update_and_apply(tx: GradientTransformation, grads: Tensors, state, params: Tensors):
    """``tx.update`` then :func:`apply_updates`; returns the new state. Where
    ``tx`` has an ``apply`` and the parameters lie on the card, that runs
    instead (:func:`make_optimizer`'s Adam: one launch, in place); on the
    CPU, and for any other transformation, the two run as they are."""
    if tx.apply is not None and next(iter(params.values())).device.type == "cuda":
        return tx.apply(grads, state, params)
    updates, state = tx.update(grads, state, params)
    apply_updates(params, updates)
    return state
