"""Row sharding over a ``model`` process group, and the halo exchange.

Counterpart of what XLA inserts for JAX's ``spatial_sharding``
(``train/distributed.py``): the camera grid's rows (axis 1 of ``[B, H, W,
D, C]``) and the image rows split evenly over the ranks of the model axis,
each rank holding one contiguous slab. A conv reads rows beyond its slab;
:func:`exchange` extends a slab by the rows above (``lo``) and below
(``hi``) that its neighbours hold, zeros at the global edges (where SAME
padding puts zeros), and its adjoint sends the cotangent of those rows back
to their owners, who add it to their own.

Both directions go between neighbours only: adjacent ranks of the model
axis share a process group of their own (:func:`neighbour_groups`), and
each exchange is an ``all_gather`` over the one or two such pairs a rank
belongs to, the even pairs ``(2j, 2j + 1)`` first and then the odd ones,
so that both ranks of a pair meet in the same round on every backend.
Within a pair each rank sends the rows the other reads (this slab's first
``hi`` rows up and last ``lo`` rows down; the cotangents of its ``lo`` and
``hi`` halo rows in the backward), the shorter padded to the longer, so a
rank's traffic does not grow with the model axis. The collective is a
library's (NCCL between cards, gloo on the CPU and where ranks share a
card): ``all_gather`` takes CUDA and CPU tensors on both, where gloo's
point-to-point ops fail on CUDA tensors (``halo_transport.py`` measures
both). A failing exchange raises and nothing replaces
it. Every rank issues the same exchanges in the same order; under
``torch.utils.checkpoint`` the recompute exchanges again, on every rank
alike.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["RowShard", "neighbour_groups", "exchange", "pad_rows", "exchanges", "sent_bytes",
           "received_bytes"]

# Exchanges since the last reset (forward and backward each count one) and
# the bytes this rank sent and received in them (each pair's all-gather
# carries one padded block each way).
exchanges = 0
sent_bytes = 0
received_bytes = 0


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's rows of tensors split evenly along ``axis`` over the
    ``size`` ranks of the model axis's process ``group``: the ``index``-th
    slab of ``n // size`` rows of an extent of ``n``. ``pairs``: the
    groups of model ranks ``(j, j + 1)`` (:func:`neighbour_groups`), which
    the halo exchange runs over. The port's counterpart of a
    ``NamedSharding`` with ``"model"`` on that axis (JAX shards axis 1
    only)."""

    index: int
    size: int
    group: Any = None
    axis: int = 1
    pairs: Tuple[Any, ...] = ()

    def rows(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's slab of an extent of ``n`` rows."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks of the model axis")
        h = n // self.size
        return self.index * h, (self.index + 1) * h

    def local_rows(self, x: torch.Tensor) -> Tuple[int, int]:
        """[start, stop) of the rows of ``x``, this rank's slab, in the
        whole tensor."""
        return self.rows(x.shape[self.axis] * self.size)

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole tensor ``x`` (a view)."""
        r0, r1 = self.rows(x.shape[self.axis])
        return x.narrow(self.axis, r0, r1 - r0)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's rows ``x`` (an all-gather over
        the model group, concatenated along the axis in rank order); not
        differentiated."""
        if self.size == 1:
            return x
        parts = _all_gather(x.detach().contiguous(), self)
        return torch.cat(parts, dim=self.axis)


def neighbour_groups(ranks: Sequence[int]) -> Tuple[Any, ...]:
    """The process groups of ``(ranks[j], ranks[j + 1])``, one model axis's
    adjacent pairs, for :class:`RowShard`'s ``pairs``. Every rank of the
    world calls it for every model axis, in the same order (it creates
    groups)."""
    ranks = list(ranks)
    return tuple(dist.new_group(ranks[j:j + 2]) for j in range(len(ranks) - 1))


def _all_gather(x: torch.Tensor, shard: RowShard) -> List[torch.Tensor]:
    parts = [torch.empty_like(x) for _ in range(shard.size)]
    dist.all_gather(parts, x, group=shard.group)
    return parts


def _zeros(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = n
    return x.new_zeros(shape)


def pad_rows(x: torch.Tensor, lo: int, hi: int, axis: int) -> torch.Tensor:
    """``x`` with ``lo`` rows of zeros before and ``hi`` after, along ``axis``."""
    if lo == 0 and hi == 0:
        return x
    return torch.cat([_zeros(x, lo, axis), x, _zeros(x, hi, axis)], dim=axis)


def _swap(up: torch.Tensor, down: torch.Tensor, shard: RowShard, axis: int):
    """Sends ``up`` to the rank above and ``down`` to the rank below; returns
    (the rows the rank above sent down, the rows the rank below sent up),
    None at an edge. Each pair's all-gather carries both ranks' rows padded
    to the longer; the even pairs go first. Counts the exchange."""
    global exchanges, sent_bytes, received_bytes
    if len(shard.pairs) != shard.size - 1:
        raise ValueError(f"a model axis of {shard.size} ranks with {len(shard.pairs)} neighbour "
                         "groups: build the shard with neighbour_groups (make_mesh does)")
    n = max(up.shape[axis], down.shape[axis])
    above = below = None
    for j in sorted((shard.index - 1, shard.index), key=lambda j: j % 2):
        if not 0 <= j < shard.size - 1:
            continue
        with_above = j == shard.index - 1  # this rank is the pair's second
        mine = up if with_above else down
        send = pad_rows(mine, 0, n - mine.shape[axis], axis).contiguous()
        parts = [torch.empty_like(send) for _ in range(2)]
        dist.all_gather(parts, send, group=shard.pairs[j])
        sent_bytes += send.numel() * send.element_size()
        received_bytes += send.numel() * send.element_size()
        if with_above:
            above = parts[0].narrow(axis, 0, down.shape[axis])
        else:
            below = parts[1].narrow(axis, 0, up.shape[axis])
    exchanges += 1
    return above, below


def _add_halo_cotangents(gx: torch.Tensor, from_above, from_below, lo: int, hi: int,
                         axis: int) -> torch.Tensor:
    """The adjoint's add: the rank above's cotangent of its ``hi`` halo rows
    onto this slab's first ``hi`` rows, the rank below's of its ``lo`` halo
    rows onto the last ``lo``."""
    h = gx.shape[axis]
    if from_above is not None and hi:
        gx.narrow(axis, 0, hi).add_(from_above)
    if from_below is not None and lo:
        gx.narrow(axis, h - lo, lo).add_(from_below)
    return gx


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lo, hi, shard, axis):
        ctx.lo, ctx.hi, ctx.shard, ctx.axis = lo, hi, shard, axis
        h = x.shape[axis]
        # the rank above reads this slab's first hi rows, the rank below its last lo
        above, below = _swap(x.narrow(axis, 0, hi), x.narrow(axis, h - lo, lo), shard, axis)
        top = above if above is not None else _zeros(x, lo, axis)
        bottom = below if below is not None else _zeros(x, hi, axis)
        return torch.cat([top, x, bottom], dim=axis)

    @staticmethod
    def backward(ctx, g):
        lo, hi, shard, axis = ctx.lo, ctx.hi, ctx.shard, ctx.axis
        h = g.shape[axis] - lo - hi
        above, below = _swap(g.narrow(axis, 0, lo), g.narrow(axis, lo + h, hi), shard, axis)
        gx = g.narrow(axis, lo, h).clone(memory_format=torch.contiguous_format)
        gx = _add_halo_cotangents(gx, above, below, lo, hi, axis)
        return gx, None, None, None, None


def exchange(x: torch.Tensor, lo: int, hi: int, shard: RowShard, axis: int) -> torch.Tensor:
    """This rank's slab ``x`` (``h`` rows along ``axis``) extended to ``lo +
    h + hi`` rows: the last ``lo`` rows of the rank above, ``x``, the first
    ``hi`` rows of the rank below; zeros past the first and last ranks.
    Differentiable: the backward sends the cotangent of the halo rows to the
    ranks that own them, which add it to their own. Halos reach one
    neighbour only: ``lo`` or ``hi`` above ``h`` raises ``ValueError``."""
    h = x.shape[axis]
    if lo < 0 or hi < 0 or lo > h or hi > h:
        raise ValueError(f"a halo of ({lo}, {hi}) rows around a slab of {h}: halos reach "
                         "one neighbour only")
    if lo == 0 and hi == 0:
        return x
    if shard.size == 1:
        return pad_rows(x, lo, hi, axis)
    return _Exchange.apply(x, lo, hi, shard, axis)
