"""Named spans around the port's layers, recorded only when asked for.

``span(name)`` marks where a layer's work is issued on the host: the
training step, a render, the warps, the encoder's stacks, the projection,
the heads, the loss, the backward, the optimizer's update and the casts of
parameters at their use (``weights``). Off (the default) it returns one
shared object whose ``with`` does nothing: no clock is read and nothing is
allocated. Inside ``with recording() as rec:`` each span appends one
:class:`SpanRecord` to ``rec.spans``; a span opened while ``torch.profiler``
is active also opens a ``record_function`` range named ``rn.<name>``, so
the profiler's trace names the layers.

Times are ``time.time_ns()`` (the realtime clock), the clock of the
profiler's Chrome trace: an event's ``ts`` there is ``(ns -
baseTimeNanoseconds) / 1000`` microseconds.

A span named ``train_step`` or ``render`` opened on a thread with no open
span is a root: it starts a new unit, and every span recorded until the
next root (on any thread) carries that unit's id, so the spans of one step
or request share an identifier. Each thread keeps its own stack of open
spans; a span's ``parent`` is the index of the innermost span open on its
own thread when it opened (autograd's device thread opens spans only where
a backward recomputes a forward).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, List, NamedTuple, Optional

import torch

__all__ = ["ROOTS", "SpanRecord", "Recording", "span", "recording"]

ROOTS = ("train_step", "render")


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[int]  # index in ``Recording.spans`` of the enclosing span
    unit: int  # the root's unit id (0 before the first root)
    tid: int  # the native id of the thread that opened it
    start_ns: int  # time.time_ns()
    end_ns: int


class Recording:
    """What :func:`recording` yields: ``spans``, the closed spans in the
    order they opened, complete once the ``with`` block has closed."""

    def __init__(self):
        self.spans: List[SpanRecord] = []
        self.units = 0
        self._open: List[list] = []  # each span's fields, in the order they opened
        self._local = threading.local()

    def _thread(self):
        """This thread's stack of open spans' fields, and its native id."""
        loc = self._local
        try:
            return loc.stack, loc.tid
        except AttributeError:
            loc.stack, loc.tid = [], threading.get_native_id()
            return loc.stack, loc.tid

    def _close(self) -> None:
        closed = [f for f in self._open if f[5] is not None]
        index = {id(f): i for i, f in enumerate(closed)}
        self.spans = [SpanRecord(f[0], None if f[1] is None else index.get(id(f[1])), *f[2:])
                      for f in closed]


class _Off:
    """The shared no-op. Its ``__enter__`` and ``__exit__`` are C callables
    (``NoneType()`` and ``"".format``, which ignores its arguments and
    returns a false ``""``), so a disabled ``with span(...)`` runs no Python
    frame beyond :func:`span`'s own."""

    __slots__ = ()
    __enter__ = type(None)
    __exit__ = "".format


_OFF = _Off()
_rec: Optional[Recording] = None


class _Span:
    __slots__ = ("rec", "name", "fields", "stack", "rf")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec, name = self.rec, self.name
        stack, tid = rec._thread()
        self.rf = (torch.profiler.record_function("rn." + name)
                   if torch.autograd._profiler_enabled() else None)
        if not stack and name in ROOTS:
            rec.units += 1
        # name, the enclosing span's fields, unit, thread, start, end
        f = self.fields = [name, stack[-1] if stack else None, rec.units, tid, 0, None]
        rec._open.append(f)
        stack.append(f)
        self.stack = stack
        f[4] = time.time_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.fields[5] = time.time_ns()
        self.stack.pop()
        return False


def span(name: str):
    """A context manager around one layer's work (see the module's
    docstring); the shared no-op unless a recording is open."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Span(rec, name)


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record every span opened inside the block; the yielded
    :class:`Recording` holds them once the block closes."""
    global _rec
    if _rec is not None:
        raise RuntimeError("a span recording is already open")
    rec = _rec = Recording()
    try:
        yield rec
    finally:
        _rec = None
        rec._close()
