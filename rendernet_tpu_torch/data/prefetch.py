"""Background chunk prefetching for the host input pipeline.

The port's own copy of ``rendernet_tpu/data/prefetch.py``: ``prefetch``
runs a chunk generator on a daemon thread with a bounded queue, so that
decoding the next chunk overlaps the card's steps (the training loops wrap
their loaders with it, ``TrainConfig.prefetch_chunks``). Safe with the
loaders because each ``yield`` hands off freshly allocated arrays.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

__all__ = ["prefetch"]

_DONE = object()


class _Prefetcher(Iterator[T]):
    def __init__(self, it: Iterable[T], depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._closed = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._produce, args=(iter(it),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item`` unless closed first; whether it was queued."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised in the consumer
            self._err = e
        self._put(_DONE)

    def __iter__(self) -> "_Prefetcher[T]":
        return self

    def __next__(self) -> T:
        if self._closed.is_set():
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._closed.set()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the producer; safe after an early ``break``."""
        self._closed.set()

    def __del__(self):  # best-effort cleanup on abandonment
        self._closed.set()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``it`` on a background thread, keeping up to ``depth`` items
    decoded ahead of the consumer; ``depth <= 0`` returns ``iter(it)``."""
    if depth <= 0:
        return iter(it)
    return _Prefetcher(it, depth)
