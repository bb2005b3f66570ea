"""Background-thread prefetch: the port's copy of the JAX package's
``data/prefetch.py``. The training loop runs its batch staging (stacking
into pinned host memory and the asynchronous copy to the card,
``train/loop.py``) on this worker, so the next batches' copies overlap the
current step; ``TrainConfig.prefetch_batches`` is the depth (0: inline).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def prefetch_iter(src: Iterable, depth: int) -> Iterator:
    """Iterate ``src`` on a daemon worker thread, up to ``depth + 1`` items
    ahead of the consumer (``depth`` queued, and the one the worker holds
    while the queue is full).

    An exception raised by ``src`` re-raises at the consumer's next pull,
    after the items already staged. Abandoning the iterator (closing it,
    or an exception in the consumer) stops the worker.
    """
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    return _prefetch_gen(src, depth)


def _prefetch_gen(src: Iterable, depth: int) -> Iterator:
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list = []

    def put(item) -> bool:
        """A bounded put that gives up once the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in src:
                if not put(item):
                    return
        except BaseException as e:  # handed to the consumer
            err.append(e)
        finally:
            put(_SENTINEL)

    thread = threading.Thread(target=worker, daemon=True,
                              name="cyclegan-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
