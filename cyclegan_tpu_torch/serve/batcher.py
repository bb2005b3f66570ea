"""Dynamic micro-batcher: queue requests, flush on max-batch or max-wait
(the port's own copy of the JAX package's serve/batcher.py; pure host
code).

A flush fires the moment ``max_batch`` requests are waiting (full
buckets under load) or when the OLDEST queued request has waited
``max_wait_s`` (bounded latency when traffic is sparse). Ragged flushes
are the engine's problem: it zero-pads to the bucket.

Exceptions raised by the flush function fail THAT flush's futures and
the worker keeps serving. A worker-thread crash outside the flush call
parks the batcher in a failed state that every later submit re-raises,
so errors surface at the caller instead of hanging futures forever.
The batcher tracks its queue's high-water mark; submit stays
O(enqueue).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, List, Optional


class Request:
    """One queued inference request: the preprocessed image, its size
    bucket, the future the caller holds, and the enqueue timestamp the
    latency accounting starts from. ``tier`` tags the engine tier the
    flush must run on ("base"/None, "int8" or "int8_fused"): flushes are
    homogeneous in (size, tier). ``trace`` optionally carries a trace
    context (any object with ``span_done`` and ``finish``); the executor
    records per-hop spans on it from timestamps it already takes."""

    __slots__ = ("image", "size", "future", "t_submit", "meta", "tier",
                 "trace")

    def __init__(self, image, size: int, meta=None, tier=None,
                 trace=None):
        self.image = image
        self.size = size
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        self.meta = meta
        self.tier = tier
        self.trace = trace


_STOP = object()


class MicroBatcher:
    """Single consumer thread draining a bounded queue into flushes.

    ``flush_fn(requests, trigger)`` runs on the worker thread with 1 <=
    len(requests) <= max_batch, all sharing one size bucket; trigger is
    "full" | "deadline" | "drain" (close-time flush of the residue).
    """

    def __init__(self, flush_fn: Callable[[List[Request], str], None],
                 max_batch: int, max_wait_s: float,
                 max_queue: int = 1024, name: str = "serve-batcher"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_s < 0:
            raise ValueError(f"max_wait_s must be >= 0, got {max_wait_s}")
        self._flush_fn = flush_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._q: "queue.Queue" = queue.Queue(maxsize=max_queue)
        self._error: Optional[BaseException] = None
        self._closed = False
        self.max_depth = 0  # queue high-water mark (obs watermark)
        self.n_flushes = 0
        self.n_requests = 0
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._worker.start()

    # -- producer side ----------------------------------------------------
    def submit(self, request: Request) -> Future:
        """Enqueue one request; blocks only when the bounded queue is
        full (admission backpressure, so an overloaded server holds
        connections instead of accumulating unbounded host memory)."""
        if self._error is not None:
            raise RuntimeError("batcher worker died") from self._error
        if self._closed:
            raise RuntimeError("batcher is closed")
        self._q.put(request)
        self.n_requests += 1
        depth = self._q.qsize()
        if depth > self.max_depth:
            self.max_depth = depth
        return request.future

    @property
    def depth(self) -> int:
        return self._q.qsize()

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting, flush the residue, join the worker."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_STOP)
        self._worker.join(timeout=timeout)

    # -- worker side ------------------------------------------------------
    def _collect(self) -> Optional[List[Request]]:
        """Block for the first request, then fill the flush until
        max_batch or the first request's max-wait deadline. Returns None
        on shutdown (after handing any residue to one last flush)."""
        first = self._q.get()
        if first is _STOP:
            return None
        batch = [first]
        deadline = first.t_submit + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is _STOP:
                self._do_flush(batch, "drain")
                return None
            if (item.size, item.tier) != (batch[0].size, batch[0].tier):
                # Size/tier-bucket boundary inside the window: flush
                # what we have, push the stranger back for the next
                # cycle (the executor routes per-(size, tier), so this
                # is a rare cross-bucket race, not the steady state).
                self._q.put(item)
                break
            batch.append(item)
        return batch

    def _do_flush(self, batch: List[Request], trigger: str) -> None:
        if trigger != "drain" and len(batch) >= self.max_batch:
            trigger = "full"
        self.n_flushes += 1
        try:
            self._flush_fn(batch, trigger)
        except BaseException as e:  # noqa: BLE001 — fail the flush, not the engine
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)

    def _run(self) -> None:
        try:
            while True:
                batch = self._collect()
                if batch is None:
                    return
                self._do_flush(batch, "deadline")
        except BaseException as e:  # worker bug: fail loudly at submit()
            self._error = e
            # Drain whatever is queued so no future hangs forever.
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    return
                if item is not _STOP and not item.future.done():
                    item.future.set_exception(e)
