"""Pipelined serving executor: decode || H2D + compute || D2H || encode
(the JAX package's serve/executor.py).

The stages run on separate threads, with the JAX executor's two
disciplines:

- **No per-item sync.** A batcher thread dispatches a flush
  (``engine.run`` only enqueues work on the card), records a CUDA event on
  its current stream and moves on. A completer thread waits on that event
  and then makes the one device-to-host fetch of the flush. PyTorch's
  current stream is per thread, so the event, not the completer's own
  stream, is what orders the fetch after the flush; nothing on the
  dispatch side synchronises. The event completing proves the flush
  finished, so the per-flush device latency comes with the fetch.
- **Bounded in-flight.** At most ``max_in_flight`` dispatched but
  unfetched flushes exist: the dispatcher blocks past the window, so the
  buffers of pending flushes stay a bounded slice of device memory.

Callers (server handler threads) run decode via ``submit_raw`` and encode
on the resolved future, so decode and encode overlap compute without a
thread pool of their own. ``logger`` (an object with ``event(kind,
**fields)``) receives a ``serve_flush`` event per flush and a
``serve_summary`` at close, with the JAX executor's fields; ``trace`` on
a request (an object with ``span_done`` and ``finish``) receives its
per-hop spans. Both are optional.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from cyclegan_tpu_torch.serve.batcher import MicroBatcher, Request
from cyclegan_tpu_torch.serve.engine import InferenceEngine, preprocess_request

# Default bounded-in-flight window, in flushes (each pins one bucket of
# input images and one of outputs on the device).
MAX_IN_FLIGHT = 4

_STOP = object()


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return float("nan")
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def _fetch(outs, done: Optional["torch.cuda.Event"]) -> List[np.ndarray]:
    """The flush's outputs on the host, after ``done`` (the event the
    dispatch side recorded behind them; None on the CPU)."""
    if done is not None:
        done.synchronize()
    return [o.cpu().numpy() for o in outs]


class PipelinedExecutor:
    """Ties batcher -> engine -> completer into one serving pipeline."""

    def __init__(self, engine: InferenceEngine, *,
                 max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0,
                 max_in_flight: int = MAX_IN_FLIGHT,
                 max_queue: int = 1024,
                 logger=None):
        self.engine = engine
        self._logger = logger
        max_batch = engine.max_batch if max_batch is None else max_batch
        if engine.batch_bucket(max_batch) is None:
            raise ValueError(
                f"max_batch={max_batch} exceeds the engine's largest "
                f"batch bucket {engine.max_batch}")
        # One batcher per (size, tier), made at first use: each flush runs
        # one bucket of one tier.
        self._batchers: Dict[tuple, MicroBatcher] = {}
        self._batcher_lock = threading.Lock()
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1000.0
        self._max_queue = max_queue
        self._inflight = threading.BoundedSemaphore(max_in_flight)
        self._pending: "queue.Queue" = queue.Queue()
        self._completer = threading.Thread(
            target=self._complete_loop, daemon=True, name="serve-completer")
        self._completer.start()
        self._closed = False
        # Rollup state (completer-thread writes, close() reads after join)
        self._latencies: List[float] = []
        self._n_done = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    # -- submission (decode stage runs on the caller's thread) ------------
    def submit_raw(self, img: np.ndarray, tier: Optional[str] = None,
                   trace=None) -> Future:
        """Decode-side entry: uint8/float HWC image of any size ->
        preprocess into its resolution bucket, then queue."""
        size = self.engine.size_bucket(img.shape[0], img.shape[1])
        return self.submit(preprocess_request(img, size), tier=tier,
                           trace=trace)

    def submit(self, image: np.ndarray, tier: Optional[str] = None,
               trace=None) -> Future:
        """Queue one preprocessed float32 [s, s, 3] image (s must be a
        resolution bucket). Returns a Future resolving to {"fake": ...}
        (+ "cycled" when the engine runs the cycle pass). ``tier`` routes
        to an engine tier."""
        if self._closed:
            raise RuntimeError("executor is closed")
        size = int(image.shape[0])
        tier = self.engine.resolve_tier(tier)
        req = Request(image, size, tier=tier, trace=trace)
        if trace is not None:
            # Ingress hop: mint -> enqueue (decode/preprocess/routing).
            trace.span_done("admit", None, req.t_submit)
        return self._batcher_for(size, tier).submit(req)

    def _batcher_for(self, size: int, tier: str = "base") -> MicroBatcher:
        with self._batcher_lock:
            b = self._batchers.get((size, tier))
            if b is None:
                if size not in self.engine.sizes:
                    raise ValueError(
                        f"size {size} is not a resolution bucket "
                        f"{self.engine.sizes}")
                b = MicroBatcher(
                    self._flush, self._max_batch, self._max_wait_s,
                    max_queue=self._max_queue,
                    name=f"serve-batcher-{size}-{tier}")
                self._batchers[(size, tier)] = b
            return b

    # -- dispatch stage (batcher worker thread) ---------------------------
    def _flush(self, batch: List[Request], trigger: str) -> None:
        # Backpressure before staging: past the in-flight window the
        # dispatcher blocks here.
        self._inflight.acquire()
        try:
            t0 = time.perf_counter()
            x = np.stack([r.image for r in batch])
            t_stacked = time.perf_counter()
            outs, n = self.engine.run(x, size=batch[0].size,
                                      tier=batch[0].tier)
            done = None
            if outs[0].is_cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(outs[0].device))
            t_dispatched = time.perf_counter()
        except BaseException:
            self._inflight.release()
            raise
        self._pending.put(
            (batch, outs, done, n, trigger, t0, t_stacked, t_dispatched))

    # -- completion stage (D2H + future resolution) -----------------------
    def _complete_loop(self) -> None:
        while True:
            item = self._pending.get()
            if item is _STOP:
                return
            batch, outs, done, n, trigger, t0, t_stacked, t_dispatched = item
            try:
                t_fetch = time.perf_counter()
                host = _fetch(outs, done)  # the one D2H fetch of the flush
                t_done = time.perf_counter()
            except BaseException as e:  # fetch failed: fail this flush only
                self._inflight.release()
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)
                    if r.trace is not None:
                        r.trace.finish("error")
                continue
            del outs, done
            self._inflight.release()
            fake = host[0]
            cycled = host[1] if len(host) > 1 else None
            now = t_done
            for i, r in enumerate(batch):
                result = {"fake": fake[i]}
                if cycled is not None:
                    result["cycled"] = cycled[i]
                if not r.future.done():
                    r.future.set_result(result)
            t_resolved = time.perf_counter()
            for r in batch:
                if r.trace is None:
                    continue
                # Host-side spans from timestamps the pipeline took anyway;
                # the "device" hop is t_dispatched -> t_done, proven by the
                # fetch completing.
                ctx = r.trace
                ctx.span_done("queue", r.t_submit, t0)
                ctx.span_done("stack", t0, t_stacked)
                ctx.span_done("submit", t_stacked, t_dispatched,
                              n=n, trigger=trigger,
                              tier=r.tier or "base")
                ctx.span_done("device", t_dispatched, t_done,
                              fetch_block_s=round(t_done - t_fetch, 6))
                ctx.span_done("resolve", t_done, t_resolved)
                ctx.finish("ok", t_end=t_resolved)
            # Rollup and per-flush event. Latency starts at submit time,
            # so queue wait, batching wait, device and fetch all count.
            lats = [now - r.t_submit for r in batch]
            self._latencies.extend(lats)
            self._n_done += n
            if self._t_first is None:
                self._t_first = t0
            self._t_last = now
            if self._logger is not None:
                bkey = (batch[0].size, batch[0].tier or "base")
                depth = self._batchers[bkey].depth \
                    if bkey in self._batchers else 0
                self._logger.event(
                    "serve_flush",
                    n=n, bucket=self.engine.batch_bucket(n),
                    size=batch[0].size, trigger=trigger,
                    tier=batch[0].tier or "base",
                    queue_depth=depth,
                    queue_wait_s=round(t0 - batch[0].t_submit, 6),
                    dispatch_s=round(t_dispatched - t0, 6),
                    fetch_block_s=round(t_done - t_fetch, 6),
                    e2e_p50_s=round(_percentile(sorted(lats), 0.5), 6),
                )

    # -- public snapshot ---------------------------------------------------
    def stats(self) -> dict:
        """Live snapshot for front-ends (/stats): per-bucket queue depths,
        the queue high-water mark, flush and request counters and the
        tiers served. Host-side reads only, safe from any thread."""
        with self._batcher_lock:
            batchers = dict(self._batchers)
        depths = {f"{size}/{tier}": b.depth
                  for (size, tier), b in sorted(batchers.items())}
        return {
            "queue_depths": depths,
            "max_queue_depth": max(
                (b.max_depth for b in batchers.values()), default=0),
            "n_flushes": sum(b.n_flushes for b in batchers.values()),
            "n_queued_requests": sum(
                b.n_requests for b in batchers.values()),
            "n_images_done": self._n_done,
            "tiers": list(self.engine.tiers),
        }

    # -- shutdown ---------------------------------------------------------
    def close(self) -> dict:
        """Drain every stage, stop the threads, emit (and return) the
        ``serve_summary`` rollup."""
        if self._closed:
            return {}
        self._closed = True
        for b in self._batchers.values():
            b.close()
        self._pending.put(_STOP)
        self._completer.join(timeout=60.0)
        wall = ((self._t_last - self._t_first)
                if self._t_first is not None and self._t_last is not None
                else 0.0)
        lats = sorted(self._latencies)

        def pct(q: float):
            # None (JSON null), not NaN, for an empty run.
            return round(_percentile(lats, q), 6) if lats else None

        summary = {
            "n_images": self._n_done,
            "n_flushes": sum(b.n_flushes for b in self._batchers.values()),
            "wall_s": round(wall, 6),
            "images_per_sec": round(self._n_done / wall, 4) if wall > 0
            else 0.0,
            "latency_p50_s": pct(0.50),
            "latency_p95_s": pct(0.95),
            "latency_p99_s": pct(0.99),
            "max_queue_depth": max(
                (b.max_depth for b in self._batchers.values()), default=0),
        }
        if self._logger is not None:
            self._logger.event("serve_summary", **summary)
        return summary
