"""Epoch-level training loop: the port's copy of the JAX package's
``train/loop.py``. One train pass and one test pass an epoch, each step's
scalars accumulated and their epoch means written to the ``Summary``
under the JAX package's keys at ``step=epoch``.

Deferred fetch: right after each dispatch its metric tensors are copied
into a pinned host buffer with ``non_blocking=True`` on the step's
stream, and a CUDA event is recorded behind the copy. The host reads a
buffer only after waiting on its own event: the oldest dispatch's when
more than ``MAX_IN_FLIGHT`` pinned batches are outstanding, and every
remaining one at the end of the pass. The wait returns once that
dispatch (and its copy) has run, while the dispatches enqueued after it
may still be running, as the JAX loop's ``jax.device_get`` of the oldest
entry waits for that entry alone; a ``.cpu()`` would wait for the whole
stream. So the host never waits on the card within a pass except at the
backpressure fetch (no ``.item()``, no ``synchronize`` a step).
Backpressure counts pinned batches, not dispatches: a dispatch of K steps
pins K batches, an accumulated step A microbatches.

Staging: each batch (or group of K batches, stacked) is copied into
pinned host memory and from there to the card with ``non_blocking=True``
on a side stream; the step's stream waits on an event recorded after the
copy. With ``prefetch_batches`` > 0 this runs on the prefetch worker
(``data/prefetch.py``), so the next batches' copies overlap the current
step. A pinned buffer stays referenced until its dispatch's metrics are
fetched, which is after its copy has completed, so no buffer is reused
while its copy is in flight.

Steps a dispatch: with ``steps_per_dispatch`` K > 1 and a multi step
(``train/multistep.py``), K full batches at a time run as one dispatch
(one CUDA graph replay on the card); the epoch's remainder runs through
the single step, so the update sequence is the K = 1 one. The tracer
(``utils/profiler.py``) and the preemption breaker (``resil/elastic.py``)
count dispatches; the breaker is told how many batches each consumed.
``start_step`` starts the pass at that batch of the epoch (a mid-epoch
resume).

Health: a ``HealthMonitor`` (obs/health.py) given to ``train_epoch``
sees each fetched row of the train pass in order, K rows for a dispatch
of K steps, at the two fetch sites, and begins each epoch;
``print_epoch_summary`` prints its rollup. The ``health/*`` scalars of
the step are epoch means beside the losses.

With ``grad_accum`` A the data yields effective batches of A x
``batch_size`` and the step is ``make_accum_train_step``; the loop is the
same.

Telemetry: with ``obs`` (an ``obs.Telemetry``) each pass runs a
``StepClock`` at the JAX loop's sites: ``stage_begin``/``staged`` around
the pull of the next staged batch, ``dispatched`` after the step returns
(kind "multi" for a dispatch of K steps, "accum" for an accumulated step,
else "single"), ``fetched`` with the wait and its completion time at
each backpressure fetch, ``drained`` at the end-of-pass fetch and
``finish``; the train pass also writes its ``step_losses`` event. The
clock reads ``perf_counter`` only: it adds no sync. Without ``obs`` the
null telemetry's clock does nothing.

The reference's console print swaps two labels; ``print_epoch_summary``
prints each value under its own label.
"""

from __future__ import annotations

from time import perf_counter
from typing import Callable, Dict, Iterator

import numpy as np
import torch

from cyclegan_tpu_torch.config import Config
from cyclegan_tpu_torch.data.pipeline import CycleGANData
from cyclegan_tpu_torch.data.prefetch import prefetch_iter
from cyclegan_tpu_torch.obs.telemetry import NULL_TELEMETRY
from cyclegan_tpu_torch.train.state import CycleGANState
from cyclegan_tpu_torch.utils.dicts import append_dict, mean_dict

# Most pinned batches dispatched but not yet fetched.
MAX_IN_FLIGHT = 32


def _progress(it, total: int, desc: str, verbose: int):
    if verbose == 0:
        return it
    try:
        from tqdm import tqdm
    except ImportError:
        return it
    return tqdm(it, desc=desc, total=total)


class _Staged:
    """One dispatch's batch (kind "single") or group of K stacked batches
    ("multi") on the device, with what must stay alive until it has run
    (the pinned host copies) and the event its copy recorded."""

    __slots__ = ("kind", "x", "y", "w", "keep", "event")

    def __init__(self, kind, x, y, w, keep=(), event=None):
        self.kind, self.x, self.y, self.w = kind, x, y, w
        self.keep, self.event = keep, event


def grouped(batches, k: int):
    """(x, y, w) batches -> (kind, x, y, w) dispatches: K at a time stacked
    on a new leading axis as "multi" where k > 1, and every batch of the
    remainder (fewer than K) as "single"."""
    buf = []
    for batch in batches:
        if k <= 1:
            yield ("single", *batch)
            continue
        buf.append(batch)
        if len(buf) == k:
            yield ("multi", *(np.stack(a) for a in zip(*buf)))
            buf = []
    for batch in buf:
        yield ("single", *batch)


def stage_batches(dispatches, device: torch.device) -> Iterator[_Staged]:
    """(kind, x, y, w) numpy dispatches -> on ``device``. On the card each
    goes through pinned memory and a non-blocking copy on a side stream of
    its own; on the CPU the arrays are wrapped as they are."""
    if device.type != "cuda":
        for kind, *arrays in dispatches:
            yield _Staged(kind, *(torch.from_numpy(a) for a in arrays))
        return
    stream = torch.cuda.Stream(device)
    for kind, *arrays in dispatches:
        host = tuple(torch.from_numpy(a).pin_memory() for a in arrays)
        with torch.cuda.stream(stream):
            dev = tuple(h.to(device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(stream)
        yield _Staged(kind, *dev, keep=host, event=event)


def _staged(it, config: Config, state: CycleGANState):
    depth = config.train.prefetch_batches
    staged = stage_batches(it, next(state.g.parameters()).device)
    return prefetch_iter(staged, depth) if depth > 0 else staged


def _use(batch: _Staged):
    """The batch's tensors, made safe for the current stream: it waits on
    the copy, and the allocator learns that the stream uses them."""
    if batch.event is not None:
        stream = torch.cuda.current_stream(batch.x.device)
        stream.wait_event(batch.event)
        for t in (batch.x, batch.y, batch.w):
            t.record_stream(stream)
    return batch.x, batch.y, batch.w


def _to_host(values: torch.Tensor):
    """(host tensor, event): on the card a pinned copy of ``values``
    enqueued on the current stream and the event recorded behind it; on
    the CPU ``values`` itself and no event."""
    if not values.is_cuda:
        return values, None
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(values.device))
    return host, event


class _Pending:
    """One dispatch's metrics on their way to the host: the keys, the
    [rows, keys] host buffer, the event behind its copy, its steps, its
    pinned batches, and what must stay alive until it has run."""

    __slots__ = ("keys", "host", "event", "steps", "pinned", "keep")

    def __init__(self, keys, host, event, steps, pinned, keep):
        self.keys, self.host, self.event = keys, host, event
        self.steps, self.pinned, self.keep = steps, pinned, keep


class _DeferredMetrics:
    """Each dispatch's metric tensors (scalars, or [K] for K steps),
    copied to the host behind an event at ``append`` and read in order:
    the oldest dispatch once more than MAX_IN_FLIGHT pinned batches are
    pending, the rest at ``drain``. Each fetched row, one a step, goes to
    ``health`` (a HealthMonitor) where there is one; each wait goes to
    ``clock`` (a StepClock)."""

    def __init__(self, health=None, clock=None):
        self.pending: list = []  # _Pending, oldest first
        self.fetched: list = []
        self.health = health
        self.clock = clock if clock is not None else NULL_TELEMETRY.step_clock(0)

    def _fetched(self, keys, rows) -> None:
        for row in rows:
            row = dict(zip(keys, row))
            self.fetched.append(row)
            if self.health is not None:
                self.health.observe(row)

    def append(self, metrics: Dict[str, torch.Tensor], steps: int = 1,
               pinned: int = 1, keep=()) -> None:
        keys = tuple(metrics)
        values = torch.stack([metrics[k].reshape(-1) for k in keys], dim=1)
        host, event = _to_host(values)
        self.pending.append(_Pending(keys, host, event, steps, pinned, keep))
        while sum(p.pinned for p in self.pending) > max(MAX_IN_FLIGHT,
                                                        pinned):
            self._fetch_oldest()

    def _fetch_oldest(self) -> None:
        """The backpressure fetch: wait for the oldest dispatch alone."""
        oldest = self.pending.pop(0)
        t_fetch = perf_counter()
        if oldest.event is not None:
            oldest.event.synchronize()  # sanctioned-fetch: bounded backpressure window
        t_ready = perf_counter()
        # The completion time proves that dispatch finished (its
        # submit->ready), from the same perf_counter read.
        self.clock.fetched(t_ready - t_fetch, steps=oldest.steps,
                           pinned=oldest.pinned, at=t_ready)
        self._fetched(oldest.keys, oldest.host.numpy())

    def drain(self) -> Dict[str, list]:
        """Wait for every pending dispatch, in order, and read them all;
        the epoch's rows, key -> list, in dispatch order."""
        t_drain = perf_counter()
        for p in self.pending:
            if p.event is not None:
                p.event.synchronize()  # sanctioned-fetch: end-of-pass drain
        t_ready = perf_counter()
        self.clock.drained(t_ready - t_drain, n_entries=len(self.pending),
                           at=t_ready)
        for p in self.pending:
            self._fetched(p.keys, p.host.numpy())
        self.pending = []
        results: Dict[str, list] = {}
        for row in self.fetched:
            append_dict(results, row)
        return results


def train_epoch(config: Config, data: CycleGANData, step_fn: Callable,
                state: CycleGANState, summary, epoch: int,
                health=None, multi_step_fn: Callable = None, tracer=None,
                breaker=None, start_step: int = 0, obs=None) -> CycleGANState:
    """One training pass over ``data``'s epoch ``epoch`` from its batch
    ``start_step``; the epoch means go to ``summary`` (training).
    ``health``, a HealthMonitor, sees each fetched row and may raise
    ``HealthFault``. ``multi_step_fn`` (``make_multi_train_step``) runs K
    batches a dispatch where ``steps_per_dispatch`` K > 1; ``tracer`` (a
    ``TraceCapture``) is stepped once a dispatch; ``breaker`` (a
    ``MidEpochBreaker``) is told each dispatch's batches and may end the
    pass early; ``obs`` (a ``Telemetry``) times the pass with a step clock
    and gets its ``step_losses``. Returns the updated state."""
    k = config.train.steps_per_dispatch
    accum = config.train.grad_accum
    multi = multi_step_fn is not None and k > 1
    depth = config.train.prefetch_batches
    clock = (obs or NULL_TELEMETRY).step_clock(epoch, split="train")
    batches = _staged(grouped(data.train_epoch(epoch, prefetch=depth == 0,
                                               start_step=start_step),
                              k if multi else 1), config, state)
    if health is not None:
        health.begin_epoch(epoch)
    metrics = _DeferredMetrics(health, clock)
    remaining = max(0, data.train_steps - start_step)
    n_dispatch = remaining // k + remaining % k if multi else remaining
    it = iter(_progress(batches, n_dispatch, "Train", config.train.verbose))
    while True:
        # One trace unit a dispatch. Inline staging (depth 0) runs inside
        # next(it), so the tracer steps first to keep it in the window.
        if tracer is not None and depth == 0:
            tracer.step()
        # The stage window: staging inline, or the prefetch queue's wait.
        clock.stage_begin()
        try:
            batch = next(it)
        except StopIteration:
            break
        clock.staged()
        if tracer is not None and depth > 0:
            tracer.step()
        if batch.kind == "multi":
            state, step_metrics = multi_step_fn(state, *_use(batch))
            clock.dispatched(steps=k, kind="multi")
            n_batches, steps, pinned = k, k, k
        else:
            state, step_metrics = step_fn(state, *_use(batch))
            clock.dispatched(steps=1, pinned=accum,
                             kind="accum" if accum > 1 else "single")
            n_batches, steps, pinned = 1, 1, accum
        metrics.append(step_metrics, steps=steps, pinned=pinned, keep=batch)
        if breaker is not None:
            # A host-local flag read: a SIGTERM during this dispatch ends
            # the pass here, the rest of the epoch untouched for a resume.
            breaker.note(n_batches)
            if breaker.should_break():
                break
    results = metrics.drain()
    for key, value in mean_dict(results).items():
        summary.scalar(key, value, step=epoch, training=True)
    if obs is not None and results:
        # The pass's loss series in dispatch order, from the rows the
        # loop fetched anyway.
        losses = {key: [float(v) for v in vals]
                  for key, vals in results.items() if key.startswith("loss_")}
        if losses:
            obs.event("step_losses", epoch=epoch, start_step=start_step,
                      n_steps=len(next(iter(losses.values()))), **losses)
    clock.finish()
    return state


def test_epoch(config: Config, data: CycleGANData, step_fn: Callable,
               state: CycleGANState, summary, epoch: int,
               obs=None) -> Dict[str, float]:
    """One test pass; its means go to ``summary`` (test) and are
    returned. ``obs`` times it with a step clock, as ``train_epoch``."""
    clock = (obs or NULL_TELEMETRY).step_clock(epoch, split="test")
    host_prefetch = config.train.prefetch_batches == 0
    batches = _staged(grouped(data.test_epoch(prefetch=host_prefetch), 1),
                      config, state)
    metrics = _DeferredMetrics(clock=clock)
    it = iter(_progress(batches, data.test_steps, "Test",
                        config.train.verbose))
    while True:
        clock.stage_begin()
        try:
            batch = next(it)
        except StopIteration:
            break
        clock.staged()
        step_metrics = step_fn(state, *_use(batch))
        clock.dispatched()
        metrics.append(step_metrics, keep=batch)
    means = mean_dict(metrics.drain())
    for key, value in means.items():
        summary.scalar(key, value, step=epoch, training=False)
    clock.finish()
    return means


def print_epoch_summary(results: Dict[str, float], elapse: float,
                        health: Dict[str, float] = None) -> None:
    """The four error metrics and the epoch's seconds; a missing key
    prints as nan. ``health`` is the flat rollup of
    ``HealthMonitor.epoch_rollup`` (gradient-norm and D-balance means);
    None prints no health line."""
    def get(key: str) -> float:
        return results.get(key, float("nan"))

    msg = (f'MAE(X, F(G(X))): {get("error/MAE(X, F(G(X)))"):.04f}\t\t'
           f'MAE(X, F(X)): {get("error/MAE(X, F(X))"):.04f}\n'
           f'MAE(Y, G(F(Y))): {get("error/MAE(Y, G(F(Y)))"):.04f}\t\t'
           f'MAE(Y, G(Y)): {get("error/MAE(Y, G(Y))"):.04f}\n')
    if health is not None:
        def h(key: str) -> float:
            return health.get(key, float("nan"))

        msg += (f'grad-norm G/F/dX/dY: {h("gnorm_G"):.03g}/{h("gnorm_F"):.03g}/'
                f'{h("gnorm_dX"):.03g}/{h("gnorm_dY"):.03g}\t'
                f'D(real)/D(fake) X: {h("dX_real_mean"):.02f}/'
                f'{h("dX_fake_mean"):.02f}  '
                f'Y: {h("dY_real_mean"):.02f}/{h("dY_fake_mean"):.02f}\n')
    print(msg + f'Elapse: {elapse:.02f}s\n')


def images_per_sec(n_images: int, elapse: float) -> float:
    return n_images / max(elapse, 1e-9)

