"""Epoch-level training loop: the port's copy of the JAX package's
``train/loop.py``. One train pass and one test pass an epoch, each step's
scalars accumulated and their epoch means written to the ``Summary``
under the JAX package's keys at ``step=epoch``.

Deferred fetch: each dispatch's metric tensors stay on the device, and
are copied to the host only when more than ``MAX_IN_FLIGHT`` pinned
batches are outstanding (the oldest dispatch, once) and once at the end
of the pass, so the host never waits on the card within a pass (no
``.item()``, no ``synchronize`` a step). Backpressure counts pinned
batches, not dispatches: a dispatch of K steps pins K batches, an
accumulated step A microbatches.

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

The reference's console print swaps two labels; ``print_epoch_summary``
prints each value under its own label.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator

import numpy as np
import torch

from cyclegan_tpu_torch.config import Config
from cyclegan_tpu_torch.data.pipeline import CycleGANData
from cyclegan_tpu_torch.data.prefetch import prefetch_iter
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


class _DeferredMetrics:
    """Each dispatch's metric tensors (scalars, or [K] for K steps),
    fetched to the host in order: the oldest dispatch once more than
    MAX_IN_FLIGHT pinned batches are pending, the rest at ``drain``. Each
    fetched row, one a step, goes to ``health`` (a HealthMonitor) where
    there is one."""

    def __init__(self, health=None):
        self.pending: list = []  # (keys, [rows, keys] values, pinned, kept)
        self.fetched: list = []
        self.health = health

    def _fetched(self, keys, rows) -> None:
        for row in rows:
            row = dict(zip(keys, row))
            self.fetched.append(row)
            if self.health is not None:
                self.health.observe(row)

    def append(self, metrics: Dict[str, torch.Tensor], pinned: int = 1,
               keep=()) -> None:
        keys = tuple(metrics)
        values = torch.stack([metrics[k].reshape(-1) for k in keys], dim=1)
        self.pending.append((keys, values, pinned, keep))
        while sum(p for _, _, p, _ in self.pending) > max(MAX_IN_FLIGHT,
                                                          pinned):
            keys, values, _, _ = self.pending.pop(0)
            self._fetched(keys, values.cpu().numpy())

    def drain(self) -> Dict[str, list]:
        if self.pending:
            tail = torch.cat([v for _, v, _, _ in self.pending]).cpu().numpy()
            at = 0
            for keys, values, _, _ in self.pending:
                self._fetched(keys, tail[at:at + len(values)])
                at += len(values)
        self.pending = []
        results: Dict[str, list] = {}
        for row in self.fetched:
            append_dict(results, row)
        return results


def train_epoch(config: Config, data: CycleGANData, step_fn: Callable,
                state: CycleGANState, summary, epoch: int,
                health=None, multi_step_fn: Callable = None, tracer=None,
                breaker=None, start_step: int = 0) -> CycleGANState:
    """One training pass over ``data``'s epoch ``epoch`` from its batch
    ``start_step``; the epoch means go to ``summary`` (training).
    ``health``, a HealthMonitor, sees each fetched row and may raise
    ``HealthFault``. ``multi_step_fn`` (``make_multi_train_step``) runs K
    batches a dispatch where ``steps_per_dispatch`` K > 1; ``tracer`` (a
    ``TraceCapture``) is stepped once a dispatch; ``breaker`` (a
    ``MidEpochBreaker``) is told each dispatch's batches and may end the
    pass early. Returns the updated state."""
    k = config.train.steps_per_dispatch
    multi = multi_step_fn is not None and k > 1
    depth = config.train.prefetch_batches
    batches = _staged(grouped(data.train_epoch(epoch, prefetch=depth == 0,
                                               start_step=start_step),
                              k if multi else 1), config, state)
    if health is not None:
        health.begin_epoch(epoch)
    metrics = _DeferredMetrics(health)
    remaining = max(0, data.train_steps - start_step)
    n_dispatch = remaining // k + remaining % k if multi else remaining
    it = iter(_progress(batches, n_dispatch, "Train", config.train.verbose))
    while True:
        # One trace unit a dispatch. Inline staging (depth 0) runs inside
        # next(it), so the tracer steps first to keep it in the window.
        if tracer is not None and depth == 0:
            tracer.step()
        try:
            batch = next(it)
        except StopIteration:
            break
        if tracer is not None and depth > 0:
            tracer.step()
        if batch.kind == "multi":
            state, step_metrics = multi_step_fn(state, *_use(batch))
            n_batches, pinned = k, k
        else:
            state, step_metrics = step_fn(state, *_use(batch))
            n_batches, pinned = 1, config.train.grad_accum
        metrics.append(step_metrics, pinned=pinned, keep=batch)
        if breaker is not None:
            # A host-local flag read: a SIGTERM during this dispatch ends
            # the pass here, the rest of the epoch untouched for a resume.
            breaker.note(n_batches)
            if breaker.should_break():
                break
    for key, value in mean_dict(metrics.drain()).items():
        summary.scalar(key, value, step=epoch, training=True)
    return state


def test_epoch(config: Config, data: CycleGANData, step_fn: Callable,
               state: CycleGANState, summary, epoch: int) -> Dict[str, float]:
    """One test pass; its means go to ``summary`` (test) and are
    returned."""
    host_prefetch = config.train.prefetch_batches == 0
    batches = _staged(grouped(data.test_epoch(prefetch=host_prefetch), 1),
                      config, state)
    metrics = _DeferredMetrics()
    for batch in _progress(batches, data.test_steps, "Test",
                           config.train.verbose):
        metrics.append(step_fn(state, *_use(batch)), keep=batch)
    means = mean_dict(metrics.drain())
    for key, value in means.items():
        summary.scalar(key, value, step=epoch, training=False)
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

