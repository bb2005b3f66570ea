"""Epoch-level training loop: the port's copy of the JAX package's
``train/loop.py``, single-step path. One train pass and one test pass an
epoch, each step's scalars accumulated and their epoch means written to
the ``Summary`` under the JAX package's keys at ``step=epoch``.

Deferred fetch: each step's metric tensors stay on the device, and are
copied to the host only when more than ``MAX_IN_FLIGHT`` steps are
outstanding (the oldest, once) and once at the end of the pass, so the
host never waits on the card within a pass (no ``.item()``, no
``synchronize`` a step).

Staging: each batch is copied into pinned host memory and from there to
the card with ``non_blocking=True`` on a side stream; the step's stream
waits on an event recorded after the copy. With ``prefetch_batches`` > 0
this runs on the prefetch worker (``data/prefetch.py``), so the next
batches' copies overlap the current step. A pinned buffer stays
referenced until its step's metrics are fetched, which is after its copy
has completed, so no buffer is reused while its copy is in flight.

Health: a ``HealthMonitor`` (obs/health.py) given to ``train_epoch``
sees each fetched row of the train pass, at the two fetch sites, and
begins each epoch; ``print_epoch_summary`` prints its rollup. The
``health/*`` scalars of the step are epoch means beside the losses.

With ``grad_accum`` A the data yields effective batches of A x
``batch_size`` and the step is ``make_accum_train_step``; the loop is the
same.

The reference's console print swaps two labels; ``print_epoch_summary``
prints each value under its own label.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator

import torch

from cyclegan_tpu_torch.config import Config
from cyclegan_tpu_torch.data.pipeline import CycleGANData
from cyclegan_tpu_torch.data.prefetch import prefetch_iter
from cyclegan_tpu_torch.train.state import CycleGANState
from cyclegan_tpu_torch.utils.dicts import append_dict, mean_dict

# Most steps dispatched but not yet fetched.
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
    """One batch on the device, with what must stay alive until its step
    has run (the pinned host copies) and the event its copy recorded."""

    __slots__ = ("x", "y", "w", "keep", "event")

    def __init__(self, x, y, w, keep=(), event=None):
        self.x, self.y, self.w, self.keep, self.event = x, y, w, keep, event


def stage_batches(batches, device: torch.device) -> Iterator[_Staged]:
    """(x, y, w) numpy batches -> batches on ``device``. On the card each
    goes through pinned memory and a non-blocking copy on a side stream of
    its own; on the CPU the arrays are wrapped as they are."""
    if device.type != "cuda":
        for x, y, w in batches:
            yield _Staged(*(torch.from_numpy(a) for a in (x, y, w)))
        return
    stream = torch.cuda.Stream(device)
    for x, y, w in batches:
        host = tuple(torch.from_numpy(a).pin_memory() for a in (x, y, w))
        with torch.cuda.stream(stream):
            dev = tuple(h.to(device, non_blocking=True) for h in host)
            event = torch.cuda.Event()
            event.record(stream)
        yield _Staged(*dev, keep=host, event=event)


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
    """Each step's metric tensors, fetched to the host in order: the oldest
    once more than MAX_IN_FLIGHT are pending, the rest at ``drain``. Each
    fetched row goes to ``health`` (a HealthMonitor) where there is one."""

    def __init__(self, health=None):
        self.pending: list = []  # (keys, stacked values, kept alive)
        self.fetched: list = []
        self.health = health

    def _fetched(self, row: dict) -> None:
        self.fetched.append(row)
        if self.health is not None:
            self.health.observe(row)

    def append(self, metrics: Dict[str, torch.Tensor], keep=()) -> None:
        keys = tuple(metrics)
        values = torch.stack([metrics[k].reshape(()) for k in keys])
        self.pending.append((keys, values, keep))
        if len(self.pending) > MAX_IN_FLIGHT:
            keys, values, _ = self.pending.pop(0)
            self._fetched(dict(zip(keys, values.cpu().numpy())))

    def drain(self) -> Dict[str, list]:
        if self.pending:
            tail = torch.stack([v for _, v, _ in self.pending]).cpu().numpy()
            for (keys, _, _), row in zip(self.pending, tail):
                self._fetched(dict(zip(keys, row)))
        self.pending = []
        results: Dict[str, list] = {}
        for row in self.fetched:
            append_dict(results, row)
        return results


def train_epoch(config: Config, data: CycleGANData, step_fn: Callable,
                state: CycleGANState, summary, epoch: int,
                health=None) -> CycleGANState:
    """One training pass over ``data``'s epoch ``epoch``; the epoch means
    go to ``summary`` (training). ``health``, a HealthMonitor, sees each
    fetched row and may raise ``HealthFault``. Returns the updated
    state."""
    host_prefetch = config.train.prefetch_batches == 0
    batches = _staged(data.train_epoch(epoch, prefetch=host_prefetch),
                      config, state)
    if health is not None:
        health.begin_epoch(epoch)
    metrics = _DeferredMetrics(health)
    for batch in _progress(batches, data.train_steps, "Train",
                           config.train.verbose):
        state, step_metrics = step_fn(state, *_use(batch))
        metrics.append(step_metrics, keep=batch)
    for key, value in mean_dict(metrics.drain()).items():
        summary.scalar(key, value, step=epoch, training=True)
    return state


def test_epoch(config: Config, data: CycleGANData, step_fn: Callable,
               state: CycleGANState, summary, epoch: int) -> Dict[str, float]:
    """One test pass; its means go to ``summary`` (test) and are
    returned."""
    host_prefetch = config.train.prefetch_batches == 0
    batches = _staged(data.test_epoch(prefetch=host_prefetch), config, state)
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

