"""Span-level distributed tracing for TRAINING runs + straggler watch:
the port's copy of the JAX package's ``obs/train_trace.py``.

Serving has request-scoped traces (obs/trace.py) whose hop sums tile the
end-to-end wall by construction. Training had only aggregate
rollups: `epoch_steps` says an epoch spent 12 s staging, never WHICH
dispatches, in what order, around which checkpoint commit. This module
closes that gap by deriving a span graph per fused dispatch from the
StepClock's existing deferred timestamps — the clock calls back with
the absolute times it already took (iteration start, submit instant,
record close, deferred-fetch completion), and the tracer lays them out
as spans. Zero extra dispatches, zero syncs, zero additional clock
reads: the port's no-sync test scans this file with NO sanctioned
sites allowed, and tests pin that a traced run performs
exactly the dispatches an untraced run does.

Trace shape (one ``trace`` event per epoch, name ``train_epoch``):

- root span — opens at the first pass's StepClock construction and
  closes at the epoch rollup (`Telemetry.epoch`). Epoch-scale
  happenings (`service_job`, `ckpt_commit`, `rollback`,
  `reshard_to_plan`, `fault_injected`, ...) land on it as point
  events, so a whole chaos drill reads as one timeline.
- pass spans (``train_pass`` / ``test_pass``) — one per StepClock,
  carrying the `epoch_steps` aggregate as attrs. Between passes (and
  after the last one) an ``interlude`` span fills the gap, so the
  root's direct children tile the epoch wall EXACTLY (≤ rounding).
- dispatch spans — one per fused dispatch, [iteration start, record
  close), abutting each other by construction (a record closes at the
  next `stage_begin`'s timestamp, which is the next record's start),
  with the record's attribution fields as attrs. Together with the
  ``startup`` span and the trailing ``drain`` span (last record close
  to clock finish: the end-of-epoch deferred-fetch drain) they tile
  the pass span exactly.
- hop spans (head-sampled per dispatch at ``sample``) — the dispatch
  wall tiled as ``data_wait -> submit -> resolve -> host`` (sums to
  the wall exactly: host_work is DEFINED as the residue), plus a
  ``device`` overlay span [submit, proven-finished) marked
  ``overlap=True`` — it runs concurrently with later iterations, so
  it is excluded from tiling.

Span volume is bounded by ``max_spans`` per epoch; anything dropped is
counted LOUDLY in the root's ``spans_dropped`` / ``tiling_complete``
attrs — a capped trace never silently reads as a complete one.

The straggler observatory rides the same record stream: rolling
per-component medians (data_wait / device / host) over a window of
recent dispatches; when one dispatch's wall exceeds ``multiple`` x the
median wall, a ``train_straggler`` event fires with BLAME attributed
to the component with the largest excess over its own median — a
`data_stall` fault injected on the feed shows up as ``data_wait``
blame, a wedged device as ``device``, a GC pause as ``host``.
"""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Dict, Optional, Tuple

from cyclegan_tpu_torch.obs.trace import Span, TraceContext, Tracer

# Root-span point events absorbed from the telemetry stream: the
# epoch-scale happenings a timeline reader needs positioned between
# the pass spans. High-frequency kinds (step, step_losses, trace,
# epoch_steps...) stay off the root deliberately.
INSTANT_KINDS = frozenset({
    "service_job", "service_error",
    "ckpt_commit", "ckpt_restore", "ckpt_fallback", "ckpt_retry",
    "rollback", "health_fault", "reshard_to_plan", "elastic_preflight",
    "fault_injected", "preempted", "loop_stall", "stall",
    "collective_probe", "train_straggler", "memory",
})

# Per-instant attr budget: scalars only, at most this many, so a fat
# payload (a whole census) cannot bloat the root span.
_INSTANT_ATTR_CAP = 8

# Straggler rolling window (dispatch count) and arming threshold —
# same shape as the StepClock's loop_stall detector, kept separate so
# the two knobs tune independently.
STRAGGLER_WINDOW = 32
STRAGGLER_MIN_SAMPLES = 5


def _median(vals) -> float:
    s = sorted(vals)
    return s[len(s) // 2] if s else 0.0


class StragglerDetector:
    """Per-pass skew watch over the host's dispatch/feed stream.

    Blame attribution works on the three places a dispatch's wall can
    go: ``data_wait`` (the stage window — the feed made the host
    wait), ``device`` (the deferred-fetch block — device-bound time
    surfaces here at steady state), ``host`` (enqueue cost plus loop
    residue). Each keeps its own rolling median; a triggered dispatch
    blames whichever component exceeds its median by the most seconds.
    """

    def __init__(self, logger, multiple: float = 4.0,
                 window: int = STRAGGLER_WINDOW,
                 min_samples: int = STRAGGLER_MIN_SAMPLES):
        self._logger = logger
        self.multiple = float(multiple or 0.0)
        self._walls: deque = deque(maxlen=window)
        self._comps: Dict[str, deque] = {
            k: deque(maxlen=window) for k in ("data_wait", "device", "host")
        }
        self._min_samples = min_samples
        self.n_stragglers = 0
        self.blames: Dict[str, int] = {}

    @staticmethod
    def components(rec: dict) -> Dict[str, float]:
        return {
            "data_wait": float(rec.get("data_wait_s", 0.0)),
            "device": float(rec.get("fetch_block_s", 0.0)),
            "host": (float(rec.get("dispatch_s", 0.0))
                     + float(rec.get("host_work_s", 0.0))),
        }

    def observe(self, rec: dict, split: str, epoch: int) -> Optional[str]:
        """Feed one closed dispatch record; returns the blame when a
        straggler fired, else None. Pure host arithmetic."""
        if self.multiple <= 0:
            return None
        wall = float(rec.get("wall_s", 0.0))
        comps = self.components(rec)
        blame = None
        if len(self._walls) >= self._min_samples:
            med = _median(self._walls)
            if med > 0 and wall > self.multiple * med:
                excess = {
                    k: comps[k] - _median(self._comps[k]) for k in comps
                }
                blame = max(excess, key=lambda k: excess[k])
                self.n_stragglers += 1
                self.blames[blame] = self.blames.get(blame, 0) + 1
                if self._logger is not None:
                    self._logger.event(
                        "train_straggler",
                        split=split,
                        epoch=epoch,
                        dispatch=rec.get("dispatch"),
                        wall_s=round(wall, 6),
                        median_wall_s=round(med, 6),
                        multiple=self.multiple,
                        blame=blame,
                        excess_s=round(max(0.0, excess[blame]), 6),
                        components={k: round(v, 6)
                                    for k, v in comps.items()},
                        medians={k: round(_median(self._comps[k]), 6)
                                 for k in comps},
                    )
        self._walls.append(wall)
        for k, v in comps.items():
            self._comps[k].append(v)
        return blame


class TrainTracer:
    """StepClock observer that mints one trace per training epoch.

    Wired by Telemetry: `step_clock()` hands this object to every
    StepClock as its observer, `event()` forwards instant kinds, and
    `epoch()` closes the epoch trace. Single-threaded by construction
    (the dispatch loop owns the clock), so no locking beyond what the
    underlying TraceContext already does.
    """

    def __init__(self, logger, sample: float = 1.0,
                 max_spans: int = 4096,
                 straggler_multiple: float = 4.0,
                 rng=None):
        if not (0.0 <= sample <= 1.0):
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        # Epoch traces always emit (sample=1.0 at the mint); `sample`
        # governs per-dispatch HOP detail instead.
        self._tracer = Tracer(logger, sample=1.0, rng=rng)
        self._logger = logger
        self.sample = float(sample)
        self.max_spans = int(max_spans)
        self.straggler_multiple = float(straggler_multiple or 0.0)
        self._rng = rng if rng is not None else random.Random()
        self._ctx: Optional[TraceContext] = None
        self._epoch: Optional[int] = None
        self._split = ""
        self._pass_span: Optional[Span] = None
        self._pass_t0 = 0.0
        self._saw_record = False
        self._last_close: Optional[float] = None
        self._last_pass_end: Optional[float] = None
        self._hop_ids: Dict[int, int] = {}  # sampled dispatch -> span id
        self._early_ready: Dict[int, Tuple[float, float]] = {}
        self._dropped = 0
        self._n_stragglers = 0
        self._blames: Dict[str, int] = {}
        self._detector: Optional[StragglerDetector] = None

    # -- span budget ------------------------------------------------------
    def _add_span(self, name: str, t0: float, t1: float,
                  parent: int = 0, **attrs) -> Optional[Span]:
        ctx = self._ctx
        if ctx is None:
            return None
        if len(ctx.spans) >= self.max_spans:
            self._dropped += 1
            return None
        s = ctx.span(name, t_start=t0, parent=parent, **attrs)
        s.end(t_end=t1)
        return s

    # -- StepClock observer protocol --------------------------------------
    def pass_open(self, epoch: int, split: str, t_open: float) -> None:
        if self._ctx is not None and epoch != self._epoch:
            # A new epoch began without a rollup in between (tolerated:
            # close the stale trace at the new pass's open).
            self.close_epoch(self._epoch, t_end=t_open)
        if self._ctx is None and self.sample > 0:
            # sample == 0 leaves tracing off (straggler watch only).
            self._ctx = self._tracer.trace("train_epoch", t_start=t_open,
                                           epoch=epoch)
            self._epoch = epoch
            self._dropped = 0
            self._n_stragglers = 0
            self._blames = {}
            self._last_pass_end = None
        elif self._last_pass_end is not None:
            self._add_span("interlude", self._last_pass_end, t_open)
        self._split = split
        self._pass_t0 = t_open
        self._saw_record = False
        self._last_close = None
        self._hop_ids = {}
        self._early_ready = {}
        self._detector = StragglerDetector(
            self._logger, multiple=self.straggler_multiple)
        ctx = self._ctx
        if ctx is not None and len(ctx.spans) < self.max_spans:
            self._pass_span = ctx.span(f"{split}_pass", t_start=t_open,
                                       split=split)
        else:
            self._dropped += 1
            self._pass_span = None

    def record(self, rec: dict, t_iter: float, t_submit: Optional[float],
               t_close: float) -> None:
        det = self._detector
        if det is not None:
            det.observe(rec, self._split, rec.get("epoch", 0))
        if self._ctx is None:
            return
        self._last_close = t_close
        parent = self._pass_span.span_id if self._pass_span else 0
        if not self._saw_record:
            self._saw_record = True
            if t_iter > self._pass_t0:
                # Iterator construction + first-batch latency before the
                # loop's first stage window.
                self._add_span("startup", self._pass_t0, t_iter,
                               parent=parent)
        idx = int(rec.get("dispatch", 0))
        d = self._add_span(
            "dispatch", t_iter, t_close, parent=parent,
            dispatch=idx,
            steps=rec.get("steps"),
            kind=rec.get("kind"),
            data_wait_s=rec.get("data_wait_s"),
            dispatch_s=rec.get("dispatch_s"),
            fetch_block_s=rec.get("fetch_block_s"),
            host_work_s=rec.get("host_work_s"),
            wall_s=rec.get("wall_s"),
        )
        if d is None:
            self._early_ready.pop(idx, None)
            return
        if self.sample > 0 and self._rng.random() < self.sample:
            t_staged = t_iter + float(rec.get("stage_s", 0.0))
            if t_submit is None:
                t_submit = t_staged + float(rec.get("dispatch_s", 0.0))
            t_resolved = t_submit + float(rec.get("fetch_block_s", 0.0))
            pid = d.span_id
            self._add_span("data_wait", t_iter, t_staged, parent=pid)
            self._add_span("submit", t_staged, t_submit, parent=pid)
            self._add_span("resolve", t_submit, t_resolved, parent=pid)
            self._add_span("host", t_resolved, t_close, parent=pid)
            early = self._early_ready.pop(idx, None)
            if early is not None:
                self._add_span("device", early[0], early[1], parent=pid,
                               overlap=True)
            else:
                self._hop_ids[idx] = pid
        else:
            self._early_ready.pop(idx, None)

    def ready(self, idx: int, t_submit: float, t_ready: float) -> None:
        """Dispatch `idx` proven finished (its deferred fetch landed):
        the `device` overlay span, concurrent with later iterations."""
        if self._ctx is None:
            return
        pid = self._hop_ids.pop(idx, None)
        if pid is not None:
            self._add_span("device", t_submit, t_ready, parent=pid,
                           overlap=True)
        else:
            # Record not closed yet (the current dispatch's own fetch).
            self._early_ready[idx] = (t_submit, t_ready)

    def pass_close(self, agg: dict, t_end: float) -> None:
        det = self._detector
        if det is not None:
            self._n_stragglers += det.n_stragglers
            for k, v in det.blames.items():
                self._blames[k] = self._blames.get(k, 0) + v
        if self._pass_span is not None:
            if self._last_close is not None and t_end > self._last_close:
                # End-of-epoch deferred-fetch drain + finish residue:
                # without this span the pass's children would stop at
                # the last record close and the tiling bound would leak
                # the drain window.
                self._add_span("drain", self._last_close, t_end,
                               parent=self._pass_span.span_id,
                               drain_s=agg.get("drain_s"))
            self._pass_span.end(
                t_end=t_end,
                wall_s=agg.get("wall_s"),
                n_dispatches=agg.get("n_dispatches"),
                n_steps=agg.get("n_steps"),
                stage_s=agg.get("stage_s"),
                dispatch_s=agg.get("dispatch_s"),
                dispatch0_s=agg.get("dispatch0_s"),
                fetch_block_s=agg.get("fetch_block_s"),
                drain_s=agg.get("drain_s"),
                host_work_s=agg.get("host_work_s"),
                n_stragglers=det.n_stragglers if det else 0,
            )
            self._pass_span = None
        self._last_pass_end = t_end
        self._detector = None

    # -- Telemetry-side surface -------------------------------------------
    def note_event(self, kind: str, fields: dict) -> None:
        """Absorb an epoch-scale happening as a root point event."""
        ctx = self._ctx
        if ctx is None or kind not in INSTANT_KINDS:
            return
        attrs = {}
        for k, v in fields.items():
            if isinstance(v, (str, int, float, bool)) and len(attrs) < \
                    _INSTANT_ATTR_CAP:
                attrs[k] = v
        ctx.event(kind, **attrs)

    def close_epoch(self, epoch: Optional[int] = None,
                    t_end: Optional[float] = None) -> bool:
        """Finish the epoch trace (the Telemetry.epoch rollup moment).
        Returns True when a trace was actually closed."""
        ctx = self._ctx
        if ctx is None:
            return False
        if epoch is not None and self._epoch is not None \
                and epoch != self._epoch:
            return False
        now = time.perf_counter() if t_end is None else t_end
        if self._pass_span is not None:  # clock never finished: close it
            self._pass_span.end(t_end=now)
            self._pass_span = None
            self._last_pass_end = now
        if self._last_pass_end is not None and now > self._last_pass_end:
            self._add_span("interlude", self._last_pass_end, now)
        self._ctx = None
        ctx.finish(
            "ok", t_end=now,
            spans_dropped=self._dropped,
            tiling_complete=self._dropped == 0,
            n_stragglers=self._n_stragglers,
            straggler_blames=dict(self._blames) or None,
            hop_sample=self.sample,
        )
        self._epoch = None
        return True

    def stats(self) -> dict:
        out = self._tracer.stats()
        out["sample"] = self.sample
        return out


# ---------------------------------------------------------------- helpers
#
# Shared by tests / tools that reconcile a ``train_epoch`` trace event
# against the goodput ledger: both sides must tell the same story from
# the same timestamps, or one of the pipelines drifted.

def trace_phase_sums(trace_event: dict) -> Dict[str, float]:
    """Phase seconds derived purely from a ``train_epoch`` trace event's
    dispatch/pass spans, keyed to match the goodput ledger:

    - ``compute``  = fetch blocks + drains (device-bound; the ledger may
      further carve ``collective`` out of this — compare the SUM).
    - ``data_wait`` = stage windows.
    - ``host``     = dispatch enqueue + host residue (the ledger splits
      a ``compile`` share out of this — compare the SUM).
    - ``passes_wall`` = pass-span durations.
    """
    out = {"compute": 0.0, "data_wait": 0.0, "host": 0.0,
           "passes_wall": 0.0}
    for s in trace_event.get("spans") or []:
        attrs = s.get("attrs") or {}
        name = s.get("name")
        if name == "dispatch":
            out["compute"] += float(attrs.get("fetch_block_s") or 0.0)
            out["data_wait"] += float(attrs.get("data_wait_s") or 0.0)
            out["host"] += (float(attrs.get("dispatch_s") or 0.0)
                            + float(attrs.get("host_work_s") or 0.0))
        elif name.endswith("_pass"):
            out["compute"] += float(attrs.get("drain_s") or 0.0)
            out["passes_wall"] += float(s["t1"]) - float(s["t0"])
    return out


def tiling_error(trace_event: dict) -> float:
    """Max relative tiling gap of a ``train_epoch`` trace: the root's
    direct children (passes + interludes) vs the root wall, and each
    pass's children (startup + dispatches) vs the pass wall. Overlay
    spans (``overlap=True``) and hop children are excluded — they tile
    their own parent, checked one level down."""
    spans = trace_event.get("spans") or []
    dur = float(trace_event.get("dur_s") or 0.0)
    by_parent: Dict[int, float] = {}
    pass_walls: Dict[int, float] = {}
    for s in spans:
        if (s.get("attrs") or {}).get("overlap"):
            continue
        if s.get("name") in ("data_wait", "submit", "resolve", "host",
                             "device"):
            continue
        parent = s.get("parent", 0)
        by_parent[parent] = by_parent.get(parent, 0.0) \
            + float(s["t1"]) - float(s["t0"])
        if s.get("name", "").endswith("_pass"):
            pass_walls[s["id"]] = float(s["t1"]) - float(s["t0"])
    errs = []
    if dur > 0:
        errs.append(abs(by_parent.get(0, 0.0) - dur) / dur)
    for pid, wall in pass_walls.items():
        if wall > 0:
            errs.append(abs(by_parent.get(pid, 0.0) - wall) / wall)
    return max(errs) if errs else 0.0
