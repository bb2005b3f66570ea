"""Request-scoped distributed tracing for the serving front end: the
port's copy of the JAX package's ``obs/trace.py``.

Aggregate telemetry (JSONL rollups, obs_report) says *that* interactive
p95 regressed; it never says *which hop* of *which request* ate the
budget. This module adds the missing layer: a host-side span graph per
request — mint a trace at ingress, record one span per pipeline hop
(admit -> queue -> stack -> submit -> device -> resolve), and flush the
whole graph as ONE ``trace`` event on the existing JSONL stream, where
``tools/trace_timeline.py`` turns any slice into a Chrome/Perfetto
timeline plus a per-hop critical-path table.

Design constraints, in order:

- **Zero device cost.** Everything here is stdlib + host clocks
  (``time.perf_counter``). The device segment of a request is derived
  from timestamps the pipeline already takes: the executor's wait on
  the CUDA event recorded behind a flush completing at T proves the
  flush finished by T (the obs/stepclock.py argument), so the "device"
  span is t_dispatched -> t_done with no extra sync, no extra dispatch.
  The port's no-sync test scans this file with NO sanctioned sites
  allowed.
- **Lock-free record path.** A TraceContext is owned by one request;
  its span buffer is a plain list (GIL-atomic appends), and the
  tracer's per-hop histograms are per-thread dicts registered once
  under a lock and merged only at read time (/metrics). The only lock
  a request's life touches is its own finish() guard (uncontended
  except for the hedge-twin race it exists to settle) and the JSONL
  logger's write lock for KEPT traces.
- **Failures are never invisible.** Head sampling (``sample`` fraction,
  decided at mint) bounds steady-state volume, but any trace whose
  final status is not "ok" — shed, evicted, expired, deadline_miss,
  error — is tail-kept regardless of the head decision, as is any
  trace explicitly ``mark_tail()``-ed (hedge-expired cancels).
- **First finish wins.** Both the pipeline's completion path and the
  HTTP handler call ``finish()``; the first call closes the root span
  and decides emit-vs-drop, later calls are no-ops. Spans recorded
  after a KEPT trace finished (a hedge loser cancelled at pop after
  its twin already resolved) are emitted as a supplementary ``trace``
  event with ``late=True`` sharing the trace_id; trace_timeline merges
  them back onto the same timeline.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Dict, List, Optional

# Statuses that tail-keep a trace: anything that is not a clean "ok".
OK_STATUS = "ok"

# Fixed histogram bucket edges (seconds) for the span-derived per-hop
# latency histograms /metrics renders. Log-ish spacing from sub-ms host
# hops to multi-second queue waits; the +Inf bucket is implicit.
HIST_BUCKETS_S = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                  0.1, 0.25, 0.5, 1.0, 2.5, 5.0)


def _now() -> float:
    return time.perf_counter()


class Span:
    """One timed hop of one request: [t_start, t_end) on the monotonic
    clock, a name, optional attrs, and optional point events."""

    __slots__ = ("span_id", "parent_id", "name", "t_start", "t_end",
                 "attrs", "events")

    def __init__(self, span_id: int, parent_id: Optional[int],
                 name: str, t_start: float,
                 attrs: Optional[dict] = None):
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.attrs = attrs
        self.events: Optional[List[dict]] = None

    def set(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def event(self, name: str, t: Optional[float] = None,
              **attrs) -> None:
        """Record a point event (a decision, not a duration) on this
        span — shed/evict verdicts, hedge launches, requeues."""
        e = {"name": name, "t": round(_now() if t is None else t, 6)}
        if attrs:
            e.update(attrs)
        if self.events is None:
            self.events = []
        self.events.append(e)  # GIL-atomic

    def end(self, t_end: Optional[float] = None, **attrs) -> None:
        if attrs:
            if self.attrs is None:
                self.attrs = {}
            self.attrs.update(attrs)
        self.t_end = _now() if t_end is None else t_end

    def to_dict(self) -> dict:
        d = {"id": self.span_id, "name": self.name,
             "t0": round(self.t_start, 6),
             "t1": round(self.t_end if self.t_end is not None
                         else self.t_start, 6)}
        if self.parent_id is not None:
            d["parent"] = self.parent_id
        if self.attrs:
            d["attrs"] = self.attrs
        if self.events:
            d["events"] = self.events
        return d


class TraceContext:
    """The per-request handle threaded through the serving pipeline.

    Owned by one request (and its hedge twin — they SHARE the context,
    which is exactly how the twin's spans land on the same trace_id).
    Record spans with ``span()``/``span_done()``, point events with
    ``event()``, then ``finish(status)`` exactly-once-wins."""

    __slots__ = ("tracer", "trace_id", "sampled", "tail", "root",
                 "spans", "kept", "_seq", "_finished", "_lock",
                 "n_late")

    def __init__(self, tracer: "Tracer", trace_id: str, sampled: bool,
                 name: str, t_start: Optional[float] = None,
                 attrs: Optional[dict] = None):
        self.tracer = tracer
        self.trace_id = trace_id
        self.sampled = sampled
        self.tail = False
        self._seq = itertools.count(1)  # 0 is the root
        self.root = Span(0, None, name,
                         _now() if t_start is None else t_start,
                         attrs=attrs or None)
        self.spans: List[Span] = []
        self.kept = False
        self._finished = False
        self._lock = threading.Lock()
        self.n_late = 0

    # -- recording --------------------------------------------------------
    def span(self, name: str, t_start: Optional[float] = None,
             parent: Optional[int] = None, **attrs) -> Span:
        """Open a child span (parent defaults to the root). The span is
        registered immediately; close it with ``.end()``."""
        s = Span(next(self._seq), 0 if parent is None else parent, name,
                 _now() if t_start is None else t_start,
                 attrs=attrs or None)
        self._record(s)
        return s

    def span_done(self, name: str, t_start: Optional[float],
                  t_end: float, **attrs) -> Span:
        """Record an already-elapsed hop in one call — the pipeline's
        common case, since hop boundaries are timestamps it already
        took. ``t_start=None`` anchors at the root's start (the ingress
        "admit" hop)."""
        s = Span(next(self._seq), 0, name,
                 self.root.t_start if t_start is None else t_start,
                 attrs=attrs or None)
        s.t_end = t_end
        self._record(s)
        return s

    def _record(self, s: Span) -> None:
        if not self._finished:
            self.spans.append(s)  # GIL-atomic; sole-owner in practice
            return
        # Late arrival (hedge loser cancelled after its twin already
        # resolved and the trace flushed): emit it as a supplement on
        # the same trace_id when the trace was kept, else drop.
        self.n_late += 1
        if self.kept:
            self.tracer._emit_late(self, s)

    def event(self, name: str, **attrs) -> None:
        """Point event on the root span (queue decisions: shed, evict,
        hedge, requeue)."""
        self.root.event(name, **attrs)

    def set(self, key: str, value) -> None:
        """Attach a root-span attribute (class/tenant/tier/brownout)."""
        self.root.set(key, value)

    def mark_tail(self) -> None:
        """Force tail-keep regardless of the head sampling decision —
        for traces that end "ok" but passed through a failure-shaped
        edge (a hedge twin expired at pop while the primary served)."""
        self.tail = True

    # -- completion -------------------------------------------------------
    def finish(self, status: str = OK_STATUS,
               t_end: Optional[float] = None, **attrs) -> bool:
        """Close the root span and flush. First caller wins; later
        calls (the HTTP handler's safety net after the pipeline already
        finished, or vice versa) are no-ops returning False."""
        with self._lock:
            if self._finished:
                return False
            self._finished = True
        self.root.end(t_end=t_end, **attrs)
        keep = (status != OK_STATUS) or self.tail or self.sampled
        self.kept = keep and self.tracer is not None
        if self.tracer is not None:
            self.tracer._finish(self, status, keep)
        return True

    @property
    def finished(self) -> bool:
        return self._finished


class Tracer:
    """Mints TraceContexts, owns the head-sampling decision, folds every
    finished trace into per-hop histograms (for /metrics), and emits
    kept traces to the JSONL logger as ``trace`` events.

    ``rng`` is injectable so tests pin the head-sampling coin; the
    default is an os.urandom-seeded ``random.Random`` (never the global
    one — a seeded workload must not perturb tracing or vice versa)."""

    def __init__(self, logger=None, sample: float = 0.0, rng=None):
        if not (0.0 <= sample <= 1.0):
            raise ValueError(
                f"sample must be in [0, 1], got {sample}")
        self._logger = logger
        self.sample = sample
        self._rng = rng if rng is not None else random.Random()
        # Per-thread fold state, registered once per thread under the
        # lock, merged only at read time — the record path never locks.
        self._tl = threading.local()
        self._states_lock = threading.Lock()
        self._states: List[dict] = []

    # -- minting ----------------------------------------------------------
    def trace(self, name: str = "request",
              t_start: Optional[float] = None, **attrs) -> TraceContext:
        sampled = self._rng.random() < self.sample
        trace_id = f"{self._rng.getrandbits(64):016x}"
        return TraceContext(self, trace_id, sampled, name,
                            t_start=t_start, attrs=attrs or None)

    # -- fold / emit (called from TraceContext.finish) --------------------
    def _state(self) -> dict:
        st = getattr(self._tl, "st", None)
        if st is None:
            st = {"hops": {}, "traces": 0, "emitted": 0, "tail": 0,
                  "late": 0}
            with self._states_lock:
                self._states.append(st)
            self._tl.st = st
        return st

    def _fold_span(self, st: dict, name: str, dur_s: float) -> None:
        h = st["hops"].get(name)
        if h is None:
            h = st["hops"][name] = {
                "buckets": [0] * (len(HIST_BUCKETS_S) + 1),
                "sum": 0.0, "count": 0}
        for i, edge in enumerate(HIST_BUCKETS_S):
            if dur_s <= edge:
                h["buckets"][i] += 1
                break
        else:
            h["buckets"][-1] += 1
        h["sum"] += dur_s
        h["count"] += 1

    def _finish(self, ctx: TraceContext, status: str,
                keep: bool) -> None:
        st = self._state()
        st["traces"] += 1
        root = ctx.root
        if root.t_end is not None:
            self._fold_span(st, root.name, root.t_end - root.t_start)
        for s in ctx.spans:
            if s.t_end is not None:
                self._fold_span(st, s.name, s.t_end - s.t_start)
        if not keep:
            return
        if status != OK_STATUS and not ctx.sampled:
            st["tail"] += 1
        if self._logger is None:
            return
        st["emitted"] += 1
        self._logger.event(
            "trace",
            trace_id=ctx.trace_id,
            name=root.name,
            status=status,
            sampled=ctx.sampled,
            tail=ctx.tail or status != OK_STATUS,
            t_start=round(root.t_start, 6),
            t_end=round(root.t_end, 6) if root.t_end is not None
            else None,
            dur_s=round(root.t_end - root.t_start, 6)
            if root.t_end is not None else None,
            attrs=root.attrs or None,
            events=root.events or None,
            spans=[s.to_dict() for s in ctx.spans],
        )

    def _emit_late(self, ctx: TraceContext, span: Span) -> None:
        st = self._state()
        st["late"] += 1
        if self._logger is None:
            return
        self._logger.event(
            "trace", trace_id=ctx.trace_id, late=True,
            spans=[span.to_dict()])

    # -- read side (/metrics, obs) ----------------------------------------
    def hop_histograms(self) -> Dict[str, dict]:
        """Merged per-hop histograms across every recording thread:
        hop name -> {"buckets": [...], "sum": s, "count": n} with
        bucket edges HIST_BUCKETS_S (+Inf last). Safe at any frequency
        — reads race benignly against single-writer int bumps."""
        out: Dict[str, dict] = {}
        with self._states_lock:
            states = list(self._states)
        for st in states:
            for name, h in st["hops"].items():
                m = out.get(name)
                if m is None:
                    m = out[name] = {
                        "buckets": [0] * (len(HIST_BUCKETS_S) + 1),
                        "sum": 0.0, "count": 0}
                m["buckets"] = [a + b for a, b in
                                zip(m["buckets"], h["buckets"])]
                m["sum"] += h["sum"]
                m["count"] += h["count"]
        return out

    def stats(self) -> dict:
        with self._states_lock:
            states = list(self._states)
        out = {"sample": self.sample, "traces": 0, "emitted": 0,
               "tail": 0, "late": 0}
        for st in states:
            for k in ("traces", "emitted", "tail", "late"):
                out[k] += st[k]
        return out


class NullTraceContext:
    """No-op context: every recording call is a cheap early return.
    Pipelines treat ``trace=None`` the same way; this exists so code
    holding "a context" never needs a None-check ladder."""

    trace_id = ""
    sampled = False
    tail = False
    kept = False
    finished = False

    def span(self, name, t_start=None, parent=None, **attrs):
        return _NULL_SPAN

    def span_done(self, name, t_start, t_end, **attrs):
        return _NULL_SPAN

    def event(self, name, **attrs):
        pass

    def set(self, key, value):
        pass

    def mark_tail(self):
        pass

    def finish(self, status=OK_STATUS, t_end=None, **attrs):
        return False


class _NullSpan:
    def set(self, key, value):
        pass

    def event(self, name, t=None, **attrs):
        pass

    def end(self, t_end=None, **attrs):
        pass


_NULL_SPAN = _NullSpan()
NULL_TRACE = NullTraceContext()


class NullTracer:
    """Tracer-shaped no-op for front-ends started without tracing."""

    sample = 0.0

    def trace(self, name: str = "request", t_start=None, **attrs):
        return NULL_TRACE

    def hop_histograms(self) -> dict:
        return {}

    def stats(self) -> dict:
        return {"sample": 0.0, "traces": 0, "emitted": 0, "tail": 0,
                "late": 0}
