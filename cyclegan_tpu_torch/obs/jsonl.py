"""Append-only JSONL event stream: the port's copy of the JAX package's
``obs/jsonl.py``, with the same envelope, kinds and fields, so that
``tools/obs_report.py`` and the other stream tools fold either package's
stream.

One JSON object per line, written line-buffered so every completed event
reaches the filesystem immediately — a SIGKILLed or preempted run keeps
its telemetry up to the last finished event, with at most the in-flight
line lost (tools/obs_report.py tolerates a truncated tail). Events share
two envelope fields: `event` (the record type) and `t` (seconds since the
logger opened, monotonic within a run); everything else is per-type
payload. The stream is self-describing: the first event of a run is the
manifest (obs/manifest.py).

Thread-safety: `event()` takes an RLock, so the stall-watchdog thread,
the prefetch worker, and a signal handler on the main thread can all log
concurrently — and a handler interrupting the main thread mid-`event()`
re-enters the lock instead of deadlocking (the interrupted line may
interleave at the line level, never within a line, because the write is
a single `write()` call).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import IO, Optional

# Bumped when an existing event type changes incompatibly; new event
# types and new optional fields are NOT version bumps (consumers must
# ignore unknown events/fields — tools/obs_report.py does).
EVENT_SCHEMA_VERSION = 1


def _json_default(value):
    """Last-resort coercion for numpy scalars/arrays and other
    non-JSON-native values reaching an event payload."""
    for attr in ("item", "tolist"):  # numpy scalar / array
        fn = getattr(value, attr, None)
        if callable(fn):
            try:
                return fn()
            except Exception:
                pass
    return repr(value)


class MetricsLogger:
    """Append-only JSONL writer for one run's telemetry stream."""

    def __init__(self, path: str, clock=time.monotonic):
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        # Line-buffered append: one flush per event, incremental by
        # construction; append mode so a resumed run extends the same
        # stream (its fresh manifest marks the boundary).
        self._f: Optional[IO[str]] = open(path, "a", buffering=1)
        self._lock = threading.RLock()
        self._clock = clock
        self._t0 = clock()
        self.n_events = 0

    @property
    def closed(self) -> bool:
        return self._f is None

    def event(self, kind: str, /, **fields) -> None:
        """Append one event. Never raises into the caller's loop: an IO
        error (disk full, closed stream) drops the event — telemetry
        must not be able to kill a training run. `kind` is
        positional-only so a payload may itself carry a `kind` field
        (per-dispatch step events do)."""
        rec = {"event": kind, "t": round(self._clock() - self._t0, 6)}
        rec.update(fields)
        try:
            line = json.dumps(rec, default=_json_default)
        except (TypeError, ValueError):
            return
        with self._lock:
            if self._f is None:
                return
            try:
                self._f.write(line + "\n")
                self.n_events += 1
            except (OSError, ValueError):
                pass

    def flush(self) -> None:
        """Push buffered bytes to the OS (async-signal tolerant: the
        preemption handler calls this mid-run)."""
        with self._lock:
            if self._f is not None:
                try:
                    self._f.flush()
                except (OSError, ValueError):
                    pass

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


class NullMetricsLogger(MetricsLogger):
    """No-op stream: telemetry disabled, or a non-primary host in a
    multi-host run (every process runs the same loop; only host 0
    writes — the utils/summary.py NullSummary pattern)."""

    def __init__(self, path: str = ""):
        self.path = path
        self._f = None
        self._lock = threading.RLock()
        self.n_events = 0

    def event(self, kind: str, /, **fields) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
