"""Run observability: the port's copy of the JAX package's ``obs/``.

- ``health.py``: the train step's health metrics and their host-side
  detectors.
- The telemetry stream: an append-only JSONL event stream
  (``jsonl.py``) opened by a run manifest (``manifest.py``), a step clock
  that splits each dispatch's wall into staging, enqueue, fetch and host
  time from timestamps the loop already takes (``stepclock.py``), the
  per-epoch goodput ledger (``goodput.py``), memory watermarks
  (``memory.py``), a stall watchdog (``watchdog.py``), training traces
  and the straggler detector (``train_trace.py``), all behind one
  ``Telemetry`` object (``telemetry.py``); and the request tracer of the
  server (``trace.py``). Event kinds and fields are the JAX package's, so
  ``tools/obs_report.py``, ``tools/goodput_timeline.py``,
  ``tools/trace_timeline.py`` and ``tools/run_compare.py`` fold the
  port's stream as they fold the JAX one.

Nothing here adds a host-device synchronization to the dispatch loop:
the step clock reads ``perf_counter`` around work the loop does anyway,
and the one wait is the deferred fetch's, on the event recorded behind
its own dispatch (``train/loop.py``). ``tests/test_torch_port_obs.py``
checks this statically. The JAX package's ``comms.py`` and
``collective_probe.py`` come with data parallelism.
"""

from cyclegan_tpu_torch.obs.goodput import (
    BADPUT_PHASES,
    PHASES,
    GoodputLedger,
    classify_pass,
    rollup_phases,
)
from cyclegan_tpu_torch.obs.health import (
    HealthFault,
    HealthMonitor,
    finalize_health_metrics,
    make_health_monitor,
)
from cyclegan_tpu_torch.obs.jsonl import (
    EVENT_SCHEMA_VERSION,
    MetricsLogger,
    NullMetricsLogger,
)
from cyclegan_tpu_torch.obs.manifest import build_manifest
from cyclegan_tpu_torch.obs.memory import memory_watermarks
from cyclegan_tpu_torch.obs.stepclock import NullStepClock, StepClock
from cyclegan_tpu_torch.obs.telemetry import (
    NULL_TELEMETRY,
    NullTelemetry,
    Telemetry,
    make_telemetry,
)
from cyclegan_tpu_torch.obs.trace import (
    NULL_TRACE,
    NullTraceContext,
    NullTracer,
    Span,
    TraceContext,
    Tracer,
)
from cyclegan_tpu_torch.obs.train_trace import (
    StragglerDetector,
    TrainTracer,
    tiling_error,
    trace_phase_sums,
)
from cyclegan_tpu_torch.obs.watchdog import StallWatchdog

__all__ = [
    "EVENT_SCHEMA_VERSION",
    "PHASES",
    "BADPUT_PHASES",
    "GoodputLedger",
    "classify_pass",
    "rollup_phases",
    "HealthFault",
    "HealthMonitor",
    "finalize_health_metrics",
    "make_health_monitor",
    "MetricsLogger",
    "NullMetricsLogger",
    "build_manifest",
    "memory_watermarks",
    "StepClock",
    "NullStepClock",
    "StallWatchdog",
    "Telemetry",
    "NullTelemetry",
    "NULL_TELEMETRY",
    "make_telemetry",
    "Tracer",
    "NullTracer",
    "TraceContext",
    "NullTraceContext",
    "NULL_TRACE",
    "Span",
    "TrainTracer",
    "StragglerDetector",
    "trace_phase_sums",
    "tiling_error",
]
