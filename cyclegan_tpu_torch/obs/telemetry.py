"""Telemetry bundle: the one object main.py/loop.py talk to. The port's
copy of the JAX package's ``obs/telemetry.py``, with its default path
(``<output_dir>/telemetry.jsonl``) and its ``none``/``off`` spellings.

Groups the JSONL stream, per-pass StepClocks, the stall watchdog, and
memory sampling behind a single surface so the training loop takes one
optional `obs` argument. `NULL_TELEMETRY` is the disabled stand-in (and
the non-primary-host one): every method is a cheap no-op, so the hot
loop calls telemetry methods unconditionally instead of branching.
"""

from __future__ import annotations

from typing import Optional

from cyclegan_tpu_torch.obs.goodput import GoodputLedger
from cyclegan_tpu_torch.obs.jsonl import MetricsLogger, NullMetricsLogger
from cyclegan_tpu_torch.obs.manifest import build_manifest
from cyclegan_tpu_torch.obs.memory import memory_watermarks
from cyclegan_tpu_torch.obs.stepclock import NullStepClock, StepClock
from cyclegan_tpu_torch.obs.watchdog import StallWatchdog


class Telemetry:
    def __init__(
        self,
        logger: MetricsLogger,
        step_log_every: int = 1,
        watchdog: Optional[StallWatchdog] = None,
        stall_multiple: float = 0.0,
        goodput: Optional[GoodputLedger] = None,
        train_tracer=None,
        devices=None,
    ):
        self.logger = logger
        self.devices = devices
        self.step_log_every = step_log_every
        self.stall_multiple = stall_multiple
        self.watchdog = watchdog
        self.goodput = goodput
        self.train_tracer = train_tracer
        self._clock: Optional[StepClock] = None
        if watchdog is not None:
            watchdog.start()

    @property
    def enabled(self) -> bool:
        return True

    def manifest(self, config=None, plan=None, **extra) -> None:
        self.logger.event(
            "manifest", **build_manifest(config, plan=plan, **extra)
        )

    def step_clock(self, epoch: int, split: str = "train") -> StepClock:
        """A fresh clock for one (epoch, split) pass, heartbeating the
        watchdog and exposing its pending depth to it."""
        beat = self.watchdog.beat if self.watchdog is not None else None
        on_finish = self.goodput.note_pass if self.goodput is not None else None
        clock = StepClock(
            self.logger, epoch, split=split,
            log_every=self.step_log_every, heartbeat=beat,
            stall_multiple=self.stall_multiple,
            on_finish=on_finish,
            observer=self.train_tracer,
        )
        self._clock = clock
        if self.watchdog is not None:
            self.watchdog.set_depth_fn(lambda: clock.depth)
        return clock

    def event(self, kind: str, /, **fields) -> None:
        # The goodput ledger rides existing events: epoch-services job
        # seconds and the comms census's link-model estimate feed it
        # without any new instrumentation in the emitters.
        if self.goodput is not None:
            if kind == "service_job":
                self.goodput.note_service(fields.get("seconds", 0.0))
            elif kind == "comms_census":
                self.goodput.note_census(fields)
            elif kind == "collective_probe":
                self.goodput.note_probe(fields)
        if self.train_tracer is not None:
            # Epoch-scale happenings land as instants on the open
            # epoch trace's root span (train_trace.INSTANT_KINDS).
            self.train_tracer.note_event(kind, fields)
        self.logger.event(kind, **fields)

    def epoch(self, epoch: int, **fields) -> None:
        """Per-epoch rollup: throughput, utilization, eval metrics —
        followed by the goodput ledger's phase rollup for the same
        window when an epoch duration is available."""
        if self.train_tracer is not None:
            # The rollup moment closes the epoch's trace, so its wall
            # covers passes + interludes up to exactly here.
            self.train_tracer.close_epoch(epoch)
        self.logger.event("epoch", epoch=epoch, **fields)
        if self.goodput is not None:
            elapse = fields.get("elapse_s") or fields.get("seconds")
            if elapse is not None:
                rollup = self.goodput.rollup(epoch, float(elapse))
                if rollup is not None:
                    self.logger.event("goodput", **rollup)

    def memory(self, epoch: int) -> None:
        self.logger.event("memory", epoch=epoch,
                          **memory_watermarks(self.devices))

    def flush(self) -> None:
        self.logger.flush()

    def close(self, status: str = "completed") -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.train_tracer is not None:
            # A run ending mid-epoch still flushes its open trace.
            self.train_tracer.close_epoch()
        if not self.logger.closed:
            self.logger.event("end", status=status)
            self.logger.close()


class NullTelemetry(Telemetry):
    def __init__(self):
        self.logger = NullMetricsLogger()
        self.step_log_every = 0
        self.stall_multiple = 0.0
        self.watchdog = None
        self.goodput = None
        self.train_tracer = None
        self.devices = None
        self._clock = None

    @property
    def enabled(self) -> bool:
        return False

    def manifest(self, config=None, plan=None, **extra):
        pass

    def step_clock(self, epoch, split="train"):
        return NullStepClock()

    def event(self, kind, /, **fields):
        pass

    def epoch(self, epoch, **fields):
        pass

    def memory(self, epoch):
        pass

    def flush(self):
        pass

    def close(self, status="completed"):
        pass


NULL_TELEMETRY = NullTelemetry()


def make_telemetry(obs_config, output_dir: str, primary: bool = True,
                   device=None) -> Telemetry:
    """Build run telemetry from the config's `obs` section.

    Disabled (NULL_TELEMETRY) when `obs.enabled` is false, when the
    jsonl path resolves empty, or on non-primary hosts (the port runs one
    process, so it is always the primary). `device` (a torch.device) is
    the one the run uses, whose memory the `memory` events sample; None
    samples every card.
    """
    import os

    if not primary or not getattr(obs_config, "enabled", True):
        return NULL_TELEMETRY
    path = getattr(obs_config, "jsonl_path", None)
    if path is None:
        path = os.path.join(output_dir, "telemetry.jsonl")
    if not path or path in ("none", "off"):
        return NULL_TELEMETRY
    logger = MetricsLogger(path)
    deadline = float(getattr(obs_config, "watchdog_deadline_s", 0.0) or 0.0)
    watchdog = StallWatchdog(logger, deadline) if deadline > 0 else None
    sample = float(getattr(obs_config, "train_trace_sample", 0.0) or 0.0)
    straggler = float(
        getattr(obs_config, "straggler_multiple", 0.0) or 0.0)
    train_tracer = None
    if sample > 0 or straggler > 0:
        from cyclegan_tpu_torch.obs.train_trace import TrainTracer

        train_tracer = TrainTracer(
            logger,
            sample=sample,
            max_spans=int(
                getattr(obs_config, "train_trace_max_spans", 4096)),
            straggler_multiple=straggler,
        )
    return Telemetry(
        logger,
        step_log_every=int(getattr(obs_config, "step_log_every", 1)),
        watchdog=watchdog,
        stall_multiple=float(getattr(obs_config, "stall_multiple", 0.0) or 0.0),
        goodput=GoodputLedger(),
        train_tracer=train_tracer,
        devices=None if device is None else [device],
    )
