"""Trace capture (``--trace N``): the port's form of the JAX package's
``utils/profiler.py``, a ``torch.profiler`` window over N dispatches of
the train loop, with CPU and CUDA activity (CUPTI), written as a Chrome
trace (viewable in Perfetto or chrome://tracing) under
``<output_dir>/traces``.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch


class TraceCapture:
    """Trace ``num_steps`` dispatches of the train loop.

    Call ``step()`` once before each dispatch. The first dispatch (the
    kernels' build, cuDNN's warm-up and, with ``--steps_per_dispatch``,
    the eager group before the CUDA graph's capture) is left out: the
    window covers dispatches 2..num_steps+1. ``stop()`` waits for the card,
    then writes the trace; it is idempotent and safe in a ``finally``.
    """

    def __init__(self, output_dir: str, num_steps: int = 10,
                 enabled: bool = True):
        self.trace_dir = os.path.join(output_dir, "traces")
        self.num_steps = int(num_steps)
        self.enabled = bool(enabled) and self.num_steps > 0
        self.path: Optional[str] = None
        self._seen = 0
        self._prof = None

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        self._prof = profile(activities=activities)
        self._prof.start()

    def step(self) -> None:
        if not self.enabled:
            return
        self._seen += 1
        if self._prof is None and self._seen == 2:
            self._start()
        elif self._prof is not None and self._seen - 2 >= self.num_steps:
            self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self.path = os.path.join(
            self.trace_dir, f"trace_{os.getpid()}_{int(time.time())}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self.enabled = False


def maybe_trace(output_dir: str, num_steps: Optional[int]) -> TraceCapture:
    """A TraceCapture that does nothing when ``num_steps`` is falsy."""
    return TraceCapture(output_dir, num_steps or 0, enabled=bool(num_steps))
