"""Stall watchdog: detect the hung-device failure mode while it happens.
The port's copy of the JAX package's ``obs/watchdog.py``.

The failure it catches: the device wedges, dispatches keep succeeding
(they are asynchronous) until the backpressure window fills, and then
the host sits silently in the deferred fetch's wait forever — from the
outside the run just stops printing. The watchdog is a daemon thread fed heartbeats by the
StepClock (each dispatch and each completed fetch beats it); if no beat
arrives within `deadline_s` it logs a `stall` event carrying the stall
age and the pending-dispatch depth (how many batches are in flight —
depth at MAX_IN_FLIGHT means the device stopped retiring work; depth 0
means the INPUT pipeline stopped producing), and prints one warning to
stderr. It re-arms after the next beat, so a recovered run logs each
stall episode once.

Purely host-side: a thread, a monotonic clock, and a file write — it
can observe a wedged device precisely because it never touches it.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Optional


class StallWatchdog:
    def __init__(
        self,
        logger,
        deadline_s: float,
        poll_s: Optional[float] = None,
        depth_fn: Optional[Callable[[], Optional[int]]] = None,
        echo: bool = True,
    ):
        self._logger = logger
        self.deadline_s = float(deadline_s)
        self._poll_s = poll_s if poll_s is not None else max(0.05, self.deadline_s / 4.0)
        self._depth_fn = depth_fn or (lambda: None)
        self._echo = echo
        self._last = time.monotonic()
        self._fired = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.n_stalls = 0

    def beat(self) -> None:
        """Progress signal (called from the training loop via StepClock);
        re-arms the watchdog after a stall episode."""
        self._last = time.monotonic()
        self._fired = False

    def set_depth_fn(self, fn: Callable[[], Optional[int]]) -> None:
        """Point the watchdog at the live StepClock's pending depth."""
        self._depth_fn = fn

    def start(self) -> "StallWatchdog":
        if self.deadline_s <= 0 or self._thread is not None:
            return self
        self._last = time.monotonic()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="cyclegan-stall-watchdog"
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            age = time.monotonic() - self._last
            if age > self.deadline_s and not self._fired:
                self._fired = True
                self.n_stalls += 1
                try:
                    depth = self._depth_fn()
                except Exception:
                    depth = None
                self._logger.event(
                    "stall",
                    age_s=round(age, 3),
                    deadline_s=self.deadline_s,
                    pending_depth=depth,
                )
                self._logger.flush()
                if self._echo:
                    print(
                        f"[obs] WARNING: no step completed in {age:.1f}s "
                        f"(deadline {self.deadline_s:.1f}s, pending depth "
                        f"{depth}) — device hang or input stall?",
                        file=sys.stderr, flush=True,
                    )

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
