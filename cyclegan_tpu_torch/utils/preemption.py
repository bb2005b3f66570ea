"""Preemption-aware shutdown: the port's copy of the JAX package's
``utils/preemption.py``.

A cloud platform sends SIGTERM before it takes a machine back. The guard
traps it and records a stop request; the driver (``main.py``) then
finishes the epoch, checkpoints and exits cleanly, and auto-resume goes on
from the next epoch. With ``--preempt_deadline_s`` the loop also polls the
request once per dispatch and writes a step-granular emergency slot
(``resil/elastic.py``).

The port runs one process, so ``should_stop()`` is the local flag: there
is no ``distributed.sync_flag`` to agree across hosts.
"""

from __future__ import annotations

import signal
import time
from types import FrameType
from typing import Callable, Iterable, Optional


class PreemptionGuard:
    """Installs handlers for ``signals`` (SIGTERM by default) that record a
    stop request; ``should_stop()`` is the epoch-boundary check.

    ``on_signal`` callbacks run inside the handler, right after the flag
    is set: the hooks that flush buffered summaries (``Summary.flush``)
    and the telemetry stream's tail (``Telemetry.flush``) the moment the
    signal lands, so a grace window that ends before the
    checkpoint loses nothing already recorded. They must only push bytes
    already buffered, never dispatch device work or block; their
    exceptions are swallowed, so a broken callback cannot break the
    shutdown.
    """

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,),
                 install: bool = True,
                 on_signal: Iterable[Callable[[], None]] = ()):
        self._requested = False
        self._requested_at: Optional[float] = None
        self._prev = {}
        self._callbacks = list(on_signal)
        if install:
            for sig in signals:
                self._prev[sig] = signal.signal(sig, self._handle)

    def _handle(self, signum: int, frame: Optional[FrameType]) -> None:
        self.request_stop()
        for fn in self._callbacks:
            try:
                fn()
            except Exception:
                pass

    def request_stop(self) -> None:
        """A stop request without a signal (tests, host callers)."""
        self._requested = True
        if self._requested_at is None:
            self._requested_at = time.monotonic()

    @property
    def requested_locally(self) -> bool:
        return self._requested

    @property
    def requested_at(self) -> Optional[float]:
        """``time.monotonic()`` of the first stop request: the start of the
        platform's grace window, from which an emergency save budgets."""
        return self._requested_at

    def should_stop(self) -> bool:
        """Whether a stop was requested; one process, so the local flag."""
        return self._requested

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev = {}
