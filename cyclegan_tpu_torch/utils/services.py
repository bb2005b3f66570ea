"""Background epoch services: host-side I/O off the training loop's
thread. The port's copy of the JAX package's ``utils/services.py``.

At a checkpoint epoch the loop used to write the slot itself and render
the cycle panels before the next epoch's first step (PERF.md has the
seconds). None of that needs the device or the loop's thread once the
host copies exist.

``EpochServices`` is one daemon worker thread with a job queue:

- ``submit(name, fn, *args)`` enqueues a job and returns at once.
- ``barrier()`` blocks until every submitted job has finished: at
  preemption, before a health-fault exit and at exit (``close()``), the
  only points where the loop waits on the services. A clean exit, or a
  preemption's grace window, always commits the last save first.
- A job's exception never reaches the worker (the thread survives): it is
  recorded in ``errors`` and echoed once. With a telemetry sink
  (``event(kind, **fields)``; the driver passes its ``Telemetry``), each
  job sends a ``service_job`` event with its seconds, which the goodput
  ledger counts as the ``services`` phase, and each failure a
  ``service_error``.

One worker on purpose: jobs run in submission order, so a checkpoint
commit queued before a panel render finishes first, and two saves never
interleave their manifest and ``meta.json`` writes.

The worker never touches the device: its jobs take host copies that the
loop's thread made.
"""

from __future__ import annotations

import queue
import threading
from time import perf_counter
from typing import Callable, List, Optional


class EpochServices:
    def __init__(self, telemetry=None, echo: Callable[[str], None] = print):
        self._tele = telemetry
        self._echo = echo
        self._q: "queue.Queue" = queue.Queue()
        self._cv = threading.Condition()
        self._pending = 0
        self._closed = False
        self.errors: List[str] = []
        self._thread = threading.Thread(target=self._run,
                                        name="epoch-services", daemon=True)
        self._thread.start()

    @property
    def pending(self) -> int:
        with self._cv:
            return self._pending

    def submit(self, name: str, fn: Callable, *args, **kwargs) -> None:
        """Enqueue ``fn(*args, **kwargs)`` and return. After ``close()`` the
        job runs inline: late work (a final flush on an exit path) is not
        dropped."""
        if self._closed:
            self._run_job(name, fn, args, kwargs)
            return
        with self._cv:
            self._pending += 1
        self._q.put((name, fn, args, kwargs))

    def _run_job(self, name, fn, args, kwargs) -> None:
        t0 = perf_counter()
        try:
            fn(*args, **kwargs)
        except Exception as e:  # a job's failure must not end the worker
            msg = f"{name}: {type(e).__name__}: {e}"
            self.errors.append(msg)
            self._echo(f"epoch-services job failed — {msg}")
            if self._tele is not None:
                self._tele.event("service_error", job=name, error=msg[:500])
            return
        if self._tele is not None:
            self._tele.event("service_job", job=name,
                             seconds=round(perf_counter() - t0, 6))

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            name, fn, args, kwargs = item
            try:
                self._run_job(name, fn, args, kwargs)
            finally:
                with self._cv:
                    self._pending -= 1
                    self._cv.notify_all()

    def drop_pending(self, should_drop: Callable[[str], bool]) -> int:
        """Discard the queued (not yet running) jobs whose name matches,
        keeping the rest in submission order; the emergency save sheds
        cosmetic work this way so that its budget reaches the checkpoint.
        Returns how many were dropped. A running job is never touched."""
        kept, dropped = [], 0
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:  # the worker's stop sentinel stays
                kept.append(item)
                continue
            if should_drop(item[0]):
                dropped += 1
            else:
                kept.append(item)
        for item in kept:
            self._q.put(item)
        if dropped:
            with self._cv:
                self._pending -= dropped
                self._cv.notify_all()
        return dropped

    def barrier(self, timeout: Optional[float] = None) -> bool:
        """Wait until every submitted job has finished; False on timeout
        (jobs still pending)."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0, timeout)

    def close(self, timeout: Optional[float] = None) -> bool:
        """Barrier, then stop the worker. Idempotent."""
        done = self.barrier(timeout)
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join(timeout)
        return done
