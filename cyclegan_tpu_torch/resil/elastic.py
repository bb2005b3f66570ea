"""Mid-epoch preemption: the single-process part of the JAX package's
``resil/elastic.py``.

With ``--preempt_deadline_s S`` > 0 a SIGTERM does not wait for the end
of the epoch:
- the training loop polls the ``PreemptionGuard``'s flag once per
  dispatch (``MidEpochBreaker``; a host-local read, no device sync) and
  leaves the epoch at the next dispatch;
- ``emergency_save`` writes a slot of the current epoch whose
  ``meta.json`` holds ``mid_epoch`` = {epoch, step, data_seed}, the
  position of the first batch not trained, within S seconds of the signal
  (queued cosmetic jobs, the cycle panels, are shed);
- on restart ``restore_if_exists`` reads that record back: the run
  resumes in the same epoch at that step, with the data pipeline cut to
  exactly batches step.. of the epoch (``data/pipeline.py``), and a slot
  whose epoch had in fact finished rolls forward to the next.

Not ported (ROADMAP.md): topology records and resharding across meshes,
the multi-process preflight, and fault injection (``--inject``) with the
kill timer that enforces its grace window.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

from cyclegan_tpu_torch.utils.checkpoint import save_meta


@dataclasses.dataclass
class Resume:
    """Where a run starts: its state, epoch and step within that epoch."""

    state: object
    start_epoch: int = 0
    resumed: bool = False
    resume_step: int = 0
    data_seed: Optional[int] = None


def restore_if_exists(ckpt, state, data=None, partial: bool = False,
                      echo: Optional[Callable[[str], None]] = None) -> Resume:
    """Auto-resume from the newest verified slot, at the step an emergency
    save recorded. With ``data`` (a ``CycleGANData``) the saved data seed
    is restored, and a resume step at or past the epoch's end moves to the
    next epoch's start."""
    state, next_epoch, resumed = ckpt.restore_if_exists(state,
                                                        partial=partial)
    out = Resume(state=state, start_epoch=next_epoch, resumed=resumed)
    if not resumed:
        return out
    meta = ckpt.read_meta()
    mid = meta.get("mid_epoch")
    if (isinstance(mid, dict)
            and int(meta.get("epoch", -1)) == next_epoch - 1
            and int(mid.get("epoch", -1)) == next_epoch - 1):
        out.start_epoch = next_epoch - 1
        out.resume_step = max(0, int(mid.get("step", 0)))
        if mid.get("data_seed") is not None:
            out.data_seed = int(mid["data_seed"])
        if echo is not None and out.resume_step:
            echo(f"mid-epoch resume: epoch {out.start_epoch} continues at "
                 f"step {out.resume_step}")
    if data is not None:
        if out.data_seed is not None:
            data.restore_seed(out.data_seed)
        if out.resume_step >= data.train_steps:
            # The epoch had finished dispatching when the save landed.
            out.start_epoch += 1
            out.resume_step = 0
    return out


class MidEpochBreaker:
    """The loop's once-a-dispatch preemption poll. ``note()`` counts the
    pipeline batches dispatched, so the emergency slot records the exact
    position; batches staged but not dispatched are not counted, so a
    resume yields them again."""

    def __init__(self, guard):
        self.guard = guard
        self.batches_done = 0
        self.fired = False

    def note(self, n: int = 1) -> None:
        self.batches_done += int(n)

    def should_break(self) -> bool:
        if (not self.fired and self.guard is not None
                and self.guard.requested_locally):
            self.fired = True
        return self.fired


# Cosmetic service jobs an expiring grace window sheds: the budget belongs
# to the checkpoint.
_SHEDDABLE_JOB_PREFIXES = ("plot_cycle:",)


def emergency_save(ckpt, state, config, data, epoch: int, step: int, guard,
                   services=None, telemetry=None,
                   echo: Optional[Callable[[str], None]] = None,
                   transfer: Optional[dict] = None) -> None:
    """Write the step-granular emergency slot within the
    ``preempt_deadline_s`` budget, counted from the signal
    (``guard.requested_at``). Queued cosmetic jobs are shed so that the
    one worker reaches the checkpoint first; the barrier then waits out
    what is left of the budget; the ``emergency_save`` event (to
    ``telemetry``, with whether the save landed within the budget) and
    the echoed line say how much of it the save took."""
    deadline = float(config.train.preempt_deadline_s or 0.0)
    signal_at = getattr(guard, "requested_at", None) or time.monotonic()
    meta = save_meta(config, transfer,
                     mid_epoch={"epoch": epoch, "step": step,
                                "data_seed": data.seed})
    shed = 0
    if services is not None:
        shed = services.drop_pending(
            lambda name: name.startswith(_SHEDDABLE_JOB_PREFIXES))
    ckpt.save(state, epoch, meta=meta, services=services)
    committed = True
    if services is not None:
        budget = None
        if deadline > 0:
            budget = max(0.05, deadline - (time.monotonic() - signal_at))
        committed = services.barrier(timeout=budget)
    elapsed = time.monotonic() - signal_at
    margin = (deadline - elapsed) if deadline > 0 else None
    if telemetry is not None:
        telemetry.event(
            "emergency_save", epoch=int(epoch), step=int(step),
            deadline_s=deadline, elapsed_s=round(elapsed, 4),
            margin_s=round(margin, 4) if margin is not None else None,
            shed_jobs=shed, committed=bool(committed))
    if echo is not None:
        echo(f"emergency save: epoch {epoch} step {step} -> "
             f"{os.path.basename(ckpt.slot)} ({elapsed:.2f}s of "
             f"{deadline:.2f}s budget"
             + (f", {shed} queued job(s) shed" if shed else "") + ")")
