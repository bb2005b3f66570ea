"""Training goodput ledger: classify every wall-clock second by cause.
The port's copy of the JAX package's ``obs/goodput.py``; on one card the
``collective`` phase stays 0 (no comms census, ``comms_s_per_step=0``).

The StepClock already timestamps everything the dispatch loop does
(stage, dispatch, deferred fetch, drain, host residue) and the epoch
services worker already reports its job seconds — this module only
*folds* those existing numbers into a per-epoch phase ledger. Zero new
dispatches, zero syncs, zero extra timestamps: the port's no-sync test
covers this file, and tests pin that a traced run performs exactly the
dispatches an untraced run does.

Phase taxonomy (per epoch, seconds; fractions sum to 1.0 exactly):

- ``compute``        device-bound time: the deferred-fetch blocks plus
                     the end-of-pass drain. A fetch completing proves
                     its step finished on device — at steady state the
                     loop paces to device step time here.
- ``collective``     the slice of compute attributable to inter-chip
                     collectives, estimated from the comms census
                     (``est_step_comms_s`` x steps) when one has been
                     recorded; 0 otherwise. Carved OUT of compute.
- ``data_wait``      staging windows: the device had nothing queued
                     because the input pipeline made the host wait.
- ``host``           dispatch enqueue cost (minus the compile share),
                     metric bookkeeping, and loop-wall residue not in
                     any timed window.
- ``compile``        first-dispatch excess over the steady per-dispatch
                     cost — trace+compile rides dispatch 0's return.
- ``services``       epoch-services seconds (checkpoint, FID, export)
                     that did NOT overlap a pass: the worker thread
                     runs concurrently, so only the remainder outside
                     pass walls counts; overlapped seconds are reported
                     separately as ``service_overlap_s``.
- ``idle``           epoch wall not attributed to any of the above
                     (between-pass gaps, eval setup, logging).

A service job finishing after an epoch's rollup attributes to the NEXT
epoch's window — the ledger never rewrites an emitted event.
"""

from __future__ import annotations

from typing import Dict, List, Optional

PHASES = ("compute", "collective", "data_wait", "host", "compile",
          "services", "idle")

# Badput = every phase that is not productive device compute.
BADPUT_PHASES = tuple(p for p in PHASES if p != "compute")


def classify_pass(agg: dict) -> Dict[str, float]:
    """Split one `epoch_steps` aggregate into phase seconds.

    The per-pass phases sum to the pass wall exactly (up to float
    rounding): the compile share is carved out of dispatch time, and
    loop-wall residue lands in ``host``.
    """
    wall = float(agg.get("wall_s", 0.0) or 0.0)
    stage = float(agg.get("stage_s", 0.0) or 0.0)
    dispatch = float(agg.get("dispatch_s", 0.0) or 0.0)
    fetch = float(agg.get("fetch_block_s", 0.0) or 0.0)
    drain = float(agg.get("drain_s", 0.0) or 0.0)
    host_work = float(agg.get("host_work_s", 0.0) or 0.0)
    d0 = float(agg.get("dispatch0_s", 0.0) or 0.0)
    n = int(agg.get("n_dispatches", 0) or 0)

    # Compile estimate: dispatch 0 carries trace+compile; its excess
    # over the mean steady dispatch cost is the compile share.
    compile_s = 0.0
    if n > 1 and d0 > 0:
        steady = (dispatch - d0) / (n - 1)
        compile_s = max(0.0, min(d0 - steady, dispatch))
    elif n == 1:
        compile_s = d0
    residual = max(0.0, wall - stage - dispatch - fetch - drain - host_work)
    return {
        "compute": fetch + drain,
        "data_wait": stage,
        "host": max(0.0, dispatch - compile_s) + host_work + residual,
        "compile": compile_s,
        "wall": wall,
        "n_steps": int(agg.get("n_steps", 0) or 0),
    }


def rollup_phases(passes: List[Dict[str, float]], service_s: float,
                  elapse_s: float,
                  comms_s_per_step: float = 0.0) -> Dict[str, object]:
    """Fold classified passes + service seconds into the per-epoch
    `goodput` event payload. Phase seconds sum to ``elapse_s`` exactly
    (the epoch remainder is split services-then-idle), so fractions
    sum to 1."""
    tot = {p: 0.0 for p in PHASES}
    n_steps = 0
    passes_wall = 0.0
    for p in passes:
        tot["compute"] += p["compute"]
        tot["data_wait"] += p["data_wait"]
        tot["host"] += p["host"]
        tot["compile"] += p["compile"]
        passes_wall += p["wall"]
        n_steps += int(p["n_steps"])
    # Collective share: census estimate x steps, bounded by compute —
    # collectives surface inside the fetch-paced device time.
    if comms_s_per_step > 0 and n_steps > 0:
        carve = min(tot["compute"], comms_s_per_step * n_steps)
        tot["collective"] = carve
        tot["compute"] -= carve
    elapse = max(float(elapse_s), 0.0)
    attributed = tot["compute"] + tot["collective"] + tot["data_wait"] \
        + tot["host"] + tot["compile"]
    remainder = max(0.0, elapse - attributed)
    services = min(remainder, max(0.0, float(service_s)))
    tot["services"] = services
    tot["idle"] = remainder - services
    overlap = max(0.0, float(service_s) - services)

    denom = elapse if elapse > 0 else max(attributed, 1e-9)
    fractions = {p: round(tot[p] / denom, 6) for p in PHASES}
    badput = {p: fractions[p] for p in BADPUT_PHASES if fractions[p] > 0}
    return {
        "elapse_s": round(elapse, 6),
        "phases_s": {p: round(tot[p], 6) for p in PHASES},
        "phase_fractions": fractions,
        "goodput_fraction": fractions["compute"],
        "badput": dict(sorted(badput.items(), key=lambda kv: -kv[1])),
        "n_steps": n_steps,
        "n_passes": len(passes),
        "passes_wall_s": round(passes_wall, 6),
        "service_overlap_s": round(overlap, 6),
        "comms_s_per_step": comms_s_per_step,
    }


class GoodputLedger:
    """Accumulates pass aggregates + service seconds between epoch
    rollups. Fed entirely by Telemetry (StepClock on_finish hook and
    `service_job` event interception) — the training loop never sees
    this object."""

    def __init__(self, comms_s_per_step: float = 0.0):
        self.comms_s_per_step = float(comms_s_per_step)
        self.comms_source = "config" if comms_s_per_step > 0 else "none"
        self.census_comms_s = 0.0  # analytic estimate, kept for deltas
        self._passes: List[Dict[str, float]] = []
        self._service_s = 0.0

    def note_pass(self, agg: dict) -> None:
        if agg:
            self._passes.append(classify_pass(agg))

    def note_service(self, seconds: float) -> None:
        try:
            self._service_s += max(0.0, float(seconds))
        except (TypeError, ValueError):
            pass

    def note_census(self, payload: dict) -> None:
        """Pick up the collective-seconds estimate when a comms census
        with a link model is recorded. A measured probe value, once
        seen, always wins over the analytic estimate."""
        est = payload.get("est_step_comms_s")
        if est is not None:
            try:
                self.census_comms_s = max(0.0, float(est))
            except (TypeError, ValueError):
                return
            if self.comms_source != "probe":
                self.comms_s_per_step = self.census_comms_s
                self.comms_source = "census"

    def note_probe(self, payload: dict) -> None:
        """Pick up the MEASURED collective seconds when a collective
        probe (obs/collective_probe.py) reports — calibrated fact
        replaces the census's ring-model assumption."""
        measured = payload.get("measured_step_comms_s")
        if measured is None:
            return
        try:
            self.comms_s_per_step = max(0.0, float(measured))
        except (TypeError, ValueError):
            return
        self.comms_source = "probe"
        census = (payload.get("census") or {}).get("est_step_comms_s")
        if census is not None:
            try:
                self.census_comms_s = max(0.0, float(census))
            except (TypeError, ValueError):
                pass

    def rollup(self, epoch: int, elapse_s: float) -> Optional[dict]:
        """Emit-ready payload for the epoch window, then reset the
        window. Returns None when nothing was observed (no passes and
        no services) — streams without StepClock data stay ledger-free
        rather than all-idle."""
        if not self._passes and self._service_s == 0.0:
            return None
        out = rollup_phases(self._passes, self._service_s, elapse_s,
                            self.comms_s_per_step)
        out["epoch"] = epoch
        out["comms_source"] = self.comms_source
        if self.comms_source == "probe" and self.census_comms_s > 0:
            out["comms_probe_delta_frac"] = round(
                (self.comms_s_per_step - self.census_comms_s)
                / self.census_comms_s, 4)
        self._passes = []
        self._service_s = 0.0
        return out
