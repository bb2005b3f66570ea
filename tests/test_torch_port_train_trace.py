"""The port's training traces and straggler watch (obs/train_trace.py)
against the JAX package's, on the CPU.

A ``TrainTracer`` is the observer of a ``StepClock`` driven by a scripted
pass (tests/test_torch_port_obs.py's ``_clock_script``) on a numpy-seeded
clock, with a seeded ``random.Random`` for its trace ids and hop sampling:
two epochs, a train and a test pass each, a long read that makes a
straggler. The JAX objects and the port's, given the same script, write
the same events exactly (tolerance: none), at full hop sampling, at half
(the seeded coin), under a span cap that drops spans, and with tracing
off and the straggler watch on. ``trace_phase_sums`` and
``tiling_error`` of the port's trace equal the JAX functions' on it, and
the dispatch spans tile their pass (the scripted clock's times, not a
wall-clock reading).
"""

import json
import random

import pytest

from cyclegan_tpu.obs import jsonl as jax_jsonl
from cyclegan_tpu.obs import stepclock as jax_stepclock
from cyclegan_tpu.obs import trace as jax_trace
from cyclegan_tpu.obs import train_trace as jax_train_trace
from cyclegan_tpu_torch.obs import jsonl, stepclock, trace, train_trace

from tests.test_torch_port_obs import ScriptedClock, _clock_script, _events

PORT = (train_trace, stepclock, jsonl)
JAX = (jax_train_trace, jax_stepclock, jax_jsonl)


@pytest.fixture(autouse=True)
def _point_event_clock(monkeypatch):
    """A root span's point events read the trace module's own clock: a
    fixed one here, in both packages."""
    for module in (trace, jax_trace):
        monkeypatch.setattr(module, "_now", lambda: 4321.0)


def _traced_epochs(modules, path, sample, max_spans=4096, straggler=4.0):
    """Two scripted epochs through a TrainTracer; the events written and
    the tracer's stats."""
    tt_mod, sc_mod, log_mod = modules
    log = log_mod.MetricsLogger(path, clock=ScriptedClock(21))
    clock = ScriptedClock(23, spikes={60: 2.5, 200: 3.0})
    tracer = tt_mod.TrainTracer(log, sample=sample, max_spans=max_spans,
                                straggler_multiple=straggler,
                                rng=random.Random(5))
    for epoch in range(2):
        _clock_script(sc_mod, log, clock, n=14, k=2, window=6,
                      observer=tracer, epoch=epoch)
        _clock_script(sc_mod, log, clock, n=4, split="test",
                      observer=tracer, epoch=epoch)
        tracer.note_event("service_job", {"job": "checkpoint:e0",
                                          "seconds": 0.5, "nested": {}})
        tracer.note_event("step", {"ignored": True})
        closed = tracer.close_epoch(epoch, t_end=clock())
    stats = tracer.stats()
    log.close()
    return _events(path), stats, closed


@pytest.mark.parametrize("sample,max_spans", [(1.0, 4096), (0.5, 4096),
                                              (1.0, 40)])
def test_train_traces_match_jax(tmp_path, sample, max_spans):
    ours = _traced_epochs(PORT, str(tmp_path / "p.jsonl"), sample, max_spans)
    theirs = _traced_epochs(JAX, str(tmp_path / "j.jsonl"), sample,
                            max_spans)
    assert ours == theirs
    events, stats, closed = ours
    traces = [e for e in events if e["event"] == "trace"]
    assert closed and len(traces) == 2 and stats["emitted"] == 2
    assert [t["attrs"]["epoch"] for t in traces] == [0, 1]
    stragglers = [e for e in events if e["event"] == "train_straggler"]
    assert stragglers
    for trace in traces:
        assert train_trace.trace_phase_sums(trace) == \
            jax_train_trace.trace_phase_sums(trace)
        assert train_trace.tiling_error(trace) == \
            jax_train_trace.tiling_error(trace)
        if max_spans < 4096:
            assert trace["attrs"]["spans_dropped"] > 0
            assert trace["attrs"]["tiling_complete"] is False
        else:
            assert trace["attrs"]["tiling_complete"] is True
            assert train_trace.tiling_error(trace) < 1e-6
            names = {s["name"] for s in trace["spans"]}
            assert {"train_pass", "test_pass", "dispatch", "interlude",
                    "drain"} <= names
            if sample == 1.0:
                assert {"data_wait", "submit", "resolve", "host",
                        "device"} <= names


def test_straggler_only_mode_matches_jax(tmp_path):
    """sample 0 with the straggler watch on: no traces, the same
    stragglers and blames."""
    ours = _traced_epochs(PORT, str(tmp_path / "p.jsonl"), 0.0)
    theirs = _traced_epochs(JAX, str(tmp_path / "j.jsonl"), 0.0)
    assert ours == theirs
    events, _, closed = ours
    assert not closed
    assert "trace" not in [e["event"] for e in events]
    assert [e["event"] for e in events].count("train_straggler") >= 1


class _List:
    def __init__(self):
        self.events = []

    def event(self, kind, /, **fields):
        self.events.append({"event": kind, **fields})


def test_straggler_blame_is_componentwise_as_jax():
    """Blame goes to the component with the largest excess over its own
    median (tests/test_train_trace.py's case), in both packages."""
    base = {"data_wait_s": 0.1, "fetch_block_s": 0.7,
            "dispatch_s": 0.05, "host_work_s": 0.05}
    records = ([{"wall_s": 0.9, "dispatch": i, **base} for i in range(6)]
               + [{"wall_s": 4.9, "dispatch": 6,
                   **dict(base, data_wait_s=4.1)},
                  {"wall_s": 4.9, "dispatch": 7,
                   **dict(base, fetch_block_s=4.7)},
                  {"wall_s": 4.9, "dispatch": 8,
                   **dict(base, host_work_s=4.5)}])
    out = {}
    for label, module in (("port", train_trace), ("jax", jax_train_trace)):
        log = _List()
        det = module.StragglerDetector(log, multiple=4.0)
        blames = [det.observe(r, "train", 0) for r in records]
        out[label] = (blames, det.n_stragglers, det.blames, log.events)
    assert out["port"] == out["jax"]
    assert out["port"][0][-3:] == ["data_wait", "device", "host"]
    assert train_trace.INSTANT_KINDS == jax_train_trace.INSTANT_KINDS


def test_trace_helpers_match_jax_on_a_hand_built_trace():
    trace = {"dur_s": 2.0, "spans": [
        {"id": 1, "name": "train_pass", "t0": 0.0, "t1": 1.5,
         "attrs": {"drain_s": 0.1}},
        {"id": 2, "parent": 1, "name": "dispatch", "t0": 0.0, "t1": 1.0,
         "attrs": {"fetch_block_s": 0.4, "data_wait_s": 0.2,
                   "dispatch_s": 0.1, "host_work_s": 0.3}},
        {"id": 3, "parent": 1, "name": "drain", "t0": 1.0, "t1": 1.4},
        {"id": 4, "parent": 2, "name": "device", "t0": 0.2, "t1": 1.2,
         "attrs": {"overlap": True}},
        {"id": 5, "name": "interlude", "t0": 1.5, "t1": 1.9}]}
    assert train_trace.trace_phase_sums(trace) == \
        jax_train_trace.trace_phase_sums(trace)
    assert train_trace.tiling_error(trace) == \
        jax_train_trace.tiling_error(trace)
    assert json.dumps(train_trace.trace_phase_sums(trace))
