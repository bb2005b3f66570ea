"""The port's run telemetry (cyclegan_tpu_torch/obs/) against the JAX
package's, on the CPU.

The forked classes — ``MetricsLogger``, ``StepClock``, ``GoodputLedger``,
``StallWatchdog`` — are driven through the JAX object and the port's by
the same scripted call sequence and the same injected clock; the parsed
events are equal exactly (tolerance: none). The scripts are numpy-seeded
and every timestamp comes from the scripted clock, so no test here reads
a wall-clock ratio.

Then the loop: the JAX ``train_epoch``/``test_epoch`` with a ``Telemetry``
and the port's with ``device="cpu"`` (image 32, filters 8, 2 residual
blocks, batch 1, on the same SyntheticSource data from the same signal
weights) at K = 1, K = 2 and ``grad_accum=2`` write the same sequence of
event kinds, the same keys per kind and the same step/dispatch counts,
epochs and splits; the ``step_losses`` values agree within the loop parity
test's tolerance (tests/test_torch_port_epochs.py, rtol 1e-3, atol 1e-5).
The JAX side runs its main.py's default layout, which computes the port's
function without interpret-mode Pallas.

The CLI writes ``telemetry.jsonl`` by default and none with ``--no_obs`` or
``--obs_jsonl none``; ``tools/obs_report.py`` folds it with the sections
the JAX stream gets, and with ``--train_trace_sample 1`` so do
``tools/trace_timeline.py`` and ``tools/goodput_timeline.py``. The one
kind the report does not fold is ``step_losses``, which the JAX loop
writes too (``tools/run_compare.py`` reads it).

The deferred fetch: its rows and their order are those of the parent's
``.cpu()`` fetch, and with a stub event the fetch of dispatch i waits on
dispatch i's event and no other. Last, a static no-sync guard over the
loop, ``obs/`` and the epoch services, with a planted violation.
"""

import ast
import contextlib
import functools
import io
import json
import os
import shutil
import signal
import sys
import time

import jax
import numpy as np
import pytest
import torch

from cyclegan_tpu import config as jc
from cyclegan_tpu.data.pipeline import CycleGANData as JaxData
from cyclegan_tpu.domains import transfer as jax_transfer
from cyclegan_tpu.obs import goodput as jax_goodput
from cyclegan_tpu.obs import health as jax_health
from cyclegan_tpu.obs import jsonl as jax_jsonl
from cyclegan_tpu.obs import manifest as jax_manifest
from cyclegan_tpu.obs import memory as jax_memory
from cyclegan_tpu.obs import stepclock as jax_stepclock
from cyclegan_tpu.obs import telemetry as jax_telemetry
from cyclegan_tpu.obs import watchdog as jax_watchdog
from cyclegan_tpu.parallel import (
    make_mesh_plan,
    shard_multi_train_step,
    shard_test_step,
    shard_train_step,
)
from cyclegan_tpu.parallel.dp import shard_accum_train_step
from cyclegan_tpu.parallel.mesh import replicated
from cyclegan_tpu.train import loop as jax_loop
from cyclegan_tpu.train.state import create_state as jax_create_state
from cyclegan_tpu.train.steps import make_accum_train_step as jax_accum_step
from cyclegan_tpu.train.steps import make_test_step as jax_test_step
from cyclegan_tpu.train.steps import make_train_step as jax_train_step
from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch import main as port_main
from cyclegan_tpu_torch.convert import (
    signal_discriminator_flax_params,
    signal_flax_params,
    state_from_flax,
)
from cyclegan_tpu_torch.data.pipeline import CycleGANData
from cyclegan_tpu_torch.domains import transfer
from cyclegan_tpu_torch.obs import goodput, health, jsonl, manifest, memory
from cyclegan_tpu_torch.obs import stepclock, telemetry, watchdog
from cyclegan_tpu_torch.train import loop
from cyclegan_tpu_torch.train.multistep import make_multi_train_step
from cyclegan_tpu_torch.train.steps import (
    make_accum_train_step,
    make_test_step,
    make_train_step,
)
from cyclegan_tpu_torch.utils.preemption import PreemptionGuard

from tests.test_torch_port_train import _numpy_state, _with_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


class ScriptedClock:
    """A clock whose every read moves on by the next of a numpy-seeded
    draw of increments; ``spikes`` maps a read's index to a long one."""

    def __init__(self, seed, n=4000, spikes=None):
        rng = np.random.default_rng(seed)
        self.steps = [round(float(v), 6) for v in rng.uniform(1e-4, 2e-2, n)]
        for i, v in (spikes or {}).items():
            self.steps[i] = v
        self.i = 0
        self.t = 1000.0

    def __call__(self):
        self.t = round(self.t + self.steps[self.i], 6)
        self.i += 1
        return self.t


# ---------------------------------------------------------------- JSONL


def _log_script(module, path, clock):
    log = module.MetricsLogger(path, clock=clock)
    log.event("manifest", schema_version=module.EVENT_SCHEMA_VERSION)
    log.event("step", kind="multi", x=np.float32(1.5), arr=np.arange(3))
    log.event("odd", obj=ScriptedClock)
    log.event("bad", value=float("nan"), nested={"a": [1, 2, {"b": None}]})
    log.flush()
    log.close()
    log.event("after_close", x=1)
    return log.n_events


def test_metrics_logger_matches_jax(tmp_path):
    """Same events, same envelope, same coercions (numpy scalars and
    arrays, a repr for anything else); nothing after close."""
    ours = _log_script(jsonl, str(tmp_path / "a" / "p.jsonl"),
                       ScriptedClock(1))
    theirs = _log_script(jax_jsonl, str(tmp_path / "b" / "j.jsonl"),
                         ScriptedClock(1))
    assert ours == theirs == 4
    assert jsonl.EVENT_SCHEMA_VERSION == jax_jsonl.EVENT_SCHEMA_VERSION
    got = open(tmp_path / "a" / "p.jsonl").read()
    want = open(tmp_path / "b" / "j.jsonl").read()
    assert got == want
    assert [e["event"] for e in _events(tmp_path / "a" / "p.jsonl")] == [
        "manifest", "step", "odd", "bad"]


def test_metrics_logger_appends_and_null_logger_is_silent(tmp_path):
    path = str(tmp_path / "t.jsonl")
    for _ in range(2):  # a resumed run extends the same stream
        log = jsonl.MetricsLogger(path)
        log.event("e", k=1)
        log.close()
    assert len(_events(path)) == 2
    null = jsonl.NullMetricsLogger(str(tmp_path / "none.jsonl"))
    null.event("e", k=1)
    null.flush()
    null.close()
    assert not os.path.exists(tmp_path / "none.jsonl")


# ------------------------------------------------------------ step clock


def _clock_script(module, logger, clock, n, k=1, accum=1, window=4,
                  log_every=1, stall_multiple=10.0, observer=None,
                  on_finish=None, split="train", epoch=3):
    """A pass as the loop drives it: ``n`` dispatches, a backpressure
    fetch whenever more than ``window`` pinned batches are pending (the
    two clock reads around it are the loop's), the drain and finish."""
    beats = []
    sc = module.StepClock(logger, epoch, split=split, log_every=log_every,
                          heartbeat=lambda: beats.append(1), clock=clock,
                          stall_multiple=stall_multiple, observer=observer,
                          on_finish=on_finish)
    pending = []
    for i in range(n):
        sc.stage_begin()
        sc.staged()
        if k > 1 and i < n - 1:
            sc.dispatched(steps=k, kind="multi")
            pending.append((k, k))
        elif accum > 1:
            sc.dispatched(steps=1, pinned=accum, kind="accum")
            pending.append((1, accum))
        else:
            sc.dispatched(kind="single")
            pending.append((1, 1))
        while sum(p for _, p in pending) > window:
            steps, pinned = pending.pop(0)
            t0 = clock()
            t1 = clock()
            sc.fetched(t1 - t0, steps=steps, pinned=pinned, at=t1)
    sc.stage_begin()
    t0 = clock()
    t1 = clock()
    sc.drained(t1 - t0, n_entries=len(pending), at=t1)
    agg = sc.finish()
    return agg, len(beats), sc.depth


SCRIPTS = {
    "single": dict(n=12),
    "multi": dict(n=7, k=3),
    "accum": dict(n=9, accum=2),
    "log_every_3": dict(n=10, log_every=3),
    "aggregates_only": dict(n=6, log_every=0),
    "no_stall_detector": dict(n=12, stall_multiple=0.0),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_step_clock_matches_jax(tmp_path, name):
    """Same step records, loop_stall events and epoch_steps aggregate; a
    long read at the ninth dispatch trips the loop_stall detector."""
    out = {}
    for label, module, log_module in (("port", stepclock, jsonl),
                                      ("jax", jax_stepclock, jax_jsonl)):
        path = str(tmp_path / f"{label}.jsonl")
        log = log_module.MetricsLogger(path, clock=ScriptedClock(5))
        res = _clock_script(module, log, ScriptedClock(7, spikes={40: 3.0}),
                            **SCRIPTS[name])
        log.close()
        out[label] = (res, _events(path))
    assert out["port"] == out["jax"]
    (agg, beats, depth), evs = out["port"]
    assert depth == 0 and beats > 0
    assert evs[-1]["event"] == "epoch_steps"
    assert agg["n_dispatches"] == SCRIPTS[name]["n"]
    if name == "single":
        assert [e["event"] for e in evs].count("loop_stall") >= 1


def test_null_step_clock_has_the_surface():
    clock = telemetry.NULL_TELEMETRY.step_clock(0)
    clock.stage_begin(); clock.staged(); clock.dispatched(steps=2, kind="multi")
    clock.fetched(0.0, steps=2, pinned=2, at=1.0); clock.drained(0.0, at=1.0)
    assert clock.finish() == {} and clock.depth == 0


# ------------------------------------------------------------ goodput


def test_goodput_ledger_matches_jax(tmp_path):
    """Two passes' aggregates and service seconds into one epoch rollup,
    then a second window: the same payloads, phases summing to elapse."""
    rollups = {}
    for label, sc_mod, gp_mod, log_mod in (
            ("port", stepclock, goodput, jsonl),
            ("jax", jax_stepclock, jax_goodput, jax_jsonl)):
        ledger = gp_mod.GoodputLedger()
        log = log_mod.NullMetricsLogger()
        clock = ScriptedClock(11)
        _clock_script(sc_mod, log, clock, n=9, k=2,
                      on_finish=ledger.note_pass)
        _clock_script(sc_mod, log, clock, n=3, split="test",
                      on_finish=ledger.note_pass)
        ledger.note_service(0.25)
        ledger.note_service("not a number")
        first = ledger.rollup(0, 1.5)
        second = ledger.rollup(1, 1.0)
        ledger.note_service(0.1)
        third = ledger.rollup(2, 0.05)
        rollups[label] = (first, second, third,
                          gp_mod.classify_pass({"wall_s": 1.0,
                                                "n_dispatches": 1,
                                                "dispatch0_s": 0.4,
                                                "dispatch_s": 0.4}))
    assert rollups["port"] == rollups["jax"]
    first, second, third, _ = rollups["port"]
    assert second is None and first["comms_s_per_step"] == 0.0
    assert abs(sum(first["phases_s"].values()) - first["elapse_s"]) < 1e-5
    assert third["phases_s"]["services"] == 0.05
    assert goodput.PHASES == jax_goodput.PHASES
    assert goodput.BADPUT_PHASES == jax_goodput.BADPUT_PHASES


# ------------------------------------------------------------- watchdog


class _Ticks:
    """A stand-in for the module's ``time``: monotonic reads from a list."""

    def __init__(self, values):
        self.values = list(values)

    def monotonic(self):
        return self.values.pop(0)


class _Polls:
    """The watchdog's stop event: its wait() says "not stopped" n times."""

    def __init__(self, n):
        self.n = n

    def wait(self, timeout):
        self.n -= 1
        return self.n < 0

    def set(self):
        self.n = -1


def test_stall_watchdog_matches_jax(tmp_path, monkeypatch, capsys):
    """The watchdog's poll loop run inline on scripted monotonic reads: a
    stall fires once, re-arms after a beat, fires again; same events."""
    # Built and beaten at 0; polls at 1 (ok), 5 (stall), 6 (the same
    # episode); a beat at 7; polls at 8 (ok) and 20 (a second stall).
    ticks = [0.0, 0.0, 1.0, 5.0, 6.0, 7.0, 8.0, 20.0]
    out = {}
    for label, module, log_module in (("port", watchdog, jsonl),
                                      ("jax", jax_watchdog, jax_jsonl)):
        monkeypatch.setattr(module, "time", _Ticks(ticks))
        path = str(tmp_path / f"{label}.jsonl")
        log = log_module.MetricsLogger(path, clock=ScriptedClock(3))
        wd = module.StallWatchdog(log, deadline_s=2.0, poll_s=0.01,
                                  depth_fn=lambda: 7, echo=True)
        wd.beat()
        wd._stop = _Polls(3)
        wd._run()
        wd.beat()
        wd._stop = _Polls(2)
        wd._run()
        log.close()
        out[label] = (wd.n_stalls, _events(path), capsys.readouterr().err)
    assert out["port"] == out["jax"]
    n, evs, err = out["port"]
    assert n == 2 and [e["age_s"] for e in evs] == [5.0, 13.0]
    assert evs[0]["pending_depth"] == 7 and "device hang" in err


def test_watchdog_thread_stops_when_telemetry_closes(tmp_path):
    tele = telemetry.make_telemetry(
        pc.ObsConfig(watchdog_deadline_s=30.0), str(tmp_path))
    thread = tele.watchdog._thread
    assert thread is not None and thread.is_alive() and thread.daemon
    clock = tele.step_clock(0)
    clock.stage_begin(); clock.staged(); clock.dispatched(steps=2, pinned=2)
    assert tele.watchdog._depth_fn() == 2
    tele.close()
    assert not thread.is_alive() and tele.watchdog._thread is None
    end = _events(tele.logger.path)[-1]
    assert (end["event"], end["status"]) == ("end", "completed")


# ------------------------------------------------- telemetry and manifest


def test_make_telemetry_paths_match_jax(tmp_path):
    out = str(tmp_path / "run")
    for cfg in (pc.ObsConfig(enabled=False), pc.ObsConfig(jsonl_path="none"),
                pc.ObsConfig(jsonl_path="off")):
        assert telemetry.make_telemetry(cfg, out) is telemetry.NULL_TELEMETRY
    assert telemetry.make_telemetry(pc.ObsConfig(), out, primary=False) \
        is telemetry.NULL_TELEMETRY
    assert not os.path.exists(out)
    tele = telemetry.make_telemetry(pc.ObsConfig(), out)
    theirs = jax_telemetry.make_telemetry(
        jc.ObsConfig(jsonl_path=str(tmp_path / "j.jsonl")), out)
    try:
        assert tele.logger.path == os.path.join(out, "telemetry.jsonl")
        assert tele.watchdog is None and theirs.watchdog is None
        # straggler_multiple 4.0 by default: the tracer runs, traces off.
        assert tele.train_tracer.straggler_multiple == 4.0
        assert tele.train_tracer.sample == 0.0
        assert tele.step_log_every == theirs.step_log_every == 1
        assert tele.stall_multiple == theirs.stall_multiple == 10.0
    finally:
        tele.close()
        theirs.close()
    null = telemetry.NULL_TELEMETRY
    null.manifest(None); null.epoch(0, elapse_s=1.0); null.memory(0)
    null.event("x"); null.flush(); null.close()
    assert not null.enabled


def test_manifest_fields_are_the_jax_manifests():
    config = pc.Config()
    ours = manifest.build_manifest(config, device=torch.device("cpu"),
                                   role="train")
    theirs = jax_manifest.build_manifest(jc.Config(), role="train")
    assert set(ours) == set(theirs)
    assert set(ours["mesh"]) == {"n_devices", "n_data", "n_spatial",
                                 "platform", "device_kind"}
    assert set(ours["mesh"]) <= set(theirs["mesh"]) | {"n_data", "n_spatial"}
    assert ours["mesh"]["platform"] == "cpu"
    assert ours["host"] == {"process_index": 0, "process_count": 1,
                            "local_device_count": 1}
    assert set(ours["host"]) == set(theirs["host"])
    assert {"torch", "cuda", "python", "numpy"} == set(ours["versions"])
    offline = manifest.build_manifest(config, query_devices=False,
                                      role="serve")
    assert set(offline) == set(jax_manifest.build_manifest(
        jc.Config(), query_devices=False, role="serve"))
    assert "mesh" not in offline and "host" not in offline
    json.dumps(ours)


def test_memory_watermarks_on_the_cpu():
    ours = memory.memory_watermarks([torch.device("cpu")])
    assert ours == {"available": False, "devices": [{"id": 0, "kind": "cpu"}]}
    theirs = jax_memory.memory_watermarks(jax.devices()[:1])
    assert set(ours) == set(theirs)
    assert theirs["available"] is False
    assert set(ours["devices"][0]) == set(theirs["devices"][0])


def test_preemption_flushes_the_telemetry_tail(tmp_path):
    path = str(tmp_path / "t.jsonl")
    log = jsonl.MetricsLogger(path)
    guard = PreemptionGuard(signals=(signal.SIGUSR1,), on_signal=(log.flush,))
    try:
        log.event("before_sigterm", x=1)
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert [e["event"] for e in _events(path)] == ["before_sigterm"]
    finally:
        guard.uninstall()
        log.close()


class _Recording:
    """A telemetry sink that keeps (kind, fields) and counts flushes."""

    def __init__(self):
        self.events, self.flushes = [], 0

    def event(self, kind, /, **fields):
        self.events.append((kind, fields))

    def flush(self):
        self.flushes += 1


def test_health_events_match_jax():
    """The monitor's health_fault and health events, and the fault flush,
    on the same rows (tests/test_torch_port_health.py's)."""
    from tests.test_torch_port_health import _healthy_row, _rows

    out = {}
    for label, module in (("port", health), ("jax", jax_health)):
        sink = _Recording()
        mon = module.HealthMonitor(telemetry=sink, collapse_patience=5)
        for epoch, rows in enumerate(_rows()):
            mon.begin_epoch(epoch)
            for row in rows:
                mon.observe(row)
            mon.epoch_rollup(epoch)
        halting = module.HealthMonitor(telemetry=sink, on_nan="halt")
        with pytest.raises(module.HealthFault):
            halting.observe(_healthy_row(**{"health/nonfinite": 3.0}))
        out[label] = (json.dumps(sink.events, sort_keys=True), sink.flushes)
    assert out["port"] == out["jax"]
    kinds = [k for k, _ in json.loads(out["port"][0])]
    assert kinds.count("health") == 2 and out["port"][1] == 1


def test_domain_events_match_jax():
    out = {}
    for label, module in (("port", transfer), ("jax", jax_transfer)):
        sink = _Recording()
        assert module.check_domain_compat({"domain": "a"}, "a", False,
                                          telemetry=sink)
        assert not module.check_domain_compat({"domain": "a"}, "b", False,
                                              context="resume",
                                              telemetry=sink)
        with pytest.raises(ValueError):
            module.check_domain_compat({}, "b", True, telemetry=sink)
        out[label] = sink.events
    assert out["port"] == out["jax"] and len(out["port"]) == 2


# ---------------------------------------------------- the loop's stream

GEN = dict(filters=8, num_residual_blocks=2)
DATA = dict(source="synthetic", resize_size=36, crop_size=32,
            synthetic_train_size=5, synthetic_test_size=2)
LOSS_TOL = dict(rtol=1e-3, atol=1e-5)
VARIANTS = {"K1": dict(), "K2": dict(steps_per_dispatch=2),
            "accum2": dict(grad_accum=2)}


def _configs(variant):
    train = dict(batch_size=1, seed=11, verbose=0, **VARIANTS[variant])
    jax_config = jc.Config(
        model=jc.ModelConfig(generator=jc.GeneratorConfig(**GEN),
                             discriminator=jc.DiscriminatorConfig(filters=8),
                             image_size=32, pad_impl="pad",
                             instance_norm_impl="auto", upsample_impl="dense"),
        data=jc.DataConfig(**DATA), train=jc.TrainConfig(**train),
        obs=jc.ObsConfig(health=False))
    config = pc.Config(
        model=pc.ModelConfig(generator=pc.GeneratorConfig(**GEN),
                             discriminator=pc.DiscriminatorConfig(filters=8),
                             image_size=32, **pc.KERNEL_LAYOUT),
        data=pc.DataConfig(**DATA), train=pc.TrainConfig(**train),
        obs=pc.ObsConfig(health=False))
    return jax_config, config


def _signal_state(jax_config, config):
    init = jax_create_state(jax_config, jax.random.PRNGKey(0))
    g, d = config.model.generator, config.model.discriminator
    return _with_params(init, {
        "g": signal_flax_params(g, 1), "f": signal_flax_params(g, 2),
        "dx": signal_discriminator_flax_params(d, 3),
        "dy": signal_discriminator_flax_params(d, 4)})


class _Null:
    def scalar(self, *a, **k):
        pass


def _stream(tmp_path, label, run):
    path = str(tmp_path / f"{label}.jsonl")
    tele = (telemetry if label == "port" else jax_telemetry).make_telemetry(
        (pc if label == "port" else jc).ObsConfig(jsonl_path=path),
        str(tmp_path))
    run(tele)
    tele.close()
    return _events(path)


@functools.lru_cache(maxsize=None)
def _jax_programs():
    """The JAX single train step and test step, compiled once for the
    three variants (steps_per_dispatch does not enter them)."""
    jax_config, _ = _configs("K1")
    plan = make_mesh_plan(devices=jax.devices()[:1])
    one = jax_train_step(jax_config, 1, plan)
    return plan, one, shard_train_step(plan, one), shard_test_step(
        plan, jax_test_step(jax_config, 1, plan))


def _loop_streams(variant, tmp):
    jax_config, config = _configs(variant)
    accum = config.train.grad_accum
    k = config.train.steps_per_dispatch
    gb = accum
    jax_state = _signal_state(jax_config, config)
    port_state = state_from_flax(_numpy_state(jax_state), config, "cpu")

    def port(tele):
        data = CycleGANData(config, gb, test_batch_size=1)
        step = (make_accum_train_step(config, gb, accum) if accum > 1
                else make_train_step(config, gb))
        multi = make_multi_train_step(step, k) if k > 1 else None
        state = loop.train_epoch(config, data, step, port_state, _Null(), 0,
                                 multi_step_fn=multi, obs=tele)
        loop.test_epoch(config, data, make_test_step(config, 1), state,
                        _Null(), 0, obs=tele)

    def theirs(tele):
        plan, one, step, test_step = _jax_programs()
        data = JaxData(jax_config, gb, test_batch_size=1)
        multi = shard_multi_train_step(plan, one, k) if k > 1 else None
        if accum > 1:
            step = shard_accum_train_step(plan, jax_accum_step(
                jax_config, gb, accum, plan))
        state = jax.device_put(jax_state, replicated(plan))
        state = jax_loop.train_epoch(jax_config, data, plan, step, state,
                                     _Null(), 0, multi_step_fn=multi,
                                     obs=tele)
        jax_loop.test_epoch(jax_config, data, plan, test_step, state,
                            _Null(), 0, obs=tele)

    return (_stream(tmp, "port", port), _stream(tmp, "jax", theirs))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_loop_stream_matches_jax(tmp_path_factory, variant):
    ours, theirs = _loop_streams(variant, tmp_path_factory.mktemp(variant))
    assert [e["event"] for e in ours] == [e["event"] for e in theirs]
    for a, b in zip(ours, theirs):
        assert set(a) == set(b), a["event"]
        if a["event"] == "step":
            fields = ("split", "epoch", "dispatch", "steps", "kind", "depth")
            assert [a[f] for f in fields] == [b[f] for f in fields]
        elif a["event"] == "epoch_steps":
            fields = ("split", "epoch", "n_dispatches", "n_steps",
                      "n_loop_stalls")
            assert [a[f] for f in fields] == [b[f] for f in fields]
        elif a["event"] == "step_losses":
            assert (a["epoch"], a["start_step"], a["n_steps"]) == (
                b["epoch"], b["start_step"], b["n_steps"])
            for key in a:
                if key.startswith("loss_"):
                    np.testing.assert_allclose(a[key], b[key], **LOSS_TOL,
                                               err_msg=key)
    kinds = {e["kind"] for e in ours if e["event"] == "step"
             and e["split"] == "train"}
    want = {"K1": {"single"}, "K2": {"multi", "single"},
            "accum2": {"accum"}}[variant]
    assert kinds == want
    steps = [e for e in ours if e["event"] == "epoch_steps"]
    accum = VARIANTS[variant].get("grad_accum", 1)
    assert [(e["split"], e["n_steps"]) for e in steps] == [
        ("train", -(-5 // accum)), ("test", 2)]


# ------------------------------------------------------------ the CLI

CLI_ARGS = ["--epochs", "2", "--batch_size", "1", "--verbose", "0",
            "--data_source", "synthetic", "--image_size", "32", "--filters",
            "4", "--residual_blocks", "1", "--synthetic_train_size", "3",
            "--synthetic_test_size", "2", "--device", "cpu", "--norm_impl",
            "pallas", "--pad_impl", "epilogue", "--upsample_impl",
            "zeroskip_fused"]


def _cli(out, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        port_main.main(["--output_dir", str(out)] + CLI_ARGS + list(extra))
    return buf.getvalue()


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli")
    _cli(out, "--train_trace_sample", "1")
    return str(out)


def test_cli_writes_the_stream_by_default_and_obs_report_folds_it(cli_run):
    from obs_report import fold, load_events, render

    path = os.path.join(cli_run, "telemetry.jsonl")
    events, skipped = load_events(path)
    assert skipped == 0
    kinds = [e["event"] for e in events]
    assert kinds[0] == "manifest" and kinds[-1] == "end"
    assert events[-1]["status"] == "completed"
    assert events[0]["mesh"]["platform"] == "cpu"
    for kind, n in (("epoch", 2), ("goodput", 2), ("memory", 2),
                    ("health", 2), ("trace", 2), ("step_losses", 2),
                    ("epoch_steps", 4), ("service_job", 4)):
        assert kinds.count(kind) == n, kind
    assert kinds.count("step") == 2 * (3 + 2)
    report = fold(events, skipped)
    # The JAX loop's step_losses is the one kind the report leaves out.
    assert report["unknown_kinds"] == {"step_losses": 2}
    text = render(report)
    for section in ("-- epochs --", "-- train loop, epoch 0 --",
                    "-- test loop, epoch 1 --", "-- memory watermarks --",
                    "-- goodput ledger (2 epoch rollups", "-- model health",
                    "-- training traces (2 epoch trace(s)) --",
                    "run end: completed"):
        assert section in text, section


def test_cli_stream_folds_in_the_timeline_tools(cli_run, tmp_path, capsys):
    import goodput_timeline
    import trace_timeline

    path = os.path.join(cli_run, "telemetry.jsonl")
    assert trace_timeline.main([path, "--out", str(tmp_path / "t.json")]) == 0
    timeline = json.loads(open(tmp_path / "t.json").read())
    assert timeline["traceEvents"]
    assert goodput_timeline.main([path]) == 0
    assert "run goodput fraction" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["--no_obs"], ["--obs_jsonl", "none"]])
def test_cli_without_the_stream_writes_none(tmp_path, flags):
    _cli(tmp_path, "--epochs", "1", *flags)
    assert not os.path.exists(tmp_path / "telemetry.jsonl")
    assert os.path.isdir(tmp_path / "checkpoints")


def test_cli_obs_jsonl_path_and_the_obs_flags(tmp_path):
    path = tmp_path / "elsewhere" / "t.jsonl"
    _cli(tmp_path / "run", "--epochs", "1", "--obs_jsonl", str(path),
         "--obs_step_log_every", "0", "--obs_memory_every", "0",
         "--watchdog_deadline", "60", "--obs_stall_multiple", "0",
         "--obs_straggler_multiple", "0")
    kinds = [e["event"] for e in _events(path)]
    assert "step" not in kinds and "memory" not in kinds
    assert kinds.count("epoch_steps") == 2 and kinds[-1] == "end"
    assert not os.path.exists(tmp_path / "run" / "telemetry.jsonl")
    args = port_main.build_parser().parse_args([])
    assert (args.obs_jsonl, args.no_obs, args.watchdog_deadline,
            args.obs_step_log_every, args.obs_memory_every,
            args.obs_stall_multiple, args.train_trace_sample,
            args.obs_straggler_multiple) == (None, False, 0.0, 1, 1, 10.0,
                                             0.0, 4.0)


def test_cli_sigterm_stream_ends_preempted(tmp_path, monkeypatch):
    """A SIGTERM under --preempt_deadline_s: the stream holds the
    emergency save's event with the JAX event's fields, then `preempted`,
    and ends with status "preempted"."""
    from cyclegan_tpu_torch.data import pipeline

    real = pipeline.CycleGANData.train_epoch

    def train_epoch(self, epoch, prefetch=True, start_step=0):
        for i, batch in enumerate(real(self, epoch, prefetch, start_step)):
            yield batch
            if epoch == 1 and i == 1:
                os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(pipeline.CycleGANData, "train_epoch", train_epoch)
    _cli(tmp_path, "--preempt_deadline_s", "60")
    events = _events(tmp_path / "telemetry.jsonl")
    kinds = [e["event"] for e in events]
    (save,) = [e for e in events if e["event"] == "emergency_save"]
    assert set(save) == {"event", "t", "epoch", "step", "deadline_s",
                         "elapsed_s", "margin_s", "shed_jobs", "committed"}
    assert save["epoch"] == 1 and save["committed"] and save["deadline_s"] == 60
    assert kinds[-2:] == ["preempted", "end"]
    assert events[-1]["status"] == "preempted" and events[-2]["epoch"] == 1


# ---------------------------------------------------- the deferred fetch


class _StubEvent:
    """The event of dispatch ``i``: records each wait on it."""

    def __init__(self, i, waits):
        self.i, self.waits = i, waits

    def synchronize(self):
        self.waits.append(self.i)


def _metrics(i, k=1):
    return {"loss": torch.arange(k, dtype=torch.float32) + 10 * i,
            "acc": torch.full((k,), float(i))}


def _plan():
    """(steps, pinned) a dispatch: singles, K = 4 groups, accumulated."""
    return [(1, 1)] * 20 + [(4, 4)] * 6 + [(1, 2)] * 10 + [(1, 1)] * 5


def _parent_fetch_order(plan):
    """Which dispatches the parent's loop fetched at each append (its
    backpressure rule, unchanged by the repair)."""
    pending, order = [], []
    for i, (_, pinned) in enumerate(plan):
        pending.append((i, pinned))
        fetched = []
        while sum(p for _, p in pending) > max(loop.MAX_IN_FLIGHT, pinned):
            fetched.append(pending.pop(0)[0])
        order.append(fetched)
    return order, [i for i, _ in pending]


def test_deferred_fetch_rows_and_order_are_the_parents():
    metrics = loop._DeferredMetrics()
    want = []
    for i, (steps, pinned) in enumerate(_plan()):
        m = _metrics(i, steps)
        want += [{"loss": float(m["loss"][j]), "acc": float(i)}
                 for j in range(steps)]
        metrics.append(m, steps=steps, pinned=pinned)
    results = metrics.drain()
    assert results == {"loss": [r["loss"] for r in want],
                       "acc": [r["acc"] for r in want]}


def test_fetch_of_dispatch_i_waits_on_event_i_alone(monkeypatch):
    waits = []
    made = []

    def to_host(values):
        made.append(_StubEvent(len(made), waits))
        return values, made[-1]

    monkeypatch.setattr(loop, "_to_host", to_host)
    fetched_at = []
    clock_calls = []

    class Clock:
        def fetched(self, wait_s, steps=1, pinned=None, at=None):
            clock_calls.append(("fetched", steps, pinned))

        def drained(self, wait_s, n_entries=0, at=None):
            clock_calls.append(("drained", n_entries))

    metrics = loop._DeferredMetrics(clock=Clock())
    plan = _plan()
    for i, (steps, pinned) in enumerate(plan):
        del waits[:]
        metrics.append(_metrics(i, steps), steps=steps, pinned=pinned)
        fetched_at.append(list(waits))
    want_order, tail = _parent_fetch_order(plan)
    assert fetched_at == want_order
    assert sum(map(len, want_order)) >= 10
    del waits[:]
    metrics.drain()
    assert waits == tail
    fetches = [c for c in clock_calls if c[0] == "fetched"]
    assert fetches == [("fetched", plan[i][0], plan[i][1])
                       for group in want_order for i in group]
    assert clock_calls[-1] == ("drained", len(tail))


# --------------------------------------------------------- no-sync guard

FORBIDDEN = {"synchronize", "item", "tolist", "cpu"}
SANCTION = "sanctioned-fetch"


def _sync_violations(path, allow_sanctioned):
    """Calls of a forbidden attribute (``x.cpu()``,
    ``torch.cuda.synchronize()``, ...) in ``path``; on a line marked
    ``sanctioned-fetch`` only where ``allow_sanctioned``."""
    with open(path) as f:
        src = f.read()
    lines = src.splitlines()
    out = []
    for node in ast.walk(ast.parse(src, path)):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr in FORBIDDEN):
            if allow_sanctioned and SANCTION in lines[node.lineno - 1]:
                continue
            out.append(f"{path}:{node.lineno} .{node.func.attr}()")
    return out


def _hot_path():
    port = os.path.join(REPO, "cyclegan_tpu_torch")
    obs = sorted(os.path.join(port, "obs", n)
                 for n in os.listdir(os.path.join(port, "obs"))
                 if n.endswith(".py"))
    return ([(os.path.join(port, "train", "loop.py"), True)]
            + [(p, False) for p in obs]
            + [(os.path.join(port, "utils", "services.py"), False)])


def test_hot_path_has_no_sync():
    """The loop waits only at its two sanctioned fetches (the event of the
    oldest dispatch, and the drain); obs/ and the epoch services never."""
    files = _hot_path()
    assert len(files) >= 12
    violations = [v for path, allow in files
                  for v in _sync_violations(path, allow)]
    assert violations == []
    sanctioned = [v for v in _sync_violations(files[0][0], False)]
    assert len(sanctioned) == 2


def test_the_no_sync_guard_catches_a_planted_violation(tmp_path):
    copy = tmp_path / "loop.py"
    shutil.copy(_hot_path()[0][0], copy)
    with open(copy, "a") as f:
        f.write("\n\ndef bad(values, event):\n"
                "    event.synchronize()\n"
                "    x = values.cpu()  # sanctioned-fetch: allowed here\n"
                "    torch.cuda.synchronize()\n"
                "    return values.sum().item(), values.tolist()\n"
                "# a comment on .cpu() is fine\n"
                "S = 'values.cpu() in a string is fine'\n")
    assert len(_sync_violations(str(copy), True)) == 4
    assert len(_sync_violations(str(copy), False)) == 7
