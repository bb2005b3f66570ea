"""The training driver's pieces around the loop, on the CPU.

- ``utils/services.py`` ``EpochServices``: the four cases of
  ``tests/test_services.py`` (submission order and the barrier, a failing
  job, a job after close, the pending count).
- ``utils/preemption.py`` ``PreemptionGuard``: the single-process cases
  of ``tests/test_preemption.py`` but ``add_callback``, which the port
  leaves out (the port has one process, so ``should_stop`` is the local
  flag), and the first request's time kept.
- ``data/pipeline.py`` ``train_epoch(start_step=k)`` yields exactly
  batches k.. of the epoch, ``resil/elastic.py`` ``MidEpochBreaker``
  counts and latches (``tests/test_elastic.py``), and ``emergency_save``
  sheds the queued cycle panels and writes the ``mid_epoch`` record.
- An emergency save and its resume through the CLI's ``main``: the test's
  data iterator sends SIGTERM to this process after the second batch of
  the second epoch, the guard traps it, the run writes a ``mid_epoch``
  slot and exits cleanly; the run again resumes at that step, and its
  final state is bitwise the uninterrupted run's.
- Partial restore grafts and rejects (``tests/test_checkpoint.py``), and
  ``--expect_partial`` resumes a run whose generators gained a residual
  block.
- ``utils/profiler.py`` ``TraceCapture`` writes a trace for N = 1 and
  does nothing for N = 0; ``--trace 1`` writes one.
- ``--steps_per_dispatch 2`` through the CLI gives the K = 1 run's epoch
  means bitwise.
"""

import dataclasses
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch import main as port_main
from cyclegan_tpu_torch.config import (
    KERNEL_LAYOUT,
    Config,
    DataConfig,
    DiscriminatorConfig,
    GeneratorConfig,
    ModelConfig,
    TrainConfig,
)
from cyclegan_tpu_torch.data import pipeline
from cyclegan_tpu_torch.data.pipeline import build_data
from cyclegan_tpu_torch.resil import elastic
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer, state_digest
from cyclegan_tpu_torch.utils.preemption import PreemptionGuard
from cyclegan_tpu_torch.utils.profiler import maybe_trace
from cyclegan_tpu_torch.utils.services import EpochServices
from cyclegan_tpu_torch.utils.summary import read_scalars

TINY = Config(
    model=ModelConfig(generator=GeneratorConfig(filters=4,
                                                num_residual_blocks=1),
                      discriminator=DiscriminatorConfig(filters=4),
                      image_size=32, **KERNEL_LAYOUT),
    data=DataConfig(source="synthetic", resize_size=36, crop_size=32,
                    synthetic_train_size=8, synthetic_test_size=2),
    train=TrainConfig(batch_size=2))
# A CLI run: 4 train steps an epoch at batch 1, 2 test steps.
CLI_ARGS = ["--batch_size", "1", "--verbose", "0", "--data_source",
            "synthetic", "--image_size", "32", "--filters", "4",
            "--residual_blocks", "1", "--synthetic_train_size", "4",
            "--synthetic_test_size", "2", "--ckpt_keep", "2", "--device",
            "cpu", "--norm_impl", "pallas", "--pad_impl", "epilogue",
            "--upsample_impl", "zeroskip_fused"]


# -- EpochServices -----------------------------------------------------------

class _FakeTele:
    def __init__(self):
        self.events = []

    def event(self, kind, **kw):
        self.events.append((kind, kw))


def test_jobs_run_in_submission_order_and_barrier_waits():
    tele = _FakeTele()
    svc = EpochServices(telemetry=tele, echo=lambda *_: None)
    out = []
    gate = threading.Event()
    svc.submit("slow", lambda: (gate.wait(5), out.append("slow")))
    svc.submit("fast", out.append, "fast")
    assert svc.barrier(timeout=0.05) is False  # the slow job is gated
    gate.set()
    assert svc.barrier(timeout=10) is True
    assert out == ["slow", "fast"]
    assert [k for k, _ in tele.events] == ["service_job", "service_job"]
    assert tele.events[0][1]["job"] == "slow"
    assert tele.events[0][1]["seconds"] >= 0
    assert svc.close(timeout=10) is True


def test_job_error_recorded_and_worker_survives():
    tele = _FakeTele()
    echoed = []
    svc = EpochServices(telemetry=tele, echo=echoed.append)
    svc.submit("boom", lambda: 1 / 0)
    out = []
    svc.submit("after", out.append, 1)
    assert svc.barrier(timeout=10)
    assert out == [1]
    assert len(svc.errors) == 1 and "ZeroDivisionError" in svc.errors[0]
    assert echoed and "boom" in echoed[0]
    kinds = [k for k, _ in tele.events]
    assert "service_error" in kinds and "service_job" in kinds
    svc.close(timeout=10)


def test_submit_after_close_runs_inline():
    svc = EpochServices(echo=lambda *_: None)
    assert svc.close(timeout=10)
    out = []
    svc.submit("late", out.append, "x")
    assert out == ["x"]
    assert svc.close(timeout=10)


def test_pending_counter_tracks_queue():
    svc = EpochServices(echo=lambda *_: None)
    gate = threading.Event()
    svc.submit("hold", gate.wait, 5)
    svc.submit("next", lambda: None)
    assert svc.pending >= 1
    gate.set()
    assert svc.barrier(timeout=10)
    assert svc.pending == 0
    svc.close(timeout=10)


# -- PreemptionGuard ---------------------------------------------------------

def test_signal_sets_flag_and_runs_callbacks_in_order():
    order = []
    guard = PreemptionGuard(signals=(signal.SIGUSR1,),
                            on_signal=(lambda: order.append("first"),
                                       lambda: order.append("second")))
    try:
        assert not guard.requested_locally and not guard.should_stop()
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested_locally and guard.should_stop()
        assert guard.requested_at is not None
        assert order == ["first", "second"]
    finally:
        guard.uninstall()


def test_request_stop_keeps_the_first_request_time():
    """The grace window runs from the first notice: a second request (a
    repeated SIGTERM) does not move ``requested_at``."""
    guard = PreemptionGuard(install=False)
    assert guard.requested_at is None
    guard.request_stop()
    first = guard.requested_at
    guard.request_stop()
    assert guard.requested_at == first and guard.should_stop()


def test_broken_callback_does_not_break_shutdown_or_later_callbacks():
    seen = []

    def broken():
        raise RuntimeError("flush hook bug")

    guard = PreemptionGuard(signals=(signal.SIGUSR1,),
                            on_signal=(broken,
                                       lambda: seen.append("after-broken")))
    try:
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.requested_locally
        assert seen == ["after-broken"]
    finally:
        guard.uninstall()


def test_uninstall_restores_previous_handler():
    hits = []

    def prev_handler(signum, frame):
        hits.append(signum)

    original = signal.signal(signal.SIGUSR1, prev_handler)
    try:
        guard = PreemptionGuard(signals=(signal.SIGUSR1,))
        assert signal.getsignal(signal.SIGUSR1) == guard._handle
        guard.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is prev_handler
        os.kill(os.getpid(), signal.SIGUSR1)
        assert hits == [signal.SIGUSR1]
        assert not guard.requested_locally
        guard.uninstall()
        assert signal.getsignal(signal.SIGUSR1) is prev_handler
    finally:
        signal.signal(signal.SIGUSR1, original)


def test_install_false_traps_nothing():
    guard = PreemptionGuard(signals=(signal.SIGUSR1,), install=False)
    assert guard._prev == {}
    guard.request_stop()
    assert guard.requested_locally and guard.should_stop()
    guard.uninstall()


# -- mid-epoch data order and the breaker ------------------------------------

def test_mid_epoch_fast_forward_no_sample_skipped_or_repeated():
    data = build_data(TINY, global_batch_size=2)  # 4 steps an epoch
    full = list(data.train_epoch(3, prefetch=False))
    tail = list(data.train_epoch(3, prefetch=False, start_step=1))
    assert len(full) == data.train_steps == 4
    assert len(tail) == data.train_steps - 1
    for (xa, ya, wa), (xb, yb, wb) in zip(full[1:], tail):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
        np.testing.assert_array_equal(wa, wb)


def test_breaker_latches_on_local_request():
    guard = PreemptionGuard(install=False)
    br = elastic.MidEpochBreaker(guard)
    br.note(2)
    assert not br.should_break()
    guard.request_stop()
    assert br.should_break()
    guard._requested = False  # the latch survives the flag's churn
    assert br.should_break() and br.batches_done == 2


def test_emergency_save_sheds_cycle_panels_and_records_mid_epoch(tmp_path):
    """The queued ``plot_cycle:`` job is dropped, the one ahead of it runs,
    and the slot's meta holds the position of the first batch not
    trained."""
    config = dataclasses.replace(
        TINY, train=dataclasses.replace(TINY.train, preempt_deadline_s=30.0))
    state = create_state(config, device="cpu")
    data = build_data(config, global_batch_size=2)
    guard = PreemptionGuard(install=False)
    guard.request_stop()
    ckpt = Checkpointer(str(tmp_path), keep=2)
    svc = EpochServices(echo=lambda *_: None)
    ran, echoed = [], []
    gate = threading.Event()
    svc.submit("hold", lambda: (gate.wait(5), ran.append("hold")))
    svc.submit("plot_cycle:epoch_1", ran.append, "plot")
    threading.Timer(0.2, gate.set).start()
    elastic.emergency_save(ckpt, state, config, data, 1, 3, guard,
                           services=svc, echo=echoed.append)
    assert svc.close(timeout=10)
    assert ran == ["hold"]
    assert "1 queued job(s) shed" in echoed[0]
    assert ckpt.read_meta()["mid_epoch"] == {"epoch": 1, "step": 3,
                                             "data_seed": data.seed}


# -- emergency save and resume through the CLI -------------------------------

def _slot_digest(out):
    ckpt = Checkpointer(out, keep=2)
    _, slot = ckpt.slots()[0]
    return ckpt.read_manifest(slot)["state_sha256"], ckpt.read_meta()


def test_emergency_save_and_resume_through_main(tmp_path, monkeypatch,
                                                capsys):
    args = CLI_ARGS + ["--epochs", "2", "--preempt_deadline_s", "5"]
    whole = str(tmp_path / "whole")
    port_main.main(["--output_dir", whole] + args)
    want, _ = _slot_digest(whole)

    cut = str(tmp_path / "cut")
    real = pipeline.CycleGANData.train_epoch

    def train_epoch(self, epoch, prefetch=True, start_step=0):
        for i, batch in enumerate(real(self, epoch, prefetch, start_step)):
            yield batch
            if epoch == 1 and i == 1:
                os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(pipeline.CycleGANData, "train_epoch", train_epoch)
    capsys.readouterr()
    port_main.main(["--output_dir", cut] + args)
    printed = capsys.readouterr().out
    monkeypatch.undo()
    assert "preemption requested: checkpointed, exiting cleanly" in printed
    assert "emergency save: epoch 1 step" in printed
    _, meta = _slot_digest(cut)
    mid = meta["mid_epoch"]
    assert mid["epoch"] == meta["epoch"] == 1 and 1 <= mid["step"] <= 3
    assert mid["data_seed"] == 1234

    port_main.main(["--output_dir", cut] + args)
    printed = capsys.readouterr().out
    assert (f"Resumed from {os.path.join(cut, 'checkpoints')}"
            in printed and f"at epoch 1, step {mid['step']}" in printed)
    got, meta = _slot_digest(cut)
    assert "mid_epoch" not in meta and meta["epoch"] == 1
    assert got == want


# -- partial restore ---------------------------------------------------------

def _wider_discriminators(config):
    return config.replace(model=dataclasses.replace(
        config.model, discriminator=DiscriminatorConfig(filters=8)))


def test_partial_restore_grafts_matching_leaves(tmp_path):
    state = create_state(TINY, 0, device="cpu")
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state, epoch=3)
    template = create_state(_wider_discriminators(TINY), 9, device="cpu")
    init_dx = {k: v.clone() for k, v in template.dx.state_dict().items()}

    with pytest.raises(Exception):
        ckpt.restore(template)
    template = create_state(_wider_discriminators(TINY), 9, device="cpu")
    restored, next_epoch = ckpt.restore(template, partial=True)
    assert next_epoch == 4
    for ours, theirs in ((restored.g, state.g), (restored.f, state.f)):
        for (k, a), (_, b) in zip(ours.state_dict().items(),
                                  theirs.state_dict().items()):
            assert torch.equal(a, b), k
    dx = restored.dx.state_dict()
    assert all(torch.equal(dx[k], v) for k, v in init_dx.items())

    same = create_state(TINY, 9, device="cpu")
    full, _ = ckpt.restore(same, partial=True)
    assert state_digest(full) == state_digest(state)


def test_partial_restore_rejects_total_param_mismatch(tmp_path):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(create_state(TINY, 0, device="cpu"), epoch=0)
    wider = _wider_discriminators(TINY)
    wider = wider.replace(model=dataclasses.replace(
        wider.model, generator=GeneratorConfig(filters=8,
                                               num_residual_blocks=1)))
    with pytest.raises(ValueError, match="wrong checkpoint"):
        ckpt.restore(create_state(wider, 1, device="cpu"), partial=True)


def test_expect_partial_resumes_a_deeper_generator(tmp_path, capsys):
    out = str(tmp_path / "run")
    args = ["--output_dir", out] + CLI_ARGS
    port_main.main(args + ["--epochs", "1"])
    deeper = [a if a != "1" or args[i - 1] != "--residual_blocks" else "2"
              for i, a in enumerate(args)]
    with pytest.raises(Exception):
        port_main.main(deeper + ["--epochs", "2"])
    capsys.readouterr()
    port_main.main(deeper + ["--epochs", "2", "--expect_partial"])
    printed = capsys.readouterr().out
    assert "partial restore: " in printed and "kept from init" in printed
    assert "at epoch 1" in printed and "Epoch 002/002" in printed


# -- tracing -----------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1])
def test_trace_capture_writes_a_trace_only_when_asked(tmp_path, n):
    tracer = maybe_trace(str(tmp_path), n)
    x = torch.ones(8)
    for _ in range(4):
        tracer.step()
        x = x * 2
    tracer.stop()
    traces = tmp_path / "traces"
    if n == 0:
        assert tracer.path is None and not traces.exists()
        return
    assert tracer.path is not None and os.path.dirname(tracer.path) == str(
        traces)
    with open(tracer.path) as f:
        assert json.load(f)["traceEvents"]


def test_trace_flag_writes_a_trace(tmp_path):
    out = str(tmp_path / "run")
    port_main.main(["--output_dir", out, "--epochs", "1", "--trace", "1"]
                   + CLI_ARGS)
    names = os.listdir(os.path.join(out, "traces"))
    assert len(names) == 1 and names[0].endswith(".json")


# -- several steps a dispatch through the CLI --------------------------------

def test_steps_per_dispatch_2_gives_the_k1_epoch_means(tmp_path):
    means = {}
    for k in (1, 2):
        out = str(tmp_path / f"k{k}")
        # 5 train steps an epoch: two dispatches of 2 and a remainder.
        port_main.main(["--output_dir", out, "--epochs", "2",
                        "--steps_per_dispatch", str(k)] + CLI_ARGS
                       + ["--synthetic_train_size", "5"])
        means[k] = {tag: rows for tag, rows in read_scalars(out).items()
                    if tag.startswith(("loss_", "health/"))}
    assert means[1] and means[1] == means[2]
