"""The port's health metrics and monitor (obs/health.py) against the JAX
package's, on the CPU.

Device half: ``finalize_health_metrics`` on the same moments, gradients
and old and new weights (the small generator and discriminator of
tests/test_torch_port_train.py, random values from a numpy seed, a few
gradient elements made NaN and inf) gives the JAX function's values:
the moments exactly, the norms and ratios to rtol 1e-5 (f32 sums in
another order), the non-finite count exactly.

Host half: the port's ``HealthMonitor`` is a copy; fed the same rows as
the JAX package's, it raises the same faults, echoes the same lines, and
rolls up the same epoch. Then the wiring: the loop feeds it one row a
train step, the CLI prints its rollup, and ``--on_nan halt`` ends a run
whose gradients go non-finite with exit 3 and no new slot.
"""

import json
import os

import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu import config as jc
from cyclegan_tpu.obs import health as jax_health
from cyclegan_tpu.train import loop as jax_loop
from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch import main as port_main
from cyclegan_tpu_torch.convert import (
    discriminator_state_from_flax,
    generator_state_from_flax,
    signal_discriminator_flax_params,
    signal_flax_params,
)
from cyclegan_tpu_torch.data.pipeline import CycleGANData
from cyclegan_tpu_torch.obs import health
from cyclegan_tpu_torch.train import loop
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.train.steps import METRIC_KEYS, make_train_step
from cyclegan_tpu_torch.utils import summary as port_summary
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer

from tests.test_torch_port_main import ARGS
from tests.test_torch_port_train import CONFIG, _inputs

GEN = CONFIG.model.generator
DISC = CONFIG.model.discriminator
NORM_TOL = dict(rtol=1e-5, atol=1e-7)


def _flax_sets(seed):
    """Four random flat flax dicts shaped like (G, F, D_X, D_Y)."""
    rng = np.random.default_rng(seed)
    shapes = [signal_flax_params(GEN, 0), signal_flax_params(GEN, 1),
              signal_discriminator_flax_params(DISC, 2),
              signal_discriminator_flax_params(DISC, 3)]
    return [{k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in s.items()} for s in shapes]


def _port(sets):
    return tuple((generator_state_from_flax(s) if i < 2
                  else discriminator_state_from_flax(s))
                 for i, s in enumerate(sets))


def _jax_tree(flat):
    return {"params": traverse_util.unflatten_dict(flat, sep="/")}


@pytest.mark.parametrize("frozen_group", [False, True])
@pytest.mark.parametrize("poison", [False, True])
def test_finalize_matches_jax(frozen_group, poison):
    grads, old = _flax_sets(1), _flax_sets(2)
    new = [{k: v + 1e-3 * np.float32(i + 1) for k, v in s.items()}
           for i, s in enumerate(old)]
    if poison:
        grads[0]["Conv_0/kernel"].flat[3] = np.nan
        grads[3]["Conv_1/kernel"].flat[:2] = np.inf
    rng = np.random.default_rng(3)
    moments = {}
    for side, which in health.DISC_STATS:
        m1, m2 = health.moment_keys(side, which)
        mean = np.float32(rng.uniform(-1, 1))
        moments[m1], moments[m2] = mean, np.float32(mean ** 2 + 0.25)
    want = jax_health.finalize_health_metrics(
        dict(moments), *([_jax_tree(s) for s in sets]
                         for sets in (grads, old, new)),
        frozen_group=frozen_group)
    got = health.finalize_health_metrics(
        {k: torch.tensor(v) for k, v in moments.items()},
        _port(grads), _port(old), _port(new), frozen_group=frozen_group)
    assert set(got) == set(want)
    assert ("health/gnorm_enc_frozen" in got) == frozen_group
    assert not any(k.startswith(health.INTERNAL_PREFIX) for k in got)
    for k, v in want.items():
        tol = NORM_TOL if "gnorm" in k or "upd_ratio" in k else dict(rtol=0)
        np.testing.assert_allclose(got[k].item(), float(v), err_msg=k, **tol)
    assert got["health/nonfinite"].item() == (3 if poison else 0)


def test_health_off_keeps_the_ten_loss_scalars():
    w = np.ones(2, np.float32)
    _, metrics = make_train_step(CONFIG, 2)(
        create_state(CONFIG, 0, device="cpu"), *_inputs(w))
    assert set(metrics) == set(METRIC_KEYS)


def _healthy_row(**over):
    row = {"loss_G/total": 3.0, "loss_F/total": 3.0, "loss_X/loss": 0.5,
           "loss_Y/loss": 0.5, "health/nonfinite": 0.0}
    for net in health.NETWORKS:
        row[f"health/gnorm_{net}"] = 1.0
        row[f"health/upd_ratio_{net}"] = 1e-3
    for side in ("dX", "dY"):
        row[f"health/{side}_real_mean"] = 0.6
        row[f"health/{side}_fake_mean"] = 0.4
        row[f"health/{side}_real_std"] = 0.2
        row[f"health/{side}_fake_std"] = 0.2
    row.update(over)
    return row


def _rows():
    """Two epochs: a warm-up, a divergence spike held for two rows, a
    saturated D_X streak, a non-finite count and a NaN loss."""
    sat = {"health/dX_real_mean": 0.99, "health/dX_fake_mean": 0.01,
           "health/dX_real_std": 0.01, "health/dX_fake_std": 0.01}
    epoch0 = ([_healthy_row(**{"loss_G/total": 3.0 + 0.01 * i})
               for i in range(25)]
              + [_healthy_row(**{"loss_G/total": 50.0})] * 2
              + [_healthy_row(**sat)] * 6
              + [_healthy_row(**{"health/nonfinite": 12.0})])
    epoch1 = ([_healthy_row(**{"loss_F/total": 80.0,
                               "health/gnorm_G": 0.5 * i})
               for i in range(3)]
              + [_healthy_row(**{"loss_X/loss": float("nan")})])
    return epoch0, epoch1


def _drive(module, **kw):
    echoed = []
    mon = module.HealthMonitor(echo=echoed.append, collapse_patience=5, **kw)
    rollups = []
    for epoch, rows in enumerate(_rows()):
        mon.begin_epoch(epoch)
        for row in rows:
            mon.observe(row)
        rollups.append(mon.epoch_rollup())
    return mon, echoed, rollups


def test_monitor_matches_jax_on_the_same_rows():
    ours, our_echo, our_rollups = _drive(health)
    theirs, their_echo, their_rollups = _drive(jax_health)
    assert ours.fault_counts == theirs.fault_counts == {
        "divergence": 2, "d_collapse": 1, "nonfinite": 2}
    assert our_echo == their_echo and len(our_echo) == 5
    # As JSON, so that a NaN mean would compare equal to itself.
    assert json.dumps(our_rollups, sort_keys=True) == json.dumps(
        their_rollups, sort_keys=True)
    assert our_rollups[1]["gnorm_G"] == 0.625


def test_halt_raises_the_same_fault_as_jax():
    faults = []
    for module in (health, jax_health):
        mon = module.HealthMonitor(on_nan="halt")
        mon.observe(_healthy_row())
        with pytest.raises(module.HealthFault) as e:
            mon.observe(_healthy_row(**{"health/nonfinite": 4.0}))
        faults.append((e.value.kind, str(e.value), e.value.details))
    assert faults[0] == faults[1]
    with pytest.raises(ValueError, match="on_nan"):
        health.HealthMonitor(on_nan="explode")


def test_make_health_monitor_reads_the_ports_config():
    assert health.make_health_monitor(pc.ObsConfig(health=False)) is None
    cfg = pc.ObsConfig(on_nan="halt", divergence_multiple=2.5,
                       collapse_eps=0.1, collapse_patience=7)
    mon = health.make_health_monitor(cfg)
    want = jax_health.make_health_monitor(jc.ObsConfig(
        on_nan="halt", divergence_multiple=2.5, collapse_eps=0.1,
        collapse_patience=7))
    for name in ("on_nan", "divergence_multiple", "divergence_beta",
                 "divergence_warmup", "collapse_eps", "collapse_patience"):
        assert getattr(mon, name) == getattr(want, name), name
    assert mon.echo is print


def test_print_epoch_summary_health_line_is_jaxs(capsys):
    results = {"error/MAE(X, F(G(X)))": 0.25}
    rollup = {"gnorm_G": 1.25, "gnorm_F": 0.5, "gnorm_dX": 0.25,
              "gnorm_dY": 0.125, "dX_real_mean": 0.61, "dX_fake_mean": 0.39,
              "dY_real_mean": 0.55, "dY_fake_mean": 0.45}
    for rollup_or_none in (None, rollup, {}):
        loop.print_epoch_summary(results, 1.0, health=rollup_or_none)
        ours = capsys.readouterr().out
        jax_loop.print_epoch_summary(results, 1.0, health=rollup_or_none)
        assert ours == capsys.readouterr().out
    loop.print_epoch_summary(results, 1.0, health=rollup)
    assert "grad-norm G/F/dX/dY: 1.25/0.5/0.25/0.125" in capsys.readouterr().out


class _Counting(health.HealthMonitor):
    def __init__(self):
        super().__init__()
        self.rows, self.epochs = [], []

    def begin_epoch(self, epoch):
        self.epochs.append(epoch)
        super().begin_epoch(epoch)

    def observe(self, row):
        self.rows.append(row)
        super().observe(row)


class _NullSummary:
    def scalar(self, *a, **kw):
        pass


@pytest.mark.parametrize("prefetch", [0, 2])
def test_the_loop_feeds_the_monitor_a_row_a_step(prefetch):
    import dataclasses

    config = dataclasses.replace(
        CONFIG, data=pc.DataConfig(source="synthetic", resize_size=36,
                                   crop_size=32, synthetic_train_size=5,
                                   synthetic_test_size=1),
        train=dataclasses.replace(CONFIG.train, verbose=0,
                                  prefetch_batches=prefetch),
        obs=pc.ObsConfig(health=True))
    data = CycleGANData(config, 2)
    mon = _Counting()
    loop.train_epoch(config, data, make_train_step(config, 2),
                     create_state(config, 0, device="cpu"), _NullSummary(),
                     4, health=mon)
    assert mon.epochs == [4] and len(mon.rows) == data.train_steps == 3
    assert all(row["health/nonfinite"] == 0 for row in mon.rows)


def _poison_from(epoch_index, monkeypatch):
    """Make every train batch of epochs >= ``epoch_index`` NaN."""
    train_epoch = CycleGANData.train_epoch

    def poisoned(self, epoch, prefetch=True, start_step=0):
        for x, y, w in train_epoch(self, epoch, prefetch, start_step):
            if epoch >= epoch_index:
                x = x * np.float32("nan")
            yield x, y, w

    monkeypatch.setattr(CycleGANData, "train_epoch", poisoned)


def test_on_nan_halt_exits_3_with_no_new_slot(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "run")
    port_main.main(["--output_dir", out, "--epochs", "1"] + ARGS)
    ckpt = Checkpointer(out, keep=2)
    before = [(e, ckpt.read_manifest(p)["state_sha256"])
              for e, p in ckpt.slots()]
    assert [e for e, _ in before] == [0]
    capsys.readouterr()

    _poison_from(1, monkeypatch)
    with pytest.raises(SystemExit) as e:
        port_main.main(["--output_dir", out, "--epochs", "3",
                        "--on_nan", "halt"] + ARGS)
    assert e.value.code == 3
    printed = capsys.readouterr().out
    assert "HEALTH FAULT (nonfinite)" in printed
    assert "last-good checkpoint intact" in printed
    assert [(e, ckpt.read_manifest(p)["state_sha256"])
            for e, p in ckpt.slots()] == before
    assert ckpt.read_meta()["epoch"] == 0


def test_on_nan_warn_keeps_training_and_reports(tmp_path, monkeypatch,
                                                capsys):
    out = str(tmp_path / "run")
    _poison_from(0, monkeypatch)
    port_main.main(["--output_dir", out, "--epochs", "1"] + ARGS)
    printed = capsys.readouterr().out
    assert "health: non-finite gradients at epoch 0 row 1" in printed
    assert "grad-norm G/F/dX/dY: nan/nan/nan/nan" in printed
    assert [e for e, _ in Checkpointer(out, keep=2).slots()] == [0]
    scalars = port_summary.read_scalars(out)
    assert scalars["health/nonfinite"][0][1] > 0
    for net in health.NETWORKS:
        assert [s for s, _ in scalars[f"health/gnorm_{net}"]] == [0]
    assert os.path.isdir(os.path.join(out, "test"))
