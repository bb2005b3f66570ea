"""The port's training CLI (``python -m cyclegan_tpu_torch.main``) on the
CPU, with PIL, tensorboardX, tensorboard, matplotlib and tqdm blocked:
two epochs on synthetic data at 32², then a second run that resumes to
three. Checked: the printed lines, the checkpoint ring, the event files
(train and test means, the perf scalars, the cycle panels), and the flags
the port does not take."""

import os
import re
import sys

import pytest

from cyclegan_tpu_torch import main as port_main
from cyclegan_tpu_torch.train.steps import METRIC_KEYS, TEST_ERROR_KEYS
from cyclegan_tpu_torch.utils import summary as port_summary
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer

BLOCKED = ("PIL", "tensorboardX", "tensorboard", "matplotlib", "tqdm")
ARGS = ["--batch_size", "2", "--verbose", "1", "--data_source", "synthetic",
        "--image_size", "32", "--filters", "4", "--residual_blocks", "1",
        "--synthetic_train_size", "3", "--synthetic_test_size", "2",
        "--ckpt_keep", "2", "--device", "cpu",
        # The kernel layout: every norm, epilogue and upsample site a kernel.
        "--norm_impl", "pallas", "--pad_impl", "epilogue",
        "--upsample_impl", "zeroskip_fused"]


def _run(monkeypatch, capsys, out, epochs):
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)
    port_main.main(["--output_dir", out, "--epochs", str(epochs)] + ARGS)
    monkeypatch.undo()
    return capsys.readouterr().out


def _image_tags(logdir):
    tags = []
    for name in sorted(os.listdir(logdir)):
        if "tfevents" not in name:
            continue
        for record in port_summary.read_records(os.path.join(logdir, name)):
            event = dict(port_summary._fields(record))
            for _, value in port_summary._fields(event.get(5, b"")):
                fields = dict(port_summary._fields(value))
                if 4 in fields:
                    tags.append((fields[1].decode(), event[2]))
    return tags


def test_two_epochs_then_resume_to_three(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "run")
    first = _run(monkeypatch, capsys, out, 2)
    assert "Devices: 1 (cpu, cpu), global batch size: 2" in first
    assert re.search(r"Dataset synthetic: 3 train / 2 test pairs, 2 train "
                     r"steps, 1 test steps per epoch, cache \d+MB, "
                     r"preprocessing native", first)
    assert "Epoch 001/002" in first and "Epoch 002/002" in first
    assert first.count("MAE(X, F(G(X))): ") == 2
    assert re.search(r"saved checkpoint to \S+checkpoint-e00000 \(\d+ bytes", first)
    assert "checkpoint-e00001" in first and "Resumed" not in first

    second = _run(monkeypatch, capsys, out, 3)
    slot = os.path.join(out, "checkpoints", "checkpoint-e00001")
    assert f"Resumed from {slot} at epoch 2" in second
    assert "Epoch 003/003" in second and "Epoch 002" not in second
    assert "checkpoint-e00002" in second

    ckpt = Checkpointer(out, keep=2)
    assert [e for e, _ in ckpt.slots()] == [2, 1]
    assert all(ckpt.verify(p)[0] for _, p in ckpt.slots())
    assert ckpt.read_meta()["model"]["generator"]["filters"] == 4

    train = port_summary.read_scalars(out)
    test = port_summary.read_scalars(os.path.join(out, "test"))
    for key in METRIC_KEYS + ("elapse", "images_per_sec",
                              "perf/train_images_per_sec",
                              "perf/tflops_per_sec"):
        assert [s for s, _ in train[key]] == [0, 1, 2], key
    assert "perf/mfu" not in train  # no peak is known for the CPU
    assert set(test) == {port_summary.clean_tag(k)
                         for k in METRIC_KEYS + TEST_ERROR_KEYS}
    assert all([s for s, _ in v] == [0, 1, 2] for v in test.values())
    images = _image_tags(os.path.join(out, "test"))
    for family in ("X_cycle", "Y_cycle"):
        for i in range(2):
            assert [s for t, s in images if t == f"{family}/{i}"] == [0, 1, 2]


@pytest.mark.parametrize("flags,match", [
    (["--pad_mode", "zero", "--pad_impl", "fused"],
     "requires pad_mode='reflect'"),
    (["--steps_per_dispatch", "2", "--grad_accum", "2"],
     "--grad_accum and --steps_per_dispatch are mutually exclusive"),
    (["--on_nan", "rollback"], "not ported yet"),
    (["--upsample_impl", "zeroskip_fused", "--norm_impl", "xla"],
     "embeds a Pallas instance norm"),
    (["--trunk_impl", "perturb", "--scan_blocks"],
     "incompatible with scan_blocks"),
    (["--data_source", "tfds"], "not ported yet"),
])
def test_values_the_port_does_not_run_end_the_run(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        port_main.main(["--output_dir", str(tmp_path), "--epochs", "1"]
                       + ARGS + flags)


@pytest.mark.parametrize("flag", ["--fid_every", "--inject", "--probe_every",
                                  "--max_rollbacks", "--spatial_parallelism"])
def test_the_jax_clis_other_flags_are_not_defined(tmp_path, flag, capsys):
    with pytest.raises(SystemExit) as e:
        port_main.main(["--output_dir", str(tmp_path), flag, "1"] + ARGS)
    assert e.value.code == 2
    assert "unrecognized arguments" in capsys.readouterr().err


def test_the_layout_flags_default_to_the_ported_layout():
    # Every layout is ported: the flags take the JAX CLI's defaults.
    args = port_main.build_parser().parse_args([])
    assert (args.norm_impl, args.pad_impl, args.upsample_impl) == (
        "auto", "pad", "dense")
    assert (args.pad_mode, args.trunk_impl, args.remat,
            args.scan_blocks) == ("reflect", "resnet", False, False)
    assert (args.output_dir, args.epochs, args.batch_size, args.verbose,
            args.ckpt_keep, args.prefetch_batches, args.seed, args.device) == (
        "runs", 200, 1, 1, 3, 2, 1234, "cuda")


def test_a_run_under_deterministic_algorithms_matches_a_default_run(
        tmp_path, capsys):
    """The CLI leaves torch's deterministic-algorithms mode as its caller
    set it (chip_smoke.py's resume pair runs it under the mode): every op
    of a run has a deterministic form, and on the CPU, where both modes
    are deterministic, the run's epoch means are a default run's."""
    import torch

    means = []
    for name, mode in (("default", False), ("deterministic", True)):
        out = str(tmp_path / name)
        torch.use_deterministic_algorithms(mode)
        try:
            port_main.main(["--output_dir", out, "--epochs", "1"] + ARGS)
            assert torch.are_deterministic_algorithms_enabled() is mode
        finally:
            torch.use_deterministic_algorithms(False)
        means.append({k: v for k, v in port_summary.read_scalars(out).items()
                      if k.startswith(("loss_", "health/"))})
    assert means[0] == means[1] and "loss_G/total" in means[0]
    with pytest.raises(SystemExit):
        port_main.build_parser().parse_args(["--deterministic"])
