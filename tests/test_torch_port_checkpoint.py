"""The port's checkpoint ring (utils/checkpoint.py), held as
tests/test_checkpoint.py holds the JAX package's: round trip, slot names,
pruning, tamper detection with fallback, every slot corrupt, leftover
temporary directories, the recorded architecture, and restore onto the
state's device. On the CPU, with a small CycleGAN (4 filters, 1
downsampling, 1 residual and 1 upsampling block, 32²)."""

import json
import os

import numpy as np
import pytest
import torch

from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch.convert import NETWORKS, state_to_flax
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.train.steps import make_train_step
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer, state_digest

CONFIG = pc.Config(
    model=pc.ModelConfig(
        generator=pc.GeneratorConfig(filters=4, num_downsampling_blocks=1,
                                     num_residual_blocks=1,
                                     num_upsample_blocks=1),
        discriminator=pc.DiscriminatorConfig(filters=4),
        image_size=32),
    train=pc.TrainConfig(batch_size=2))


def _trained(steps=1, seed=0):
    """A state after ``steps`` train steps, so the Adams hold moments."""
    state = create_state(CONFIG, seed, device="cpu")
    step = make_train_step(CONFIG, 2)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        x, y = (torch.from_numpy(rng.uniform(-1, 1, (2, 32, 32, 3))
                                 .astype(np.float32)) for _ in range(2))
        state, _ = step(state, x, y, torch.ones(2))
    return state


def _assert_states_equal(a, b):
    fa, fb = state_to_flax(a), state_to_flax(b)
    assert fa["step"] == fb["step"]
    for name in NETWORKS:
        assert fa[f"{name}_opt"]["count"] == fb[f"{name}_opt"]["count"]
        for part in ("mu", "nu"):
            for k, v in fa[f"{name}_opt"][part].items():
                np.testing.assert_array_equal(v, fb[f"{name}_opt"][part][k])
        for k, v in fa[f"{name}_params"].items():
            np.testing.assert_array_equal(v, fb[f"{name}_params"][k])
    assert state_digest(a) == state_digest(b)


def test_round_trip_is_bitwise(tmp_path):
    state = _trained(steps=2)
    ckpt = Checkpointer(str(tmp_path), keep=1)
    manifest = ckpt.save(state, epoch=4, meta=CONFIG.model_meta())
    assert manifest["state_sha256"] == state_digest(state)
    assert manifest["total_bytes"] == sum(
        os.path.getsize(os.path.join(ckpt.slot, f)) for f in os.listdir(ckpt.slot))
    fresh = create_state(CONFIG, 1, device="cpu")
    assert state_digest(fresh) != state_digest(state)
    restored, start, resumed = ckpt.restore_if_exists(fresh)
    assert resumed and start == 5 and restored.step == 2
    _assert_states_equal(restored, state)
    # Training goes on from the restored Adam state as from the original.
    ref, _ = make_train_step(CONFIG, 2)(state, *([torch.zeros(2, 32, 32, 3)] * 2),
                                        torch.ones(2))
    got, _ = make_train_step(CONFIG, 2)(restored, *([torch.zeros(2, 32, 32, 3)] * 2),
                                        torch.ones(2))
    _assert_states_equal(got, ref)


def test_generator_files_are_flat_flax_dicts(tmp_path):
    from cyclegan_tpu_torch.convert import flax_param_shapes

    state = _trained()
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(state, epoch=0)
    g = torch.load(os.path.join(ckpt.slot, "g.pt"), weights_only=True)
    shapes = flax_param_shapes(CONFIG.model.generator)
    assert {k: tuple(v.shape) for k, v in g.items()} == shapes
    assert sorted(os.listdir(ckpt.slot)) == sorted(
        [f"{n}.pt" for n in NETWORKS] + [f"{n}_opt.pt" for n in NETWORKS]
        + ["step.pt"])


def test_auto_resume_gate_without_slots(tmp_path):
    state = create_state(CONFIG, 0, device="cpu")
    before = state_digest(state)
    ckpt = Checkpointer(str(tmp_path), keep=3)
    got, start, resumed = ckpt.restore_if_exists(state)
    assert (start, resumed) == (0, False) and state_digest(got) == before
    assert not ckpt.verify()[0]


def test_keep_one_slot_name_and_overwrite(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=1)
    first, second = _trained(1, seed=0), _trained(1, seed=1)
    ckpt.save(first, epoch=0)
    ckpt.save(second, epoch=10)
    assert os.path.basename(ckpt.slot) == "checkpoint"
    names = sorted(os.listdir(ckpt.dir))
    assert names == ["checkpoint", "checkpoint.manifest.json", "meta.json"]
    restored, start, _ = Checkpointer(str(tmp_path)).restore_if_exists(
        create_state(CONFIG, 2, device="cpu"))
    assert start == 11
    _assert_states_equal(restored, second)


def test_ring_keeps_k_slots_and_prunes_the_oldest(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    state = _trained()
    for epoch in (0, 10, 20):
        ckpt.save(state, epoch)
    assert [os.path.basename(p) for _, p in ckpt.slots()] == [
        "checkpoint-e00020", "checkpoint-e00010"]
    assert not os.path.exists(os.path.join(ckpt.dir,
                                           "checkpoint-e00000.manifest.json"))
    assert ckpt.read_meta()["epoch"] == 20
    assert ckpt.verify()[0]


def test_tampered_slot_is_detected_and_restore_falls_back(tmp_path, capsys):
    ckpt = Checkpointer(str(tmp_path), keep=3)
    old, new = _trained(1, seed=0), _trained(2, seed=0)
    ckpt.save(old, 0)
    ckpt.save(new, 1)
    newest = ckpt.slots()[0][1]
    with open(os.path.join(newest, "f.pt"), "r+b") as f:
        f.seek(200)
        byte = f.read(1)
        f.seek(200)
        f.write(bytes([byte[0] ^ 0xFF]))
    ok, detail = ckpt.verify(newest)
    assert not ok and "sha256 mismatch in f.pt" in detail
    restored, start = ckpt.restore(create_state(CONFIG, 3, device="cpu"))
    assert start == 1
    _assert_states_equal(restored, old)
    out = capsys.readouterr().out
    assert "checkpoint-e00001" in out and "fell back" in out
    assert "checkpoint-e00000" in out


def test_every_slot_corrupt_raises_naming_the_slots(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    state = _trained()
    ckpt.save(state, 0)
    ckpt.save(state, 1)
    for _, slot in ckpt.slots():
        os.remove(os.path.join(slot, "g_opt.pt"))
    with pytest.raises(RuntimeError, match="every checkpoint slot") as e:
        ckpt.restore(create_state(CONFIG, 0, device="cpu"))
    assert "checkpoint-e00000" in str(e.value) and "checkpoint-e00001" in str(e.value)
    with pytest.raises(SystemExit, match="corrupt"):
        ckpt.restore_for_cli(create_state(CONFIG, 0, device="cpu"))


def test_leftover_temporary_directory_is_ignored(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=3)
    state = _trained()
    ckpt.save(state, 0)
    os.makedirs(os.path.join(ckpt.dir, "checkpoint-e00005.tmp999"))
    os.makedirs(os.path.join(ckpt.dir, "checkpoint-e00004.old999"))
    assert [e for e, _ in ckpt.slots()] == [0]
    _, start, resumed = ckpt.restore_if_exists(create_state(CONFIG, 1, device="cpu"))
    assert resumed and start == 1


def test_slot_without_manifest_is_accepted_unverified(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    state = _trained()
    ckpt.save(state, 3)
    os.remove(ckpt.slot + ".manifest.json")
    assert ckpt.verify() == (True, "unverified (no manifest)")
    restored, start = ckpt.restore(create_state(CONFIG, 1, device="cpu"))
    assert start == 4
    _assert_states_equal(restored, state)


def test_meta_records_the_architecture(tmp_path):
    ckpt = Checkpointer(str(tmp_path), keep=2)
    ckpt.save(_trained(), 7, meta=CONFIG.model_meta())
    with open(os.path.join(ckpt.dir, "meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 7 and meta["slot"] == "checkpoint-e00007"
    assert pc.Config.model_from_meta(meta) == CONFIG.model
    assert meta["model"]["generator"]["filters"] == 4
    wider = pc.Config.model_from_meta(meta, image_size=64)
    assert (wider.image_size, wider.generator.filters) == (64, 4)
    legacy = pc.Config.model_from_meta({"model": {"image_size": 128,
                                                  "unknown": 1}})
    assert legacy == pc.ModelConfig(image_size=128)


def test_restore_loads_onto_the_states_device(tmp_path, monkeypatch):
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(_trained(), 0)
    seen = []
    real_load = torch.load

    def load(*args, **kwargs):
        seen.append(kwargs.get("map_location"))
        return real_load(*args, **kwargs)

    monkeypatch.setattr(torch, "load", load)
    ckpt.restore(create_state(CONFIG, 0, device="cpu"))
    assert seen and all(d == torch.device("cpu") for d in seen)
