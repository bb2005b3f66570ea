"""The port's input pipeline against the JAX package's, on the CPU.

Batches must be bitwise equal: the same SyntheticSource images, seeded
permutations, augmentation decisions and uint8 caches, on the native (C++)
path and on the numpy path of each package, with ``cache_augmented`` on
and off, and with a ragged last batch (5 pairs at batch 2).

The two paths of one package are not bitwise equal to each other: the
JAX package's C++ interpolates as a + (b - a) * f and its numpy path as
a * (1 - f) + b * f, so a value within an ulp of a rounding boundary may
land one uint8 count apart (tests/test_native.py holds them to 1 count).
The port keeps both arithmetics, so that each path is bitwise the JAX
package's; its two paths then differ exactly where, and by exactly what,
the JAX package's two paths differ.
"""

import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest

from cyclegan_tpu import config as jc
from cyclegan_tpu.data import native as jax_native
from cyclegan_tpu.data import pipeline as jax_pipeline
from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch.data import native
from cyclegan_tpu_torch.data import pipeline
from cyclegan_tpu_torch.data.prefetch import prefetch_iter
from cyclegan_tpu_torch.data.sources import (
    FolderSource,
    SyntheticSource,
    load_image_file,
    resolve_source,
)

SEED = 7
BATCH = 2
DATA = dict(source="synthetic", resize_size=36, crop_size=32,
            synthetic_train_size=5, synthetic_test_size=3)


def _configs(cache_augmented: bool):
    return (jc.Config(data=jc.DataConfig(cache_augmented=cache_augmented,
                                         **DATA),
                      train=jc.TrainConfig(seed=SEED, plot_samples=2)),
            pc.Config(data=pc.DataConfig(cache_augmented=cache_augmented,
                                         **DATA),
                      train=pc.TrainConfig(seed=SEED, plot_samples=2)))


def _epochs(data):
    """Every array the pipeline yields: train epochs 0 and 1, the test
    pass, the plot pairs."""
    out = []
    for epoch in (0, 1):
        out += [a for batch in data.train_epoch(epoch) for a in batch]
    out += [a for batch in data.test_epoch() for a in batch]
    out += [a for pair in data.plot_pairs() for a in pair]
    return out


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("cache_augmented", [True, False],
                         ids=["cached", "fresh"])
def test_batches_match_jax_bitwise(use_native, cache_augmented, monkeypatch):
    if use_native:
        assert native.available() and jax_native.available()
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    ours = pipeline.CycleGANData(_configs(cache_augmented)[1], BATCH)
    assert ours.preprocessing == ("native" if use_native else "numpy")
    theirs = jax_pipeline.CycleGANData(_configs(cache_augmented)[0], BATCH)
    got, want = _epochs(ours), _epochs(theirs)
    assert (ours.n_train, ours.n_test, ours.train_steps, ours.test_steps) == (
        theirs.n_train, theirs.n_test, theirs.train_steps, theirs.test_steps)
    assert ours.train_steps == 3  # 5 pairs at batch 2: the last is ragged
    assert ours.cache_nbytes() == theirs.cache_nbytes()
    assert len(got) == len(want) == 3 * 3 * 2 + 2 * 3 + 2 * 2
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert np.array_equal(a, b), f"array {i} differs"
    last_x, _, last_w = list(ours.train_epoch(0, prefetch=False))[-1]
    np.testing.assert_array_equal(last_w, [1, 0])
    assert not last_x[1].any()
    # Epochs differ in their shuffle; fresh augmentation also in content.
    e0, e1 = (list(ours.train_epoch(e, prefetch=False)) for e in (0, 1))
    assert not np.array_equal(e0[0][0], e1[0][0])


def test_native_and_numpy_paths_differ_only_as_the_jax_packages_do(
        monkeypatch):
    cfg, jax_cfg = _configs(True)[1], _configs(True)[0]
    port = [pipeline.CycleGANData(cfg, BATCH)._train_cache]
    jax = [jax_pipeline.CycleGANData(jax_cfg, BATCH)._train_cache]
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    port.append(pipeline.CycleGANData(cfg, BATCH)._train_cache)
    jax.append(jax_pipeline.CycleGANData(jax_cfg, BATCH)._train_cache)
    n_diff = 0
    for d in range(2):
        for i in range(5):
            ours = port[0][d][i].astype(int) - port[1][d][i]
            theirs = jax[0][d][i].astype(int) - jax[1][d][i]
            np.testing.assert_array_equal(ours, theirs)
            assert np.abs(ours).max() <= 1
            n_diff += np.count_nonzero(ours)
    assert n_diff < 0.01 * 2 * 5 * 32 * 32 * 3


def test_native_library_builds_into_the_build_dir():
    assert native.available()
    path = native.library_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.exists(path) and os.path.basename(path).startswith("libcgdata_")
    img = SyntheticSource(1, 1, image_size=40).load("trainA", 0)
    batch = native.preprocess_batch(np.stack([img, img]), 36,
                                    np.array([0, 1], np.int32),
                                    np.array([1, 2], np.int32),
                                    np.array([3, 0], np.int32), 32,
                                    normalize=False)
    for j, (flip, oy, ox) in enumerate(((0, 1, 3), (1, 2, 0))):
        np.testing.assert_array_equal(
            batch[j], native.preprocess_one(img, 36, flip, oy, ox, 32,
                                            normalize=False))


def test_preprocessing_falls_back_to_numpy_without_a_compiler(monkeypatch):
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "library_path", lambda: "/nonexistent/lib.so")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    data = pipeline.CycleGANData(_configs(True)[1], BATCH)
    assert data.preprocessing == "numpy"
    with pytest.raises(RuntimeError, match="native"):
        native.preprocess_one(np.zeros((4, 4, 3), np.uint8), 4, 0, 0, 0, 4)


def test_prefetch_keeps_order():
    assert list(prefetch_iter(iter(range(100)), depth=3)) == list(range(100))
    with pytest.raises(ValueError, match="depth"):
        prefetch_iter(iter([]), depth=0)


def test_prefetch_passes_on_the_source_exception():
    def boom():
        yield 1
        yield 2
        raise RuntimeError("source failed")

    it = prefetch_iter(boom(), depth=2)
    assert next(it) == 1 and next(it) == 2
    with pytest.raises(RuntimeError, match="source failed"):
        next(it)


def test_prefetch_stops_when_abandoned():
    n_before = threading.active_count()
    it = prefetch_iter(iter(range(10_000)), depth=1)
    next(it)
    it.close()
    for _ in range(50):
        if threading.active_count() <= n_before:
            break
        time.sleep(0.1)
    assert threading.active_count() <= n_before


def _write_folder(root, sizes=(3, 2), image_size=40):
    src = SyntheticSource(*sizes, image_size=image_size)
    for split in ("trainA", "trainB", "testA", "testB"):
        os.makedirs(os.path.join(root, split))
        for i in range(src.split_size(split)):
            np.save(os.path.join(root, split, f"{i:03d}.npy"),
                    src.load(split, i))
    return src


def test_folder_source_reads_npy_without_pil(tmp_path, monkeypatch):
    src = _write_folder(str(tmp_path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    folder = FolderSource(str(tmp_path))
    assert folder.split_size("trainA") == 3 and folder.split_size("testB") == 2
    for split in ("trainA", "testB"):
        np.testing.assert_array_equal(folder.load(split, 1), src.load(split, 1))
    (tmp_path / "trainA" / "x.png").write_bytes(b"\x89PNG")
    with pytest.raises(ImportError, match="needs PIL"):
        load_image_file(str(tmp_path / "trainA" / "x.png"))
    cfg = pc.Config(data=pc.DataConfig(source="auto", data_dir=str(tmp_path),
                                       resize_size=36, crop_size=32))
    data = pipeline.CycleGANData(cfg, 2)
    assert data.source.name.startswith("folder:")
    assert (data.n_train, data.train_steps) == (3, 2)


def test_folder_source_missing_split(tmp_path):
    with pytest.raises(FileNotFoundError, match="trainA"):
        FolderSource(str(tmp_path))


def test_resolve_source(capsys):
    auto = resolve_source(pc.DataConfig(synthetic_train_size=3,
                                        synthetic_test_size=2, crop_size=32,
                                        resize_size=36))
    assert isinstance(auto, SyntheticSource)
    assert auto.split_size("trainB") == 3 and auto.load("testA", 0).shape == (32, 32, 3)
    assert "synthetic" in capsys.readouterr().out
    with pytest.raises(ValueError, match="not ported yet"):
        resolve_source(pc.DataConfig(source="tfds"))
    with pytest.raises(ValueError, match="data_dir"):
        resolve_source(pc.DataConfig(source="folder"))


def test_config_fields_keep_the_jax_names_and_defaults():
    for ours, theirs in ((pc.DataConfig, jc.DataConfig),
                         (pc.TrainConfig, jc.TrainConfig)):
        want = {f.name: f.default for f in dataclasses.fields(theirs)}
        for f in dataclasses.fields(ours):
            assert f.name in want, f.name
            assert f.default == want[f.name], f.name
    with pytest.raises(ValueError, match="not ported yet"):
        pc.DataConfig(domain="maps")
    with pytest.raises(ValueError, match="not ported yet"):
        pc.TrainConfig(steps_per_dispatch=2)
    with pytest.raises(ValueError, match="ckpt_keep"):
        pc.TrainConfig(ckpt_keep=0)
