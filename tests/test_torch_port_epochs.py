"""The port's epoch loop (train/loop.py) against the JAX package's, and its
resume, on the CPU.

A small CycleGAN (generators of 4 filters with 1 downsampling, 1 residual
and 1 upsampling block; discriminators of 4 filters; 32², batch 2) on
SyntheticSource data with 3 train and 3 test pairs, so the last train and
the last test batch are ragged. One JAX state with signal weights
(convert.py) goes to the port through ``convert.state_from_flax``; each
side then runs two epochs of its own pipeline, train pass and test pass,
from it. The JAX side runs its main.py's default layout
(``pad_impl="pad"``, ``instance_norm_impl="auto"``,
``upsample_impl="dense"``), which computes the same function as the
port's kernel layout without interpret-mode Pallas. Each epoch's ten train
means and fourteen test means agree to rtol 1e-3, atol 1e-5, the
tolerance of the three-step test (tests/test_torch_port_train.py).

Resume: two epochs, a checkpoint, then the third epoch from the restored
slot in a fresh state and pipeline, against three epochs uninterrupted:
parameters, Adam moments and epoch means bitwise equal.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from cyclegan_tpu import config as jc
from cyclegan_tpu.data.pipeline import CycleGANData as JaxData
from cyclegan_tpu.parallel import make_mesh_plan, shard_test_step, shard_train_step
from cyclegan_tpu.parallel.mesh import replicated
from cyclegan_tpu.train import loop as jax_loop
from cyclegan_tpu.train.state import create_state as jax_create_state
from cyclegan_tpu.train.steps import make_test_step as jax_test_step
from cyclegan_tpu.train.steps import make_train_step as jax_train_step
from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch.convert import (
    NETWORKS,
    signal_discriminator_flax_params,
    signal_flax_params,
    state_from_flax,
    state_to_flax,
)
from cyclegan_tpu_torch.data.pipeline import CycleGANData
from cyclegan_tpu_torch.train import loop
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.train.steps import (
    METRIC_KEYS,
    TEST_ERROR_KEYS,
    make_test_step,
    make_train_step,
)
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer, state_digest

from tests.test_torch_port_train import _numpy_state, _with_params

BATCH = 2
EPOCHS = 2
TOL = dict(rtol=1e-3, atol=1e-5)
DATA = dict(source="synthetic", resize_size=36, crop_size=32,
            synthetic_train_size=3, synthetic_test_size=3)
GEN = dict(filters=4, num_downsampling_blocks=1, num_residual_blocks=1,
           num_upsample_blocks=1)
JAX_CONFIG = jc.Config(
    model=jc.ModelConfig(generator=jc.GeneratorConfig(**GEN),
                         discriminator=jc.DiscriminatorConfig(filters=4),
                         image_size=32, pad_impl="pad",
                         instance_norm_impl="auto", upsample_impl="dense"),
    data=jc.DataConfig(**DATA),
    train=jc.TrainConfig(batch_size=BATCH, seed=11, verbose=0),
    obs=jc.ObsConfig(health=False))
CONFIG = pc.Config(
    model=pc.ModelConfig(generator=pc.GeneratorConfig(**GEN),
                         discriminator=pc.DiscriminatorConfig(filters=4),
                         image_size=32, **pc.KERNEL_LAYOUT),
    data=pc.DataConfig(**DATA),
    train=pc.TrainConfig(batch_size=BATCH, seed=11, verbose=0),
    obs=pc.ObsConfig(health=False))


class _Recorder:
    """A Summary that keeps each scalar: (training, tag, step) -> value."""

    def __init__(self):
        self.values = {}

    def scalar(self, tag, value, step, training=True):
        self.values[(training, tag, step)] = float(value)

    def epoch(self, training, step):
        return {tag: v for (t, tag, s), v in self.values.items()
                if t == training and s == step}


def _signal_state():
    """A fresh JAX state with signal weights (the JAX train step donates
    its state, so each use builds its own)."""
    init = jax_create_state(JAX_CONFIG, jax.random.PRNGKey(0))
    g, d = CONFIG.model.generator, CONFIG.model.discriminator
    return _with_params(init, {
        "g": signal_flax_params(g, 1), "f": signal_flax_params(g, 2),
        "dx": signal_discriminator_flax_params(d, 3),
        "dy": signal_discriminator_flax_params(d, 4)})


@functools.lru_cache(maxsize=None)
def _signal_numpy():
    return _numpy_state(_signal_state())


def _port_epochs(state, epochs, summary, start=0, config=CONFIG):
    data = CycleGANData(config, BATCH)
    train_step = make_train_step(config, BATCH)
    test_step = make_test_step(config, BATCH)
    for epoch in range(start, epochs):
        state = loop.train_epoch(config, data, train_step, state, summary, epoch)
        loop.test_epoch(config, data, test_step, state, summary, epoch)
    return state


def test_two_epochs_match_the_jax_loop():
    jax_state = _signal_state()
    ours = _Recorder()
    _port_epochs(state_from_flax(_signal_numpy(), CONFIG, "cpu"), EPOCHS, ours)

    plan = make_mesh_plan(devices=jax.devices()[:1])
    train_step = shard_train_step(plan, jax_train_step(JAX_CONFIG, BATCH, plan))
    test_step = shard_test_step(plan, jax_test_step(JAX_CONFIG, BATCH, plan))
    data = JaxData(JAX_CONFIG, BATCH)
    assert (data.train_steps, data.test_steps) == (2, 2)
    state = jax.device_put(jax_state, replicated(plan))
    theirs = _Recorder()
    for epoch in range(EPOCHS):
        state = jax_loop.train_epoch(JAX_CONFIG, data, plan, train_step, state,
                                     theirs, epoch)
        jax_loop.test_epoch(JAX_CONFIG, data, plan, test_step, state, theirs,
                            epoch)

    for epoch in range(EPOCHS):
        for training, keys in ((True, METRIC_KEYS),
                               (False, METRIC_KEYS + TEST_ERROR_KEYS)):
            got, want = ours.epoch(training, epoch), theirs.epoch(training, epoch)
            assert set(got) == set(want) == set(keys)
            for k in keys:
                np.testing.assert_allclose(
                    got[k], want[k], err_msg=f"epoch {epoch} "
                    f"{'train' if training else 'test'} {k}", **TOL)
    # The signal weights exercise the adversarial terms.
    assert abs(ours.epoch(True, 0)["loss_G/loss"] - 1.0) > 0.05


@pytest.mark.parametrize("prefetch", [0, 2])
def test_resume_is_bitwise_an_uninterrupted_run(tmp_path, prefetch):
    config = dataclasses.replace(CONFIG, train=dataclasses.replace(
        CONFIG.train, prefetch_batches=prefetch))
    start = state_from_flax(_signal_numpy(), config, "cpu")
    whole = _Recorder()
    ref = _port_epochs(start, 3, whole, config=config)

    first = _Recorder()
    state = state_from_flax(_signal_numpy(), config, "cpu")
    state = _port_epochs(state, 2, first, config=config)
    Checkpointer(str(tmp_path), keep=2).save(state, 1)
    resumed = _Recorder()
    fresh = create_state(config, 5, device="cpu")
    fresh, epoch, ok = Checkpointer(str(tmp_path), keep=2).restore_if_exists(fresh)
    assert ok and epoch == 2 and fresh.step == 4
    got = _port_epochs(fresh, 3, resumed, start=epoch, config=config)

    assert state_digest(got) == state_digest(ref)
    a, b = state_to_flax(got), state_to_flax(ref)
    for name in NETWORKS:
        for k, v in b[f"{name}_params"].items():
            np.testing.assert_array_equal(a[f"{name}_params"][k], v)
        for part in ("mu", "nu"):
            for k, v in b[f"{name}_opt"][part].items():
                np.testing.assert_array_equal(a[f"{name}_opt"][part][k], v)
    assert {k: v for k, v in first.values.items()} == {
        k: v for k, v in whole.values.items() if k[2] < 2}
    assert resumed.values == {k: v for k, v in whole.values.items() if k[2] == 2}
    assert len(resumed.values) == len(METRIC_KEYS) * 2 + len(TEST_ERROR_KEYS)
