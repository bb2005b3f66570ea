"""The port's discriminator, losses, data source, configuration and
weight conversion against the JAX package, on the CPU.

The JAX package builds the PatchGAN discriminator in the layout the port
runs (``pad_impl="epilogue"``, ``norm_impl="pallas"``, Pallas in
interpret mode); its parameters go through the port's convert.py into
the port's ``PatchGANDiscriminator``. Weights and inputs come from a
numpy seed. Tolerances: the discriminator's raw logits 2e-6 abs at the
init distribution (as tests/test_torch_parity.py holds its torch
reference) and 1e-5 abs plus 1e-5 relative at signal weights, where the
logits are O(1); the losses 1e-6 relative (f32 means in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu import losses as jax_losses
from cyclegan_tpu.config import DiscriminatorConfig as JaxDiscriminatorConfig
from cyclegan_tpu.data.sources import SyntheticSource as JaxSyntheticSource
from cyclegan_tpu.models import PatchGANDiscriminator as JaxDiscriminator
from cyclegan_tpu_torch import losses
from cyclegan_tpu_torch.config import (
    Config,
    DiscriminatorConfig,
    ObsConfig,
    TrainConfig,
)
from cyclegan_tpu_torch.convert import (
    discriminator_config_from_flax,
    discriminator_param_shapes,
    discriminator_state_from_flax,
    flax_from_state_dict,
    random_discriminator_flax_params,
    signal_discriminator_flax_params,
)
from cyclegan_tpu_torch.data.sources import SyntheticSource
from cyclegan_tpu_torch.models import PatchGANDiscriminator
from cyclegan_tpu_torch.models.modules import Conv

TINY = dict(filters=8)
LAYOUT = dict(pad_impl="epilogue", norm_impl="pallas")


def _jax_tree(params):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in params.items()}, sep="/")}


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree["params"], sep="/").items()}


@pytest.mark.parametrize("cfg", [TINY, {}], ids=["tiny", "full"])
def test_param_tree_matches_jax(cfg):
    disc = JaxDiscriminator(config=JaxDiscriminatorConfig(**cfg), **LAYOUT)
    tree = jax.eval_shape(disc.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))
    want = {k: tuple(v.shape) for k, v in
            traverse_util.flatten_dict(tree["params"], sep="/").items()}
    assert discriminator_param_shapes(DiscriminatorConfig(**cfg)) == want


def test_full_width_discriminator_parameter_count():
    n = sum(p.numel() for p in PatchGANDiscriminator(device="meta").parameters())
    assert 2.76e6 < n < 2.78e6


def _run_both(params, x):
    disc = JaxDiscriminator(config=JaxDiscriminatorConfig(**TINY), **LAYOUT)
    want = np.asarray(disc.apply(_jax_tree(params), jnp.asarray(x)))
    ours = PatchGANDiscriminator(discriminator_config_from_flax(params),
                                 device="cpu")
    ours.load_state_dict(discriminator_state_from_flax(params))
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (x.shape[0], 4, 4, 1)
    return got, want


def test_discriminator_matches_jax_from_jax_init():
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    disc = JaxDiscriminator(config=JaxDiscriminatorConfig(**TINY), **LAYOUT)
    got, want = _run_both(_flat(disc.init(jax.random.PRNGKey(1), jnp.asarray(x))), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_discriminator_matches_jax_at_signal_weights():
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    params = signal_discriminator_flax_params(DiscriminatorConfig(**TINY), 2)
    got, want = _run_both(params, x)
    assert np.std(want) > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_discriminator_random_params_and_round_trip():
    cfg = DiscriminatorConfig(**TINY)
    params = random_discriminator_flax_params(cfg, 3)
    assert discriminator_config_from_flax(params) == cfg
    assert all(np.all(v == 0) for k, v in params.items() if k.endswith("/bias"))
    back = flax_from_state_dict(discriminator_state_from_flax(params))
    assert back.keys() == params.keys()
    for k in params:
        np.testing.assert_array_equal(back[k], params[k])
    with pytest.raises(KeyError, match="missing"):
        discriminator_state_from_flax(
            {k: v for k, v in params.items() if k != "Conv_1/bias"})


@pytest.mark.parametrize("size,stride", [(8, 1), (7, 1), (9, 2), (8, 2)])
def test_conv_same_k4_matches_jax(size, stride):
    """TensorFlow SAME for a 4x4 kernel: stride 1 pads 1 above and 2
    below; stride 2 by the size's parity."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, size, size + 1, 3)).astype(np.float32)
    k = rng.standard_normal((4, 4, 3, 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    conv = Conv(3, 5, 4, stride=stride, padding="same", device="cpu")
    conv.weight.data.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    with torch.no_grad():
        got = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("weights", [[1.0, 1.0], [1.0, 0.0]])
def test_losses_match_jax(weights):
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal((2, 4, 4, 3)).astype(np.float32) for _ in range(2))
    p = rng.uniform(0, 1, (2, 4, 4, 1)).astype(np.float32)
    w = np.asarray(weights, np.float32)
    t = torch.from_numpy
    pairs = [
        (losses.mae(t(a), t(b)), jax_losses.mae(a, b)),
        (losses.mse(t(a), t(b)), jax_losses.mse(a, b)),
        (losses.bce(t(p), t(p[::-1].copy())), jax_losses.bce(p, p[::-1])),
        (losses.bce(t(p), t(a[..., :1]), from_logits=True),
         jax_losses.bce(p, a[..., :1], from_logits=True)),
        (losses.generator_loss(t(a), t(w), 2.0),
         jax_losses.generator_loss(a, w, 2.0)),
        (losses.cycle_loss(t(a), t(b), t(w), 2.0),
         jax_losses.cycle_loss(a, b, w, 2.0)),
        (losses.identity_loss(t(a), t(b), t(w), 2.0, 5.0),
         jax_losses.identity_loss(a, b, w, 2.0, 5.0)),
        (losses.discriminator_loss(t(a), t(b), t(w), 2.0),
         jax_losses.discriminator_loss(a, b, w, 2.0)),
        (losses.scaled_mean(t(a[:, 0, 0, 0]), t(w), 2.0),
         jax_losses.scaled_mean(a[:, 0, 0, 0], w, 2.0)),
        *zip(losses.disc_raw_moments(t(a), t(w), 2.0),
             jax_losses.disc_raw_moments(a, w, 2.0)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    # The divisor is the global batch size, not sum(w): a weight-0 sample
    # halves the loss of a batch of 2 rather than dropping out of it.
    if weights == [1.0, 0.0]:
        full = losses.generator_loss(t(a[:1]), torch.ones(1), 1.0)
        half = losses.generator_loss(t(a), t(w), 2.0)
        assert half.item() == pytest.approx(full.item() / 2, rel=1e-6)


@pytest.mark.parametrize("split,index", [("trainA", 0), ("trainB", 7),
                                         ("testA", 3)])
def test_synthetic_source_matches_jax(split, index):
    ours = SyntheticSource(train_size=8, test_size=4, image_size=40)
    theirs = JaxSyntheticSource(train_size=8, test_size=4, image_size=40)
    got = ours.load(split, index)
    assert got.dtype == np.uint8 and got.shape == (40, 40, 3)
    np.testing.assert_array_equal(got, theirs.load(split, index))
    assert ours.split_size(split) == theirs.split_size(split)


@pytest.mark.parametrize("kw", [dict(grad_impl="fusedprop"),
                                dict(grad_accum=2)])
def test_train_config_rejects_options_not_ported(kw):
    with pytest.raises(ValueError, match="later slice"):
        TrainConfig(**kw)


def test_config_defaults_match_jax():
    from cyclegan_tpu import config as jc

    ours, theirs = Config(), jc.Config()
    assert ours.optimizer.__dict__ == theirs.optimizer.__dict__
    assert ours.loss.__dict__ == theirs.loss.__dict__
    assert ours.model.discriminator.__dict__ == theirs.model.discriminator.__dict__
    for name in ("batch_size", "seed", "grad_accum", "grad_impl"):
        assert getattr(ours.train, name) == getattr(theirs.train, name)
    with pytest.raises(ValueError, match="later slice"):
        ObsConfig(health=True)
    with pytest.raises(ValueError, match="unknown"):
        TrainConfig(grad_impl="nonsense")
