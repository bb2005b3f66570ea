"""The PyTorch port's generator against the JAX package, on the CPU.

The JAX package builds the generator; its parameters go through the
port's convert.py into the port's ResNetGenerator, which runs its kernel
sites' plain versions on the CPU. Weights and inputs come from a numpy
seed. Tolerance for the whole generator: 1e-4 abs on the tanh output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from cyclegan_tpu.models import ResNetGenerator as JaxGenerator
from cyclegan_tpu_torch.config import GeneratorConfig
from cyclegan_tpu_torch.convert import (
    config_from_flax,
    flax_param_shapes,
    generator_state_from_flax,
    random_flax_params,
    signal_flax_params,
)
from cyclegan_tpu_torch.models import ResNetGenerator

ATOL = 1e-4
TINY = dict(filters=8, num_residual_blocks=2)
# The layout whose every serving-path site is a Pallas kernel (run in
# interpret mode on the CPU) and the JAX package's default layout.
PALLAS_LAYOUT = dict(norm_impl="pallas", pad_impl="epilogue",
                     upsample_impl="zeroskip_fused")
DEFAULT_LAYOUT = {}


def _jax_shapes(cfg):
    gen = JaxGenerator(config=JaxGeneratorConfig(**cfg))
    tree = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))
    return {k: tuple(v.shape) for k, v in
            traverse_util.flatten_dict(tree["params"], sep="/").items()}


def _unflatten(params):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in params.items()}, sep="/")}


@pytest.mark.parametrize("cfg", [TINY, {}], ids=["tiny", "full"])
def test_param_tree_matches_jax(cfg):
    assert flax_param_shapes(GeneratorConfig(**cfg)) == _jax_shapes(cfg)


def test_full_width_generator_parameter_count():
    gen = ResNetGenerator(device="meta")
    n = sum(p.numel() for p in gen.parameters())
    assert 11.3e6 < n < 11.5e6
    assert config_from_flax(random_flax_params(GeneratorConfig(), 0)) == \
        GeneratorConfig()


@pytest.fixture(scope="module")
def parity_case():
    params = signal_flax_params(GeneratorConfig(**TINY), 11)
    x = np.random.default_rng(12).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    gen = ResNetGenerator(GeneratorConfig(**TINY), device="cpu",
                          **PALLAS_LAYOUT)
    gen.load_state_dict(generator_state_from_flax(params))
    with torch.no_grad():
        ours = gen(torch.from_numpy(x)).numpy()
    return params, x, ours


@pytest.mark.parametrize("layout", [PALLAS_LAYOUT, DEFAULT_LAYOUT],
                         ids=["pallas", "default"])
def test_generator_matches_jax(parity_case, layout):
    params, x, ours = parity_case
    gen = JaxGenerator(config=JaxGeneratorConfig(**TINY), **layout)
    want = np.asarray(gen.apply(_unflatten(params), jnp.asarray(x)))
    assert ours.shape == want.shape == (2, 32, 32, 3)
    # The check must see a real signal, not a saturated or constant map.
    assert 0.05 < np.std(want) and np.abs(want).max() < 0.999
    np.testing.assert_allclose(ours, want, rtol=0, atol=ATOL)


def test_generator_from_jax_init_matches_jax():
    """Weights from the JAX package's own init, through convert.py."""
    gen = JaxGenerator(config=JaxGeneratorConfig(**TINY), **PALLAS_LAYOUT)
    x = np.random.default_rng(13).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    tree = gen.init(jax.random.PRNGKey(3), jnp.asarray(x))
    flat = {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree["params"], sep="/").items()}
    want = np.asarray(gen.apply(tree, jnp.asarray(x)))
    ours = ResNetGenerator(config_from_flax(flat), device="cpu",
                           **PALLAS_LAYOUT)
    ours.load_state_dict(generator_state_from_flax(flat))
    with torch.no_grad():
        got = ours(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_convert_rejects_unknown_missing_and_misshapen_keys():
    params = random_flax_params(GeneratorConfig(**TINY), 0)
    with pytest.raises(KeyError, match="unknown"):
        generator_state_from_flax({**params, "Extra_0/kernel": np.zeros(3)})
    missing = dict(params)
    del missing["ResidualBlock_1/Conv_1/kernel"]
    with pytest.raises(KeyError, match="missing"):
        generator_state_from_flax(missing)
    bad = dict(params)
    bad["Conv_1/bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="Conv_1/bias"):
        generator_state_from_flax(bad)


def test_convert_layouts():
    params = random_flax_params(GeneratorConfig(**TINY), 1)
    state = generator_state_from_flax(params)
    np.testing.assert_array_equal(
        state["Conv_0.weight"].numpy(),
        params["Conv_0/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["Upsample_0.ConvTranspose_0.kernel"].numpy(),
        params["Upsample_0/ConvTranspose_0/kernel"])
    np.testing.assert_array_equal(
        state["ResidualBlock_1.InstanceNorm_0.scale"].numpy(),
        params["ResidualBlock_1/InstanceNorm_0/scale"])
    assert set(state) == set(
        ResNetGenerator(GeneratorConfig(**TINY), device="meta").state_dict())


def test_random_params_follow_the_init_distribution():
    params = random_flax_params(GeneratorConfig(), 5)
    kernel = params["ResidualBlock_0/Conv_0/kernel"]
    assert abs(kernel.std() - 0.02) < 1e-3 and abs(kernel.mean()) < 1e-3
    assert not params["Conv_1/bias"].any()
    np.testing.assert_array_equal(
        kernel, random_flax_params(GeneratorConfig(), 5)[
            "ResidualBlock_0/Conv_0/kernel"])
