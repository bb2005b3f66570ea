"""The port's perturb trunk and its serving tier against the JAX package,
on the CPU.

- The masks: ``ops/prng.py``'s threefry (jax 0.9's partitionable
  ``random_bits``) gives ``jax.random.uniform``'s draws at the perturb
  sites' keys bit for bit, at the full-size shape (64, 64, 256) for
  several block salts and both layers; its normals are within 4 f32 ulps
  and 1e-6 absolute of JAX ``perturb_mask`` (XLA's single-precision
  ``erf_inv`` in numpy f32; ``log1p`` may round differently).
- The masks are non-persistent buffers, never in the ``state_dict``,
  drawn once on the host for every block that draws the same site.
- The perturb generator (``norm_impl="pallas"``, ``pad_impl="fused"``;
  Pallas in interpret mode) against the JAX one, forward atol 1e-4, and
  the combined train step (losses rtol 2e-5 / atol 2e-6, gradients rtol
  1e-3 / atol 3e-6), 64², 8 filters, 2 residual blocks, batch 1.
- The engine's perturb tier against the JAX engine's at buckets 1 and 4
  (atol 1e-4 on the tanh output), and translate from a perturb ring.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu import config as jc
from cyclegan_tpu.models.modules import PERTURB_SEED as JAX_PERTURB_SEED
from cyclegan_tpu.models.modules import perturb_mask as jax_perturb_mask
from cyclegan_tpu.serve import engine as jax_engine
from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch import translate
from cyclegan_tpu_torch.convert import (
    flax_from_state_dict,
    generator_state_from_flax,
    layout_from_flax,
    random_flax_params,
    signal_flax_params,
)
from cyclegan_tpu_torch.models import ResNetGenerator
from cyclegan_tpu_torch.models.modules import PerturbBlock
from cyclegan_tpu_torch.ops import prng
from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer

MASK_SHAPE = (64, 64, 256)
SALTS = (0, 3, 8)
ULPS, MASK_ATOL = 4, 1e-6
FORWARD_ATOL = 1e-4
SIZE = 64
GEN = dict(filters=8, num_residual_blocks=2)
LAYOUT = dict(trunk_impl="perturb", instance_norm_impl="pallas",
              pad_impl="fused")
MODULE_LAYOUT = dict(trunk_impl="perturb", norm_impl="pallas",
                     pad_impl="fused")


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one CPU thread: the CPU is shared with other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_key(salt, layer):
    return jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(JAX_PERTURB_SEED), salt), layer)


def _tree(flat):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


# -- the masks -------------------------------------------------------------

def test_seed_and_keys_match_jax():
    assert prng.PERTURB_SEED == JAX_PERTURB_SEED
    for seed in (0, 1902, 2**31 - 1):
        np.testing.assert_array_equal(
            prng.prng_key(seed),
            np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))))
    for salt in SALTS:
        for layer in (0, 1):
            np.testing.assert_array_equal(
                prng.perturb_key(salt, layer),
                np.asarray(jax.random.key_data(_jax_key(salt, layer))))


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("salt", SALTS)
def test_uniform_draws_are_bit_exact(salt, layer):
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    want = np.asarray(jax.random.uniform(_jax_key(salt, layer), MASK_SHAPE,
                                         minval=lo, maxval=1.0))
    got = prng.uniform(prng.perturb_key(salt, layer), MASK_SHAPE, lo, 1.0)
    assert got.dtype == np.float32 and got.shape == MASK_SHAPE
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("layer", [0, 1])
@pytest.mark.parametrize("salt", SALTS)
def test_normal_masks_match_jax_perturb_mask(salt, layer):
    want = np.asarray(jax_perturb_mask(salt, layer, MASK_SHAPE))
    got = prng.perturb_mask(salt, layer, MASK_SHAPE)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= ULPS
    np.testing.assert_allclose(got, want, rtol=0, atol=MASK_ATOL)
    # A real N(0, 1) draw, and not the older split-counter scheme's.
    assert abs(got.mean()) < 0.01 and abs(got.std() - 1) < 0.01
    assert (ulps == 0).mean() > 0.9


def test_masks_are_cached_read_only_and_buffers():
    a = prng.perturb_mask(1, 0, (4, 4, 8))
    assert a is prng.perturb_mask(1, 0, [4, 4, 8])
    assert not a.flags.writeable
    gen_g = ResNetGenerator(pc.GeneratorConfig(**GEN), device="cpu",
                            **MODULE_LAYOUT)
    gen_f = ResNetGenerator(pc.GeneratorConfig(**GEN), device="cpu",
                            **MODULE_LAYOUT)
    x = torch.zeros(1, 32, 32, 3)
    with torch.no_grad():
        gen_g(x), gen_f(x)
    block_g, block_f = gen_g.ResidualBlock_1, gen_f.ResidualBlock_1
    assert isinstance(block_g, PerturbBlock)
    assert torch.equal(block_g.mask_0, block_f.mask_0)
    assert not torch.equal(block_g.mask_0, gen_g.ResidualBlock_0.mask_0)
    assert tuple(block_g.mask_1.shape) == (8, 8, 32)
    assert not any("mask" in k for k in gen_g.state_dict())
    assert {k for k, _ in gen_g.named_buffers()} == {
        f"ResidualBlock_{i}.mask_{j}" for i in (0, 1) for j in (0, 1)}
    np.testing.assert_array_equal(block_g.mask_1.numpy(),
                                  prng.perturb_mask(1, 1, (8, 8, 32)))


# -- the generator and the train step -------------------------------------

def test_perturb_tree_matches_jax_and_reads_back():
    from cyclegan_tpu.models import ResNetGenerator as JaxGenerator
    jax_gen = JaxGenerator(config=jc.GeneratorConfig(**GEN), trunk_impl="perturb")
    tree = jax.eval_shape(jax_gen.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 32, 32, 3)))
    shapes = {k: tuple(v.shape) for k, v in
              traverse_util.flatten_dict(tree["params"], sep="/").items()}
    params = random_flax_params(pc.GeneratorConfig(**GEN), 0,
                                trunk_impl="perturb")
    assert {k: v.shape for k, v in params.items()} == shapes
    assert shapes["ResidualBlock_0/Conv_0/kernel"] == (1, 1, 32, 32)
    assert layout_from_flax(params) == {"trunk_impl": "perturb",
                                        "scan_blocks": False}
    state = generator_state_from_flax(params)
    assert tuple(state["ResidualBlock_1.Conv_1.weight"].shape) == (32, 32, 1, 1)
    back = flax_from_state_dict(state)
    assert all(np.array_equal(back[k], params[k]) for k in params)


def test_perturb_generator_matches_jax():
    from cyclegan_tpu.models import ResNetGenerator as JaxGenerator
    params = signal_flax_params(pc.GeneratorConfig(**GEN), 21,
                                trunk_impl="perturb")
    x = np.random.default_rng(22).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(
        np.float32)
    jax_layout = dict(MODULE_LAYOUT)
    want = np.asarray(JaxGenerator(config=jc.GeneratorConfig(**GEN),
                                   **jax_layout).apply(_tree(params),
                                                       jnp.asarray(x)))
    gen = ResNetGenerator(pc.GeneratorConfig(**GEN), device="cpu",
                          **MODULE_LAYOUT)
    gen.load_state_dict(generator_state_from_flax(params))
    with torch.no_grad():
        got = gen(torch.from_numpy(x)).numpy()
    assert 0.05 < np.std(want) and np.abs(want).max() < 0.999
    np.testing.assert_allclose(got, want, rtol=0, atol=FORWARD_ATOL)


def test_perturb_train_step_matches_jax():
    from tests.test_torch_port_layouts import (
        STEP_GEN,
        _step_configs,
        _step_signal,
        hold_step,
        jax_signal_step,
    )
    jax_cfg, port_cfg = _step_configs(LAYOUT)
    params, x, y = _step_signal()
    g = pc.GeneratorConfig(**STEP_GEN)
    params = dict(params, g=signal_flax_params(g, 1, trunk_impl="perturb"),
                  f=signal_flax_params(g, 2, trunk_impl="perturb"))
    w = np.ones(1, np.float32)
    grads, metrics, numpy_state = jax_signal_step(jax_cfg, params, x, y, w)
    hold_step(port_cfg, grads, metrics, numpy_state, x, y, w)


# -- the serving tier --------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _engines():
    base = signal_flax_params(pc.GeneratorConfig(**GEN), 30)
    perturb = signal_flax_params(pc.GeneratorConfig(**GEN), 31,
                                 trunk_impl="perturb")
    jax_cfg = jc.ModelConfig(generator=jc.GeneratorConfig(**GEN),
                             image_size=SIZE, **pc.KERNEL_LAYOUT)
    theirs = jax_engine.InferenceEngine(
        jax_cfg, _tree(base), perturb_params=_tree(perturb),
        serve_cfg=jax_engine.ServeConfig(batch_buckets=(1, 4), sizes=(SIZE,),
                                         perturb_tier=True))
    ours = InferenceEngine(
        pc.ModelConfig(generator=pc.GeneratorConfig(**GEN), image_size=SIZE,
                       **pc.KERNEL_LAYOUT),
        generator_state_from_flax(base),
        perturb_params=generator_state_from_flax(perturb),
        serve_cfg=ServeConfig(batch_buckets=(1, 4), sizes=(SIZE,),
                              perturb_tier=True), device="cpu")
    return ours, theirs


@pytest.mark.parametrize("n", [1, 3, 4])
def test_perturb_tier_matches_jax_engine(n):
    ours, theirs = _engines()
    x = np.random.default_rng(40 + n).uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(
        np.float32)
    (got,), n_ours = ours.run(x, tier="perturb")
    (want,), n_theirs = theirs.run(x.copy(), size=SIZE, tier="perturb")
    want = np.asarray(want)
    assert n_ours == n_theirs == n and got.shape[0] == want.shape[0] == (
        1 if n == 1 else 4)
    assert 0.05 < np.std(want[:n])
    np.testing.assert_allclose(got[:n].numpy(), want[:n], rtol=0,
                               atol=FORWARD_ATOL)
    (base,), _ = ours.run(x, tier="base")
    assert np.abs(base[:n].numpy() - got[:n].numpy()).max() > 0.05


def test_perturb_tier_resolves_and_refuses():
    ours, theirs = _engines()
    assert ours.tiers == theirs.tiers == ("base", "perturb")
    assert ours.resolve_tier("perturb") == "perturb"
    # epilogue is coerced to fused, the trunk unscanned.
    assert (ours.perturb_cfg.pad_impl, ours.perturb_cfg.trunk_impl) == (
        "fused", "perturb")
    assert ours.resident_weight_bytes("perturb") < ours.resident_weight_bytes(
        "base")
    state = generator_state_from_flax(random_flax_params(
        pc.GeneratorConfig(**GEN), 0))
    with pytest.raises(ValueError, match="perturb_params"):
        InferenceEngine(pc.ModelConfig(generator=pc.GeneratorConfig(**GEN)),
                        state, serve_cfg=ServeConfig(perturb_tier=True),
                        device="cpu")
    plain = InferenceEngine(pc.ModelConfig(generator=pc.GeneratorConfig(**GEN)),
                            state, serve_cfg=ServeConfig(sizes=(SIZE,)),
                            device="cpu")
    with pytest.raises(ValueError, match="perturb_tier=True"):
        plain.resolve_tier("perturb")
    with pytest.raises(ValueError, match="perturb_tier"):
        ServeConfig(perturb_tier=True, with_cycle=True)


def test_translate_from_a_perturb_ring(tmp_path, capsys):
    config = pc.Config(model=pc.ModelConfig(
        generator=pc.GeneratorConfig(**GEN), image_size=32, **LAYOUT))
    state = create_state(config, 5, device="cpu")
    Checkpointer(str(tmp_path / "run")).save(state, 0,
                                             meta=config.model_meta())
    os.makedirs(tmp_path / "in")
    image = np.random.default_rng(6).integers(0, 256, (40, 36, 3), np.uint8)
    np.save(tmp_path / "in" / "a.npy", image)
    g, f, model_cfg = translate.load_checkpoint(str(tmp_path / "run"))
    assert (model_cfg.trunk_impl, model_cfg.pad_impl) == ("perturb", "fused")
    assert layout_from_flax(g)["trunk_impl"] == "perturb"
    translate.main(["--output_dir", str(tmp_path / "run"), "--input",
                    str(tmp_path / "in"), "--output", str(tmp_path / "out"),
                    "--device", "cpu"])
    assert "translated 1 images" in capsys.readouterr().out
    assert os.listdir(tmp_path / "out") == ["a.png"]
    # A resume into the resnet trunk refuses the slot.
    resnet = create_state(pc.Config(model=pc.ModelConfig(
        generator=pc.GeneratorConfig(**GEN), image_size=32)), 0, device="cpu")
    with pytest.raises(ValueError, match="cannot change the trunk"):
        Checkpointer(str(tmp_path / "run")).restore(resnet)
