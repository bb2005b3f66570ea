"""The PyTorch port's serving engine and translate CLI, on the CPU.

The engine's bucket grammar (ragged tails zero-padded to a batch bucket,
``n_valid`` returned), the cycle pass, the refusal to move a "cuda"
request to the CPU, the port's copies of the JAX package's preprocessing
and output conversion, and the translate CLI end to end on PNG files with
weights written by ``np.savez`` from the JAX generator's init.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from cyclegan_tpu.data.augment import preprocess_test as jax_preprocess_test
from cyclegan_tpu.models import ResNetGenerator as JaxGenerator
from cyclegan_tpu.utils.plotting import to_uint8 as jax_to_uint8
from cyclegan_tpu_torch import translate
from cyclegan_tpu_torch.config import GeneratorConfig, ModelConfig
from cyclegan_tpu_torch.convert import generator_state_from_flax, random_flax_params
from cyclegan_tpu_torch.data.augment import preprocess_test
from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from cyclegan_tpu_torch.utils.plotting import to_uint8

TINY = GeneratorConfig(filters=8, num_residual_blocks=2)
SIZE = 32


def _engine(with_cycle=False, buckets=(1, 4)):
    g = generator_state_from_flax(random_flax_params(TINY, 0))
    f = generator_state_from_flax(random_flax_params(TINY, 1))
    return InferenceEngine(
        ModelConfig(generator=TINY, image_size=SIZE), g, f,
        serve_cfg=ServeConfig(batch_buckets=buckets, sizes=(SIZE,),
                              with_cycle=with_cycle),
        device="cpu")


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def test_ragged_flush_pads_to_bucket():
    engine = _engine()
    x = _images(3)
    (fake,), n_valid = engine.run(x)
    assert n_valid == 3 and tuple(fake.shape) == (4, SIZE, SIZE, 3)
    with torch.no_grad():
        direct = engine.generator(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(fake[:3].numpy(), direct, rtol=0, atol=1e-6)
    (single,), n1 = engine.run(x[:1])
    assert n1 == 1 and single.shape[0] == 1


def test_bucket_grammar():
    engine = _engine(buckets=(4, 1, 4))
    assert engine.max_batch == 4
    assert [engine.batch_bucket(n) for n in (1, 2, 4, 5)] == [1, 4, 4, None]
    assert engine.size_bucket(20, 31) == SIZE
    assert engine.size_bucket(500, 10) == SIZE
    with pytest.raises(ValueError, match="largest batch bucket"):
        engine.run(_images(5))
    with pytest.raises(ValueError, match="size bucket"):
        engine.run(_images(1), size=16)


def test_with_cycle_runs_both_generators():
    engine = _engine(with_cycle=True)
    x = _images(2, seed=1)
    (fake, cycled), n_valid = engine.run(x)
    assert n_valid == 2 and tuple(cycled.shape) == (4, SIZE, SIZE, 3)
    with torch.no_grad():
        want = engine.cycle_generator(engine.generator(torch.from_numpy(x)))
    np.testing.assert_allclose(cycled[:2].numpy(), want.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="bwd_state"):
        InferenceEngine(ModelConfig(generator=TINY), {}, None,
                        serve_cfg=ServeConfig(with_cycle=True), device="cpu")


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    state = generator_state_from_flax(random_flax_params(TINY, 0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(ModelConfig(generator=TINY), state)


def test_serve_config_rejects_bad_buckets():
    with pytest.raises(ValueError, match="non-empty"):
        ServeConfig(batch_buckets=())
    with pytest.raises(ValueError, match="positive"):
        ServeConfig(sizes=(256, 0))


def test_preprocess_and_to_uint8_match_jax():
    img = np.random.default_rng(2).integers(0, 256, (45, 70, 3)).astype(np.uint8)
    np.testing.assert_array_equal(preprocess_test(img, SIZE),
                                  jax_preprocess_test(img, SIZE))
    x = np.random.default_rng(3).uniform(-1.2, 1.2, (8, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_uint8(x), jax_to_uint8(x))


def _jax_init_params(seed):
    gen = JaxGenerator(config=JaxGeneratorConfig(filters=8, num_residual_blocks=2),
                       norm_impl="pallas", pad_impl="epilogue",
                       upsample_impl="zeroskip_fused")
    tree = gen.init(jax.random.PRNGKey(seed), jnp.zeros((1, SIZE, SIZE, 3)))
    return gen, tree, {k: np.asarray(v) for k, v in
                       traverse_util.flatten_dict(tree["params"], sep="/").items()}


def test_translate_cli_end_to_end(tmp_path):
    from PIL import Image

    _, g_tree, g_flat = _jax_init_params(0)
    gen, f_tree, f_flat = _jax_init_params(1)
    np.savez(tmp_path / "g.npz", **g_flat)
    np.savez(tmp_path / "f.npz", **f_flat)
    inp = tmp_path / "in"
    inp.mkdir()
    rng = np.random.default_rng(4)
    for name, hw in (("a.png", (40, 48)), ("b.png", (32, 32))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3)).astype(np.uint8)).save(inp / name)
    out = tmp_path / "out"
    translate.main(["--weights", str(tmp_path / "g.npz"), str(tmp_path / "f.npz"),
                    "--input", str(inp), "--output", str(out),
                    "--image_size", str(SIZE), "--batch_size", "4",
                    "--panels", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["a.png", "a_panel.png", "b.png", "b_panel.png"]
    with Image.open(out / "a_panel.png") as im:
        assert im.size == (3 * SIZE, SIZE)
    # The written translation is the JAX generator's output, to one
    # uint8 step (the f32 outputs agree to 1e-4 before rounding).
    x = preprocess_test(np.asarray(Image.open(inp / "a.png").convert("RGB")), SIZE)
    want = jax_to_uint8(np.asarray(gen.apply(g_tree, jnp.asarray(x[None])))[0])
    with Image.open(out / "a.png") as im:
        got = np.asarray(im)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_translate_from_seed_and_arrays(tmp_path):
    from PIL import Image

    inp = tmp_path / "one.png"
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(inp)
    translate.main(["--seed", "3", "--input", str(inp), "--output",
                    str(tmp_path / "out"), "--image_size", str(SIZE),
                    "--device", "cpu"])
    assert os.listdir(tmp_path / "out") == ["one.png"]
    np.savez(tmp_path / "g.npz", **random_flax_params(TINY, 0))
    with pytest.raises(SystemExit, match="both generators"):
        translate.main(["--weights", str(tmp_path / "g.npz"), "--input",
                        str(inp), "--output", str(tmp_path / "out2"),
                        "--direction", "BtoA", "--device", "cpu"])
    engine = _engine(with_cycle=True, buckets=(1, 2))
    fake, cycled = translate.translate_arrays(engine, _images(5, seed=5))
    assert fake.shape == cycled.shape == (5, SIZE, SIZE, 3)
    assert np.isfinite(fake).all() and np.abs(fake).max() <= 1.0
