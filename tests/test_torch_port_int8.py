"""The PyTorch port's int8 and int8_fused serving tiers against the JAX
package, on the CPU.

K6's plain version (the int8 upsample kernel's arithmetic, which the port
runs on a CPU tensor) is held against the JAX Pallas kernel
``upsample_norm_relu_pad_pallas_int8`` in interpret mode, 1e-5 abs on
normalised outputs (f32; the two sum in another order), and against K5's
plain version over the dequantized kernel, 1e-5 (the scale applied after
the sum rounds unlike the scale applied to the weights). The port's
quantization equals the JAX package's ``quantize_params_int8`` bit for
bit. The engine's three tiers are held against a JAX ``InferenceEngine``
with both quantized tiers on the same numpy-seeded weights, 1e-4 abs on
the tanh output (the whole-generator tolerance of the port's generator
tests); the JAX engine runs the int8_fused tier's upsamples through its
CPU path (dequantize, then the XLA zero-skip). Each quantized tier stays
within chip_smoke.py's quality budget of the base tier (relative RMS
0.1), which a quantization that rounds down exceeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu.config import GeneratorConfig as JaxGeneratorConfig
from cyclegan_tpu.config import ModelConfig as JaxModelConfig
from cyclegan_tpu.ops.pallas.upsample_kernel import (
    upsample_norm_relu_pad_pallas_int8,
)
from cyclegan_tpu.serve import engine as jax_engine
from cyclegan_tpu_torch.config import (
    KERNEL_LAYOUT,
    GeneratorConfig,
    ModelConfig,
)
from cyclegan_tpu_torch.convert import (
    flax_from_quantized_state,
    generator_state_from_flax,
    quantized_state_from_flax,
    random_flax_params,
    signal_flax_params,
)
from cyclegan_tpu_torch.models import ResNetGenerator
from cyclegan_tpu_torch.models import quant as port_quant
from cyclegan_tpu_torch.models.quant import (
    dequantize_state,
    dequantize_state_except_upsample,
    quantize_state_int8,
)
from cyclegan_tpu_torch.ops.cuda import LAUNCHES
from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
    upsample_norm_relu_pad_int8_plain,
    upsample_norm_relu_pad_plain,
)
from cyclegan_tpu_torch.ops.upsample import upsample_norm_relu_pad_int8
from cyclegan_tpu_torch.serve import engine as engine_module
from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig

KERNEL_ATOL = 1e-5
TIER_ATOL = 1e-4
TINY = dict(filters=4, num_residual_blocks=1)
SIZE = 16


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 2 + 0.5).astype(np.float32) for s in shapes]


def _quantized(seed, cin, cout):
    """An int8 [3, 3, cin, cout] kernel and its [1, 1, 1, cout] scale from
    the JAX package's quantization."""
    kernel = np.random.default_rng(seed).standard_normal(
        (3, 3, cin, cout)).astype(np.float32) * 0.3
    leaf = jax_engine.quantize_params_int8({"k": jnp.asarray(kernel)})["k"]
    return np.array(leaf["int8_q"]), np.array(leaf["int8_scale"])


# -- K6's plain version ---------------------------------------------------

@pytest.mark.parametrize("shape,cout,pad", [
    ((1, 8, 8, 16), 8, 0),
    ((2, 4, 6, 8), 8, 1),
    ((1, 5, 7, 16), 8, 3),      # odd H and W
    ((1, 4, 4, 8), 160, 1),     # two 128-channel blocks of the TPU kernel
])
def test_int8_plain_matches_jax_kernel(shape, cout, pad):
    x, scale, bias = _arrays(0, shape, (cout,), (cout,))
    q, kscale = _quantized(1, shape[-1], cout)
    want = upsample_norm_relu_pad_pallas_int8(
        jnp.asarray(x), jnp.asarray(q), jnp.asarray(kscale),
        jnp.asarray(scale), jnp.asarray(bias), pad=pad, interpret=True)
    y, mean, inv = upsample_norm_relu_pad_int8_plain(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(kscale),
        torch.from_numpy(scale), torch.from_numpy(bias), pad)
    assert y.shape == want.shape and mean.shape == inv.shape == (shape[0], cout)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0,
                               atol=KERNEL_ATOL)
    got = upsample_norm_relu_pad_int8(
        torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(kscale),
        torch.from_numpy(scale), torch.from_numpy(bias), pad)
    np.testing.assert_array_equal(got.numpy(), y.numpy())


@pytest.mark.parametrize("pad", [0, 3])
def test_int8_plain_matches_f32_plain_over_dequantized_kernel(pad):
    x, scale, bias = _arrays(2, (2, 6, 5, 16), (12,), (12,))
    q, kscale = (torch.from_numpy(a) for a in _quantized(3, 16, 12))
    args = [torch.from_numpy(a) for a in (x, scale, bias)]
    got = upsample_norm_relu_pad_int8_plain(args[0], q, kscale, *args[1:], pad)
    want = upsample_norm_relu_pad_plain(args[0], q.float() * kscale, *args[1:],
                                        pad)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=KERNEL_ATOL)


def test_int8_op_refuses_float_kernels_and_gradients():
    x, scale, bias = (torch.from_numpy(a) for a in _arrays(4, (1, 4, 4, 8),
                                                           (8,), (8,)))
    q, kscale = (torch.from_numpy(a) for a in _quantized(5, 8, 8))
    with pytest.raises(TypeError, match="int8"):
        upsample_norm_relu_pad_int8(x, q.float(), kscale, scale, bias)
    with pytest.raises(TypeError, match="int8"):
        upsample_norm_relu_pad_int8_plain(x, q.float(), kscale, scale, bias)
    with pytest.raises(ValueError, match="scales"):
        upsample_norm_relu_pad_int8(x, q, kscale[..., :4], scale, bias)
    with pytest.raises(RuntimeError, match="forward-only"):
        upsample_norm_relu_pad_int8(x.requires_grad_(), q, kscale, scale, bias)
    with torch.no_grad():
        before = dict(LAUNCHES)
        upsample_norm_relu_pad_int8(x, q, kscale, scale, bias)
        assert LAUNCHES == before  # the CPU runs the plain version


# -- quantization and the quantized tree ------------------------------------

def _jax_quantized_flat(params):
    tree = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in params.items()}, sep="/")
    q = jax_engine.quantize_params_int8(tree)
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(q, sep="/").items()}


def test_quantization_is_bit_identical_to_jax():
    # One N(0, 0.02) full-width upsample kernel...
    k = np.random.default_rng(6).normal(0, 0.02, (3, 3, 256, 128)).astype(np.float32)
    want = jax_engine.quantize_params_int8({"k": jnp.asarray(k)})["k"]
    got = quantize_state_int8({"up.kernel": torch.from_numpy(k)})
    assert got["up.kernel.int8_q"].dtype == torch.int8
    np.testing.assert_array_equal(got["up.kernel.int8_q"].numpy(),
                                  np.asarray(want["int8_q"]))
    np.testing.assert_array_equal(got["up.kernel.int8_scale"].numpy(),
                                  np.asarray(want["int8_scale"]))
    # ...and every leaf of a generator, through convert.py both ways.
    params = signal_flax_params(GeneratorConfig(filters=8, num_residual_blocks=2), 7)
    want = _jax_quantized_flat(params)
    ours = flax_from_quantized_state(
        quantize_state_int8(generator_state_from_flax(params)))
    assert ours.keys() == want.keys()
    for key, value in want.items():
        assert ours[key].dtype == value.dtype, key
        np.testing.assert_array_equal(ours[key], value, err_msg=key)


def test_quantized_tree_round_trips_through_convert():
    params = random_flax_params(GeneratorConfig(**TINY), 8)
    flat = _jax_quantized_flat(params)
    state = quantized_state_from_flax(flat)
    assert state["Conv_0.weight.int8_q"].shape == (4, 3, 7, 7)
    assert state["Conv_0.weight.int8_scale"].shape == (4, 1, 1, 1)
    assert state["Upsample_0.ConvTranspose_0.kernel.int8_q"].shape == (3, 3, 16, 8)
    assert state["Upsample_0.ConvTranspose_0.kernel.int8_scale"].shape == (1, 1, 1, 8)
    back = flax_from_quantized_state(state)
    assert back.keys() == flat.keys()
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    # The fused tier's state loads into the int8 generator as it is.
    gen = ResNetGenerator(GeneratorConfig(**TINY), device="cpu",
                          upsample_impl="zeroskip_fused_int8",
                          norm_impl="pallas", pad_impl="epilogue")
    gen.load_state_dict(dequantize_state_except_upsample(state))
    key = "Upsample_1/ConvTranspose_0/kernel/int8_q"
    with pytest.raises(ValueError, match=key):
        quantized_state_from_flax(dict(flat, **{key: flat[key].astype(np.float32)}))
    with pytest.raises(KeyError, match="lacks"):
        quantized_state_from_flax({k: v for k, v in flat.items()
                                   if not k.endswith("int8_scale")})


def test_dequantize_keeps_only_upsample_kernels_int8():
    state = quantize_state_int8(generator_state_from_flax(
        random_flax_params(GeneratorConfig(**TINY), 9)))
    full = dequantize_state(state)
    fused = dequantize_state_except_upsample(state)
    assert all(v.dtype == torch.float32 for v in full.values())
    assert full.keys() == generator_state_from_flax(
        random_flax_params(GeneratorConfig(**TINY), 9)).keys()
    int8 = {k for k, v in fused.items() if v.dtype == torch.int8}
    assert int8 == {f"Upsample_{i}.ConvTranspose_0.kernel.int8_q" for i in (0, 1)}
    assert not any(k.endswith("ConvTranspose_0.kernel") for k in fused)
    # Widening is q * scale, the JAX package's order.
    key = "Conv_0.weight"
    torch.testing.assert_close(full[key], state[f"{key}.int8_q"].float()
                               * state[f"{key}.int8_scale"], rtol=0, atol=0)


# -- the engine's tiers against the JAX engine ------------------------------

@pytest.fixture(scope="module")
def engines():
    """The port's engine and the JAX engine, both with the int8 and
    int8_fused tiers, on the same signal weights."""
    params = signal_flax_params(GeneratorConfig(**TINY), 10)
    jax_cfg = JaxModelConfig(
        generator=JaxGeneratorConfig(**TINY), image_size=SIZE,
        instance_norm_impl="pallas", pad_impl="epilogue",
        upsample_impl="zeroskip_fused")
    tree = {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in params.items()}, sep="/")}
    jax_eng = jax_engine.InferenceEngine(
        jax_cfg, tree, serve_cfg=jax_engine.ServeConfig(
            batch_buckets=(1, 2), sizes=(SIZE,), dtype="float32",
            int8_tier=True, infer_tier=True))
    port = InferenceEngine(
        ModelConfig(generator=GeneratorConfig(**TINY), image_size=SIZE,
                    **KERNEL_LAYOUT),
        generator_state_from_flax(params),
        serve_cfg=ServeConfig(batch_buckets=(1, 2), sizes=(SIZE,),
                              int8_tier=True, infer_tier=True),
        device="cpu")
    return port, jax_eng


@pytest.mark.parametrize("tier", ["base", "int8", "int8_fused"])
def test_tiers_match_jax_engine(engines, tier):
    port, jax_eng = engines
    x = np.random.default_rng(11).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32)
    (got,), n = port.run(x, tier=tier)
    (want,), n_jax = jax_eng.run(x.copy(), size=SIZE, tier=tier)
    want = np.asarray(want)
    assert n == n_jax == 1 and tuple(got.shape) == want.shape == (1, SIZE, SIZE, 3)
    assert 0.05 < np.std(want[:1])  # a real signal
    np.testing.assert_allclose(got[:1].numpy(), want[:1], rtol=0, atol=TIER_ATOL)


def test_quantized_tiers_track_each_other(engines):
    port, _ = engines
    x = np.random.default_rng(12).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    out = {t: port.run(x, tier=t)[0][0].numpy() for t in port.tiers}
    # The same quantized math, the scale applied before or after the sum.
    np.testing.assert_allclose(out["int8_fused"], out["int8"], rtol=0,
                               atol=KERNEL_ATOL)
    assert 0 < np.abs(out["int8"] - out["base"]).max() < 0.2


def test_tiers_resolve_and_refuse(engines):
    port, jax_eng = engines
    assert port.tiers == jax_eng.tiers == ("base", "int8", "int8_fused")
    for tag in (None, "base", "float32", "int8", "int8_fused"):
        assert port.resolve_tier(tag) == jax_eng.resolve_tier(tag)
    for tag in ("perturb", "fp8"):
        with pytest.raises(ValueError):
            port.resolve_tier(tag)
    plain = InferenceEngine(
        ModelConfig(generator=GeneratorConfig(**TINY), image_size=SIZE),
        generator_state_from_flax(random_flax_params(GeneratorConfig(**TINY), 0)),
        serve_cfg=ServeConfig(batch_buckets=(1,), sizes=(SIZE,)), device="cpu")
    assert plain.tiers == ("base",)
    with pytest.raises(ValueError, match="int8_tier"):
        plain.resolve_tier("int8")
    with pytest.raises(ValueError, match="infer_tier"):
        plain.resolve_tier("int8_fused")


def test_quantized_tiers_keep_weights_int8(engines, monkeypatch):
    port, _ = engines
    # The only resident copy of the quantized kernels is int8: 4 B per f32
    # weight on the base tier against 1 B (plus scales and the 1-D leaves).
    base = port.resident_weight_bytes("base")
    assert port.resident_weight_bytes("int8") == port.resident_weight_bytes(
        "int8_fused") < base / 3
    # A flush of the fused tier widens no upsample kernel.
    widened = []
    real = port_quant._dequantize

    def spy(qstate, keep):
        out = real(qstate, keep)
        widened.extend(k for k in out if k not in qstate)
        return out

    monkeypatch.setattr(port_quant, "_dequantize", spy)
    x = np.zeros((1, SIZE, SIZE, 3), np.float32)
    port.run(x, tier="int8_fused")
    assert widened and not any("ConvTranspose_0" in k for k in widened)
    widened.clear()
    port.run(x, tier="int8")
    assert sum("ConvTranspose_0" in k for k in widened) == 2


# chip_smoke.py's budget for a quantized tier against the base tier: RMS of
# the difference over the RMS of the base output.
QUANT_REL_RMS_BUDGET = 0.1


def _round_down(quantize):
    """A broken quantization: ``quantize``'s scales, but each weight
    rounded down instead of to nearest."""
    def broken(state):
        out = quantize(state)
        for key in [k for k in out if k.endswith(".int8_q")]:
            base = key[: -len(".int8_q")]
            out[key] = torch.clamp(torch.floor(
                state[base] / out[f"{base}.int8_scale"]), -127, 127).to(torch.int8)
        return out
    return broken


@pytest.mark.parametrize("weights", ["init", "signal"])
def test_quantized_tiers_within_quality_budget(weights, monkeypatch):
    cfg = GeneratorConfig(filters=8, num_residual_blocks=2)
    params = (random_flax_params(cfg, 0) if weights == "init"
              else signal_flax_params(cfg, 2))
    x = np.random.default_rng(1).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)

    def rel_rms(quantize):
        monkeypatch.setattr(engine_module, "quantize_state_int8", quantize)
        eng = InferenceEngine(
            ModelConfig(generator=cfg, image_size=32, **KERNEL_LAYOUT),
            generator_state_from_flax(params),
            serve_cfg=ServeConfig(batch_buckets=(2,), sizes=(32,),
                                  int8_tier=True, infer_tier=True),
            device="cpu")
        base = eng.run(x)[0][0]
        return [((eng.run(x, tier=t)[0][0] - base).pow(2).mean().sqrt()
                 / base.pow(2).mean().sqrt()).item()
                for t in ("int8", "int8_fused")]

    assert max(rel_rms(quantize_state_int8)) <= QUANT_REL_RMS_BUDGET
    # The budget can fail: rounding down reads past it.
    assert min(rel_rms(_round_down(quantize_state_int8))) > QUANT_REL_RMS_BUDGET


@pytest.mark.parametrize("kw,match", [
    (dict(with_cycle=True, int8_tier=True), "int8_tier"),
    (dict(with_cycle=True, infer_tier=True), "infer_tier"),
    (dict(perturb_tier=True, with_cycle=True), "perturb_tier"),
    (dict(batch_buckets=(0,)), "positive"),
    (dict(dtype="float16"), "float32"),
])
def test_serve_config_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        ServeConfig(**kw)
    if "not ported" not in match:
        with pytest.raises(ValueError):
            jax_engine.ServeConfig(**kw)


def test_config_accepts_the_fused_tier_forms():
    # The fused tier is accepted where it is built, ServeConfig(infer_tier=
    # True); the JAX package's ModelConfig forms of that tier are refused
    # with a pointer to it; every training layout value is accepted.
    assert ServeConfig(infer_tier=True).infer_tier
    for field, value in (("instance_norm_impl", "pallas_fwd"),
                         ("instance_norm_impl", "auto_fwd"),
                         ("upsample_impl", "zeroskip_fused_int8")):
        with pytest.raises(ValueError, match="infer_tier=True"):
            ModelConfig(**{field: value})
    for field, value in (("instance_norm_impl", "auto"),
                         ("upsample_impl", "zeroskip")):
        assert getattr(ModelConfig(**{field: value}), field) == value
