"""The port's bfloat16 compute against the JAX package's, on the CPU.

The same numpy-seeded inputs and the same f32 parameters go to the JAX
package in bfloat16 compute (``compute_dtype="bfloat16"`` / bf16 inputs,
its Pallas kernels in interpret mode, as its own bf16 tests run them) and
to the port with ``device="cpu"``, where every kernel site runs its bf16
plain version. Small sizes: filters 8, 1-2 residual blocks, 32² images.

Tolerances, and why:
- each kernel module (K1-K5, plain bf16 against the JAX kernel in bf16):
  the f32 statistics and dscale/dbias at rtol 1e-5, atol 1e-6 (f32 sums in
  another order); the bf16 outputs (y, dx) equal or at most 2 bf16 ulps of
  the larger magnitude apart, never held tighter than 1e-5 (near zero a
  cancelling f32 sum's rounding exceeds a bf16 ulp of the result). K5's y
  may also move by one bf16 ulp of its conv output times inv * scale: the
  conv output is rounded to bf16 from f32 sums taken in another order, and
  one ulp there is more than one ulp of a normalised value near zero.
- the generator, the discriminator and the train steps (combined,
  FusedProp, ``grad_accum=2``): XLA on the CPU may keep f32 inside a fusion
  where torch rounds after each op, so each quantity is held by a ratio:
  the port's bf16 result may be no farther from the JAX package's bf16
  result than RATIO times the JAX package's own bf16-to-f32 distance, plus
  FLOOR. Distances are relative L2 for tensors (images, logits, each
  gradient leaf) and relative to the f32 value for the ten loss scalars.
  RATIO is 3, not 2: two bf16 computations that round at different places
  are two draws of bf16 noise, and on gradient leaves that sum as few as 64
  terms (the discriminators' first norm at 32²) that noise is 6-16% of the
  leaf. Over four draws of the images the port's distance from the JAX
  bf16 result was a median 0.81-1.03 and a largest 1.85-2.23 times the
  JAX package's own distance, and the port's own bf16-to-f32 distance a
  median 0.96-0.98 times the JAX package's. FLOOR is 1e-2, between two and
  three bf16 ulps relative: a one-element leaf (a discriminator's head
  bias) whose JAX bf16 value happens to round next to its f32 value leaves
  no reach to scale, and torch's and XLA's bf16 reductions there differed
  by 2.3 ulps.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu import config as jc
from cyclegan_tpu.models import PatchGANDiscriminator as JaxDiscriminator
from cyclegan_tpu.models import ResNetGenerator as JaxGenerator
from cyclegan_tpu.ops.pallas import epilogue_kernel as jax_epilogue
from cyclegan_tpu.ops.pallas import norm_kernel as jax_norm
from cyclegan_tpu.ops.pallas import upsample_kernel as jax_upsample
from cyclegan_tpu.train.state import create_state as jax_create_state
from cyclegan_tpu.train.steps import make_accum_train_step as jax_accum_step
from cyclegan_tpu.train.steps import make_grad_fn as jax_grad_fn
from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch import translate
from cyclegan_tpu_torch.convert import (
    NETWORKS,
    discriminator_state_from_flax,
    flax_from_state_dict,
    generator_state_from_flax,
    signal_discriminator_flax_params,
    signal_flax_params,
    state_from_flax,
)
from cyclegan_tpu_torch.models import PatchGANDiscriminator, ResNetGenerator
from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
    instance_norm_act_pad_backward_plain,
    instance_norm_act_pad_plain,
)
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
    instance_norm_backward_plain,
    instance_norm_plain,
)
from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
    upsample_norm_relu_pad_plain,
)
from cyclegan_tpu_torch.serve import server
from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
from cyclegan_tpu_torch.train.steps import (
    METRIC_KEYS,
    make_accum_grad_fn,
    make_accum_train_step,
    make_grad_fn,
)
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer

BF16 = torch.bfloat16
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_FLOOR = 1e-5
RATIO, FLOOR = 3.0, 1e-2
SIZE, BATCH = 32, 2
GEN = dict(filters=8, num_residual_blocks=2)
DISC = dict(filters=8)
LAYOUT = dict(instance_norm_impl="pallas", pad_impl="epilogue",
              upsample_impl="zeroskip_fused")
MODULE_LAYOUT = dict(norm_impl="pallas", pad_impl="epilogue")


# -- helpers ---------------------------------------------------------------

def _rng_arrays(seed, *shapes, shift=0.5, spread=2.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * spread + shift).astype(np.float32)
            for s in shapes]


def _both(a, bf16=True):
    """One numpy array as (jax, torch) arrays, both rounded to bf16 from
    the same f32 values (round to nearest even on both sides)."""
    j, t = jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))
    return (j.astype(jnp.bfloat16), t.to(BF16)) if bf16 else (j, t)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if isinstance(
        a, jax.Array) else a.float().numpy()


def _bf16_close(ours, theirs, extra=0.0):
    """ours and theirs (bf16) equal, or at most 2 bf16 ulps of the larger
    magnitude apart, never held tighter than BF16_FLOOR; plus ``extra``
    (per element) where given."""
    a, b = _f32(ours), _f32(theirs)
    assert a.shape == b.shape
    m = np.maximum(np.abs(a), np.abs(b))
    _, e = np.frexp(m)
    tol = np.maximum(np.ldexp(2.0, e - 8), BF16_FLOOR) + extra
    bad = np.abs(a - b) > tol
    assert not bad.any(), (f"{bad.sum()} of {bad.size} elements past 2 bf16 "
                           f"ulps; worst {np.abs(a - b).max()}")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _hold_ratio(ours, jax_bf16, jax_f32, what):
    """The port's bf16 result against the JAX package's, by RATIO times the
    JAX package's own bf16-to-f32 distance plus FLOOR."""
    err, reach = _rel(ours, jax_bf16), _rel(jax_bf16, jax_f32)
    assert err <= RATIO * reach + FLOOR, (what, err, reach)


def _tree(flat):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in
            traverse_util.flatten_dict(tree["params"], sep="/").items()}


# -- each kernel module ----------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 9, 7, 40)])
def test_k1_instance_norm_matches_jax_in_bf16(shape):
    x, s, b = _rng_arrays(0, shape, shape[-1:], shape[-1:])
    (xj, xt), (sj, st), (bj, bt) = _both(x), _both(s, False), _both(b, False)
    yj, mj, ij = jax_norm._forward(xj, sj, bj, 1e-3, True)
    yt, mt, it = instance_norm_plain(xt, st, bt)
    assert yt.dtype == BF16 and mt.dtype == it.dtype == torch.float32
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj).reshape(mt.shape),
                               **STATS_TOL)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij).reshape(it.shape),
                               **STATS_TOL)
    _bf16_close(yt, yj)


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 9, 7, 40)])
def test_k2_instance_norm_backward_matches_jax_in_bf16(shape):
    x, s, g = _rng_arrays(1, shape, shape[-1:], shape)
    (xj, xt), (sj, st), (gj, gt) = _both(x), _both(s, False), _both(g)
    _, mt, it = instance_norm_plain(xt, st, st)
    mj, ij = jnp.asarray(mt.numpy()), jnp.asarray(it.numpy())
    n, c = shape[0], shape[-1]
    dxj, dsj, dbj = jax_norm._backward(xj, sj, mj.reshape(n, 1, c),
                                       ij.reshape(n, 1, c), gj, True)
    dxt, dst, dbt = instance_norm_backward_plain(xt, st, mt, it, gt)
    assert dxt.dtype == BF16 and dst.dtype == torch.float32
    np.testing.assert_allclose(dst.numpy(), np.asarray(dsj).reshape(n, c),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dbt.numpy(), np.asarray(dbj).reshape(n, c),
                               rtol=1e-5, atol=1e-4)
    _bf16_close(dxt, dxj)


@pytest.mark.parametrize("shape,pad,slope", [((2, 8, 8, 64), 1, 0.0),
                                             ((1, 9, 7, 40), 3, 0.0),
                                             ((2, 8, 8, 32), 0, 0.2)])
def test_k3_epilogue_matches_jax_in_bf16(shape, pad, slope):
    x, s, b = _rng_arrays(2, shape, shape[-1:], shape[-1:])
    (xj, xt), (sj, st), (bj, bt) = _both(x), _both(s, False), _both(b, False)
    yj, mj, ij = jax_epilogue._forward(xj, sj, bj, 1e-3, pad, slope, True)
    yt, mt, it = instance_norm_act_pad_plain(xt, st, bt, pad, slope)
    assert yt.dtype == BF16
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj).reshape(mt.shape),
                               **STATS_TOL)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij).reshape(it.shape),
                               **STATS_TOL)
    _bf16_close(yt, yj)


@pytest.mark.parametrize("shape,pad,slope", [((2, 8, 8, 64), 1, 0.0),
                                             ((1, 9, 7, 40), 3, 0.2),
                                             ((2, 8, 8, 32), 0, 0.2)])
def test_k4_epilogue_backward_matches_jax_in_bf16(shape, pad, slope):
    n, h, w, c = shape
    x, s, b, g = _rng_arrays(3, shape, (c,), (c,),
                             (n, h + 2 * pad, w + 2 * pad, c))
    (xj, xt), (gj, gt) = _both(x), _both(g)
    (sj, st), (bj, bt) = _both(s, False), _both(b, False)
    _, mt, it = instance_norm_plain(xt, st, bt)
    mj, ij = jnp.asarray(mt.numpy()), jnp.asarray(it.numpy())
    dxj, dsj, dbj = jax_epilogue._backward(xj, sj, bj, mj, ij, gj, pad, slope,
                                           True)
    dxt, dst, dbt = instance_norm_act_pad_backward_plain(xt, st, bt, mt, it, gt,
                                                         pad, slope)
    assert dxt.dtype == BF16
    np.testing.assert_allclose(dst.numpy(), np.asarray(dsj).reshape(n, c),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(dbt.numpy(), np.asarray(dbj).reshape(n, c),
                               rtol=1e-5, atol=1e-4)
    _bf16_close(dxt, dxj)


@pytest.mark.parametrize("shape,cout,pad", [((1, 8, 8, 16), 16, 0),
                                            ((2, 8, 8, 32), 16, 3)])
def test_k5_upsample_matches_jax_in_bf16(shape, cout, pad):
    x, k, s, b = _rng_arrays(4, shape, (3, 3, shape[-1], cout), (cout,),
                             (cout,))
    k = k / np.float32(np.sqrt(9 * shape[-1]))
    (xj, xt), (kj, kt) = _both(x), _both(k)
    (sj, st), (bj, bt) = _both(s, False), _both(b, False)
    yj, mj, ij = jax_upsample._forward(xj, kj, sj, bj, 1e-3, pad, True)
    yt, mt, it, conv = upsample_norm_relu_pad_plain(xt, kt, st, bt, pad,
                                                    keep_conv=True)
    assert yt.dtype == conv.dtype == BF16
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj).reshape(mt.shape),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij).reshape(it.shape),
                               rtol=1e-4, atol=1e-5)
    # One bf16 ulp of the conv output, through inv * scale, at each output
    # (reflect-padded as y is).
    c = conv.float()
    _, e = torch.frexp(c.abs())
    moved = torch.ldexp(torch.ones_like(c), e - 8) * (it[:, None, None, :]
                                                     * st).abs()
    moved = torch.nn.functional.pad(moved.permute(0, 3, 1, 2),
                                    (pad,) * 4, mode="reflect") if pad else \
        moved.permute(0, 3, 1, 2)
    _bf16_close(yt, yj, extra=moved.permute(0, 2, 3, 1).numpy())


# -- the generator and the discriminator ------------------------------------

@pytest.fixture(scope="module")
def generator_case():
    params = signal_flax_params(pc.GeneratorConfig(**GEN), 31)
    x = np.random.default_rng(32).uniform(-1, 1, (BATCH, SIZE, SIZE, 3)
                                          ).astype(np.float32)
    want = {}
    for dtype in (jnp.bfloat16, None):
        gen = JaxGenerator(config=jc.GeneratorConfig(**GEN), dtype=dtype,
                           **MODULE_LAYOUT, upsample_impl="zeroskip_fused")
        out = gen.apply(_tree(params), jnp.asarray(x))
        assert out.dtype == jnp.float32
        want[dtype] = np.asarray(out)
    return params, x, want


def test_generator_matches_jax_in_bf16(generator_case):
    params, x, want = generator_case
    gen = ResNetGenerator(pc.GeneratorConfig(**GEN), device="cpu", dtype=BF16,
                          **MODULE_LAYOUT, upsample_impl="zeroskip_fused")
    gen.load_state_dict(generator_state_from_flax(params))
    assert all(p.dtype == torch.float32 for p in gen.parameters())
    with torch.no_grad():
        ours = gen(torch.from_numpy(x))
    assert ours.dtype == torch.float32
    _hold_ratio(ours.numpy(), want[jnp.bfloat16], want[None], "generator")
    # bf16 is bf16: the port's output is not the f32 one.
    assert _rel(ours.numpy(), want[None]) > 1e-4


def test_discriminator_matches_jax_in_bf16():
    params = signal_discriminator_flax_params(pc.DiscriminatorConfig(**DISC),
                                              33)
    x = np.random.default_rng(34).uniform(-1, 1, (BATCH, SIZE, SIZE, 3)
                                          ).astype(np.float32)
    want = {}
    for dtype in (jnp.bfloat16, None):
        disc = JaxDiscriminator(config=jc.DiscriminatorConfig(**DISC),
                                dtype=dtype, **MODULE_LAYOUT)
        want[dtype] = np.asarray(disc.apply(_tree(params), jnp.asarray(x)))
    ours = PatchGANDiscriminator(pc.DiscriminatorConfig(**DISC), device="cpu",
                                 dtype=BF16, **MODULE_LAYOUT)
    ours.load_state_dict(discriminator_state_from_flax(params))
    with torch.no_grad():
        logits = ours(torch.from_numpy(x))
    assert logits.dtype == torch.float32
    _hold_ratio(logits.numpy(), want[jnp.bfloat16], want[None],
                "discriminator")


@pytest.mark.parametrize("layout", [
    {}, dict(trunk_impl="perturb", norm_impl="pallas", pad_impl="fused")],
    ids=["jax_default", "perturb"])
def test_other_layouts_match_jax_in_bf16(layout):
    """The JAX default layout (standalone norms on torch ops, cuDNN's dense
    upsample) and the perturb trunk (its masks and activations cast to
    bf16 before the add, JAX ``modules.py:350-353``), held as the kernel
    layout's generator is."""
    trunk = {"trunk_impl": layout["trunk_impl"]} if layout else {}
    params = signal_flax_params(pc.GeneratorConfig(**GEN), 35, **trunk)
    x = np.random.default_rng(36).uniform(-1, 1, (BATCH, SIZE, SIZE, 3)
                                          ).astype(np.float32)
    want = {dtype: np.asarray(JaxGenerator(
        config=jc.GeneratorConfig(**GEN), dtype=dtype, **layout).apply(
            _tree(params), jnp.asarray(x))) for dtype in (jnp.bfloat16, None)}
    gen = ResNetGenerator(pc.GeneratorConfig(**GEN), device="cpu", dtype=BF16,
                          **layout)
    gen.load_state_dict(generator_state_from_flax(params))
    with torch.no_grad():
        ours = gen(torch.from_numpy(x))
    assert ours.dtype == torch.float32
    _hold_ratio(ours.numpy(), want[jnp.bfloat16], want[None], "generator")
    assert _rel(ours.numpy(), want[None]) > 1e-4


# -- train steps -----------------------------------------------------------

def _configs(dtype, grad_impl="combined", accum=1):
    jax_cfg = jc.Config(
        model=jc.ModelConfig(generator=jc.GeneratorConfig(**GEN),
                             discriminator=jc.DiscriminatorConfig(**DISC),
                             image_size=SIZE, compute_dtype=dtype, **LAYOUT),
        train=jc.TrainConfig(batch_size=BATCH, grad_impl=grad_impl,
                             grad_accum=accum),
        obs=jc.ObsConfig(health=False))
    port_cfg = pc.Config(
        model=pc.ModelConfig(generator=pc.GeneratorConfig(**GEN),
                             discriminator=pc.DiscriminatorConfig(**DISC),
                             image_size=SIZE, compute_dtype=dtype, **LAYOUT),
        train=pc.TrainConfig(batch_size=BATCH, grad_impl=grad_impl,
                             grad_accum=accum),
        obs=pc.ObsConfig(health=False))
    return jax_cfg, port_cfg


@functools.lru_cache(maxsize=None)
def _signal_params():
    g, d = pc.GeneratorConfig(**GEN), pc.DiscriminatorConfig(**DISC)
    return {"g": signal_flax_params(g, 41), "f": signal_flax_params(g, 42),
            "dx": signal_discriminator_flax_params(d, 43),
            "dy": signal_discriminator_flax_params(d, 44)}


@functools.lru_cache(maxsize=None)
def _images(n):
    rng = np.random.default_rng(45)
    return tuple(rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
                 for _ in range(2))


def _port_state(config):
    """The port's state at the signal weights (optimizer state fresh)."""
    numpy_state = {"step": 0}
    for name, params in _signal_params().items():
        numpy_state[f"{name}_params"] = params
        numpy_state[f"{name}_opt"] = {
            "count": 0, "mu": {k: np.zeros_like(v) for k, v in params.items()},
            "nu": {k: np.zeros_like(v) for k, v in params.items()}}
    return state_from_flax(numpy_state, config, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_grads(dtype, grad_impl, n, micro):
    """The JAX package's gradients and losses at the signal weights over
    the first n images, summed over microbatches of ``micro`` (with the
    losses' global batch n), as its accumulated step sums them."""
    jax_cfg, _ = _configs(dtype, grad_impl)
    fn = jax.jit(jax_grad_fn(jax_cfg, n))
    p = {k: _tree(v) for k, v in _signal_params().items()}
    x, y = _images(n)
    grads, metrics = None, None
    for i in range(0, n, micro):
        g_i, m_i = fn(p["g"], p["f"], p["dx"], p["dy"], x[i:i + micro],
                      y[i:i + micro], np.ones(micro, np.float32))
        g_i = [_flat(t) for t in g_i]
        m_i = {k: float(v) for k, v in m_i.items()}
        if grads is None:
            grads, metrics = g_i, m_i
        else:
            grads = [{k: a[k] + b[k] for k in a} for a, b in zip(grads, g_i)]
            metrics = {k: metrics[k] + m_i[k] for k in metrics}
    return grads, metrics


def _hold_step(grads, metrics, dtype_pair):
    bf16, f32 = dtype_pair
    for k in METRIC_KEYS:
        err = abs(metrics[k].item() - bf16[1][k])
        reach = abs(bf16[1][k] - f32[1][k])
        assert err <= RATIO * reach + FLOOR * abs(f32[1][k]), (k, err, reach)
    for name, ours, theirs, ref in zip(NETWORKS, grads, bf16[0], f32[0]):
        ours = flax_from_state_dict(ours)
        assert ours.keys() == theirs.keys()
        for key in theirs:
            assert ours[key].dtype == np.float32
            _hold_ratio(ours[key], theirs[key], ref[key], f"{name} {key}")


@pytest.mark.parametrize("grad_impl", ["combined", "fusedprop"])
def test_train_step_grads_and_losses_match_jax_in_bf16(grad_impl):
    _, port_cfg = _configs("bfloat16", grad_impl)
    x, y = (torch.from_numpy(a) for a in _images(BATCH))
    grads, metrics = make_grad_fn(port_cfg, BATCH)(
        _port_state(port_cfg), x, y, torch.ones(BATCH))
    _hold_step(grads, metrics,
               (_jax_grads("bfloat16", grad_impl, BATCH, BATCH),
                _jax_grads("float32", grad_impl, BATCH, BATCH)))


def test_accumulated_step_matches_jax_in_bf16():
    """grad_accum=2 over a batch of 4: the port's summed microbatch
    gradients against the JAX package's, and the accumulated train step's
    losses against the JAX accumulated step's."""
    n, accum = 2 * BATCH, 2
    jax_cfg, port_cfg = _configs("bfloat16", accum=accum)
    x, y = _images(n)
    grads, metrics = make_accum_grad_fn(port_cfg, n, accum)(
        _port_state(port_cfg), torch.from_numpy(x), torch.from_numpy(y),
        torch.ones(n))
    pair = (_jax_grads("bfloat16", "combined", n, n // accum),
            _jax_grads("float32", "combined", n, n // accum))
    _hold_step(grads, metrics, pair)
    split = lambda a: a.reshape(accum, -1, *a.shape[1:])  # noqa: E731
    jax_state = jax_create_state(jax_cfg, jax.random.PRNGKey(0)).replace(
        **{f"{k}_params": _tree(v) for k, v in _signal_params().items()})
    _, want = jax.jit(jax_accum_step(jax_cfg, n, accum))(
        jax_state, split(x), split(y), split(np.ones(n, np.float32)))
    state, got = make_accum_train_step(port_cfg, n, accum)(
        _port_state(port_cfg), torch.from_numpy(x), torch.from_numpy(y),
        torch.ones(n))
    assert state.step == 1
    for k in METRIC_KEYS:
        assert float(want[k]) == pytest.approx(pair[0][1][k], rel=1e-5)
        err, reach = abs(got[k].item() - float(want[k])), abs(
            pair[0][1][k] - pair[1][1][k])
        assert err <= RATIO * reach + FLOOR * abs(pair[1][1][k]), k


# -- serving and translating from a bf16 ring ------------------------------

def _write_bf16_ring(root):
    config = pc.Config(model=pc.ModelConfig(
        generator=pc.GeneratorConfig(**GEN),
        discriminator=pc.DiscriminatorConfig(**DISC), image_size=SIZE,
        compute_dtype="bfloat16", **LAYOUT))
    state = _port_state(config)
    Checkpointer(str(root)).save(state, 0, meta=config.model_meta())
    return config, state


def test_bf16_ring_serves_and_translates_in_bf16(tmp_path, monkeypatch, capsys):
    config, state = _write_bf16_ring(tmp_path / "run")
    images = (np.random.default_rng(46).uniform(0, 255, (2, SIZE, SIZE, 3))
              .astype(np.uint8))
    (tmp_path / "in").mkdir()
    for i, image in enumerate(images):
        np.save(tmp_path / "in" / f"img{i}.npy", image)
    g = generator_state_from_flax(flax_from_state_dict(state.g.state_dict()))
    engines = {dtype: InferenceEngine(
        pc.ModelConfig(generator=config.model.generator, image_size=SIZE,
                       **LAYOUT), g,
        serve_cfg=ServeConfig(batch_buckets=(1, 8), sizes=(SIZE,),
                              dtype=dtype), device="cpu")
        for dtype in ("bfloat16", "float32")}
    for dtype in ("bfloat16", None):
        out = tmp_path / f"out_{dtype}"
        translate.main(["--output_dir", str(tmp_path / "run"), "--input",
                        str(tmp_path / "in"), "--output", str(out),
                        "--device", "cpu"]
                       + (["--dtype", dtype] if dtype else []))
        assert "bfloat16)" in capsys.readouterr().out
    from cyclegan_tpu_torch.data.augment import preprocess_test
    from cyclegan_tpu_torch.utils.plotting import to_uint8
    batch = np.stack([preprocess_test(im, SIZE) for im in images])
    want = {d: e.run(batch)[0][0].numpy() for d, e in engines.items()}
    assert not np.array_equal(to_uint8(want["bfloat16"][0]),
                              to_uint8(want["float32"][0]))
    from PIL import Image
    for dtype in ("bfloat16", None):
        for i in range(2):
            png = np.asarray(Image.open(tmp_path / f"out_{dtype}" / f"img{i}.png"))
            np.testing.assert_array_equal(png, to_uint8(want["bfloat16"][i]))
    # The server reads the ring's dtype for its base tier; the int8 tiers
    # stay f32.
    built = []
    make = server.make_server

    def make_and_stop(executor, *args, **kw):
        httpd, app = make(executor, *args, **kw)
        built.append(executor.engine)

        def stop():
            raise KeyboardInterrupt
        httpd.serve_forever, httpd.shutdown = stop, lambda: None
        return httpd, app

    monkeypatch.setattr(server, "make_server", make_and_stop)
    server.main(["--output_dir", str(tmp_path / "run"), "--port", "0",
                 "--int8", "--int8_fused", "--device", "cpu"])
    engine = built[0]
    assert engine.serve_cfg.dtype == engine.model_cfg.compute_dtype == "bfloat16"
    assert engine.generator.dtype == BF16
    np.testing.assert_array_equal(engine.run(batch)[0][0].numpy(),
                                  want["bfloat16"])
    f32 = InferenceEngine(
        pc.ModelConfig(generator=config.model.generator, image_size=SIZE,
                       **LAYOUT), g,
        serve_cfg=ServeConfig(batch_buckets=(1, 8), sizes=(SIZE,),
                              int8_tier=True, infer_tier=True), device="cpu")
    for tier in ("int8", "int8_fused"):
        assert engine._skeletons[tier].dtype is None
        np.testing.assert_array_equal(engine.run(batch, tier=tier)[0][0].numpy(),
                                      f32.run(batch, tier=tier)[0][0].numpy())


def test_configs_take_bf16_and_params_do_not_depend_on_it():
    assert pc.ModelConfig(compute_dtype="bfloat16").compute_dtype == "bfloat16"
    assert ServeConfig(dtype="bfloat16").dtype == "bfloat16"
    with pytest.raises(ValueError, match="unknown compute_dtype"):
        pc.ModelConfig(compute_dtype="float16")
    shapes = [{k: (v.shape, v.dtype) for k, v in ResNetGenerator(
        pc.GeneratorConfig(**GEN), device="meta", dtype=dtype).state_dict(
        ).items()} for dtype in (None, BF16)]
    assert shapes[0] == shapes[1]
