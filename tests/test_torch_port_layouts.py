"""The port's model layouts against the JAX package, on the CPU.

Every layout of the JAX package's ``ModelConfig`` (``instance_norm_impl``
auto/xla/pallas, ``pad_mode`` reflect/zero, ``pad_impl`` pad/fused/
epilogue, ``upsample_impl`` dense/zeroskip/zeroskip_fused, ``remat``),
held against the JAX function of the same name, Pallas in interpret mode:

- the ops: the ``xla`` norm against ``_instance_norm_xla``, the ``xla``
  epilogue composition against ``instance_norm_act_pad(impl="xla")``,
  ``reflect_conv`` and ``conv_transpose_up2`` (dense, zeroskip), forward
  and VJP; ``epilogue_eligible``'s decisions on a table of shapes;
- the generator, the discriminator and the combined train step over the
  layout matrix, 64², generators of 8 filters and 2 residual blocks,
  discriminators of 8 filters, batch 1, signal weights (convert.py);
- each kernel site's launches (here: calls of the kernel's plain version)
  in a train step against ``models/layout.py``'s count, 0 for the JAX
  default layout; ``remat``'s gradients against the plain step's, bitwise;
- the config's refusals and the CLI's flags against the JAX package's.

Tolerances are the existing tests': the generator's and discriminator's
forward atol 1e-4 (tests/test_torch_port_generator.py), the ten losses
rtol 2e-5 / atol 2e-6 and the gradients rtol 1e-3 / atol 3e-6
(tests/test_torch_port_train.py); the ops rtol 0, atol 1e-5 for O(1)
values (f32 sums in another order). Dense and zeroskip are each held
against the JAX function of the same name, not against each other.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu import config as jc
from cyclegan_tpu.ops import norm as jax_norm
from cyclegan_tpu.ops import padding as jax_padding
from cyclegan_tpu.ops import upsample as jax_upsample
from cyclegan_tpu.train.state import build_models as jax_build_models
from cyclegan_tpu.train.state import create_state as jax_create_state
from cyclegan_tpu.train.steps import make_grad_fn as jax_grad_fn
from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch import main as port_main
from cyclegan_tpu_torch.convert import (
    NETWORKS,
    flax_from_state_dict,
    signal_discriminator_flax_params,
    signal_flax_params,
    state_from_flax,
)
from cyclegan_tpu_torch.models import layout as port_layout
from cyclegan_tpu_torch.ops import norm, padding, upsample
from cyclegan_tpu_torch.ops.cuda import epilogue_kernel, norm_kernel
from cyclegan_tpu_torch.ops.cuda import upsample_kernel
from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import epilogue_eligible
from cyclegan_tpu_torch.ops.padding import to_nchw, to_nhwc
from cyclegan_tpu_torch.train.state import build_models, create_state
from cyclegan_tpu_torch.train.steps import make_grad_fn

SIZE = 64
BATCH = 1
GEN = dict(filters=8, num_residual_blocks=2)
DISC = dict(filters=8)
STEP_SIZE = 32
STEP_GEN = dict(filters=4, num_downsampling_blocks=1, num_residual_blocks=2,
                num_upsample_blocks=1)
STEP_DISC = dict(filters=4)
FORWARD_ATOL = 1e-4
OP_TOL = dict(rtol=0, atol=1e-5)
SCALAR_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-3, atol=3e-6)
# The layout matrix: ModelConfig fields, the same names in both packages.
LAYOUTS = {
    "jax_default": {},
    "xla_fused_zeroskip": dict(instance_norm_impl="xla", pad_impl="fused",
                               upsample_impl="zeroskip"),
    "pallas_pad_dense": dict(instance_norm_impl="pallas", pad_impl="pad",
                             upsample_impl="dense"),
    "pallas_fused_zeroskip_fused": dict(instance_norm_impl="pallas",
                                        pad_impl="fused",
                                        upsample_impl="zeroskip_fused"),
    "auto_epilogue_dense": dict(instance_norm_impl="auto",
                                pad_impl="epilogue", upsample_impl="dense"),
    "pad_mode_zero": dict(pad_mode="zero"),
    "remat": dict(remat=True),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one CPU thread: the CPU is shared with other workers, and
    small convs on many threads wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(layout, size=SIZE, gen=GEN, disc=DISC):
    model = dict(image_size=size, **layout)
    jax_cfg = jc.Config(
        model=jc.ModelConfig(generator=jc.GeneratorConfig(**gen),
                             discriminator=jc.DiscriminatorConfig(**disc),
                             **model),
        train=jc.TrainConfig(batch_size=BATCH), obs=jc.ObsConfig(health=False))
    port_cfg = pc.Config(
        model=pc.ModelConfig(generator=pc.GeneratorConfig(**gen),
                             discriminator=pc.DiscriminatorConfig(**disc),
                             **model),
        train=pc.TrainConfig(batch_size=BATCH), obs=pc.ObsConfig(health=False))
    return jax_cfg, port_cfg


def _step_configs(layout):
    """The train step's comparison runs at tests/test_torch_port_train.py's
    size, for which GRAD_TOL was set: 32², generators of 4 filters with 1
    downsampling and 1 upsampling block (and 2 residual blocks, so that a
    scanned trunk has blocks to stack), discriminators of 4 filters: at 64²
    with 8 filters a step holds ~10^6 ReLU inputs, and the smallest lies
    within the two packages' f32 rounding (~1e-6) of the kink on most
    draws, so one element's ReLU takes the other branch and moves a norm
    bias's gradient by ~4e-3, past GRAD_TOL, with both answers right."""
    return _configs(layout, STEP_SIZE, STEP_GEN, STEP_DISC)


def _tree(flat):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree["params"], sep="/").items()}


def _rand(seed, *shape, offset=0.0):
    return (np.random.default_rng(seed).normal(size=shape) + offset).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the ops ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 5, 7, 8), (1, 16, 16, 32)])
def test_xla_norm_matches_jax(shape):
    x, g = _rand(1, *shape, offset=0.3), _rand(2, *shape)
    scale, bias = _rand(3, shape[-1], offset=1.0), _rand(4, shape[-1])
    want, vjp = jax.vjp(lambda *a: jax_norm._instance_norm_xla(*a, 1e-3),
                        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want_grads = vjp(jnp.asarray(g))
    args = [_t(a).requires_grad_() for a in (x, scale, bias)]
    got = norm.instance_norm(*args, impl="xla")
    got_grads = torch.autograd.grad(got, args, _t(g))
    np.testing.assert_allclose(got.detach().numpy(), want, **OP_TOL)
    for ours, theirs in zip(got_grads, want_grads):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-4)
    # "auto" is the same composition for a standalone norm.
    torch.testing.assert_close(norm.instance_norm(*args, impl="auto"), got,
                               rtol=0, atol=0)


def test_xla_norm_saves_x_params_and_stats_only():
    x = torch.randn(2, 4, 4, 8, requires_grad=True)
    scale = torch.randn(8, requires_grad=True)
    bias = torch.randn(8, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        norm.instance_norm(x, scale, bias, impl="xla")
    assert saved == [(2, 4, 4, 8), (8,), (8,), (2, 1, 1, 8), (2, 1, 1, 8)]


def test_xla_path_calls_no_plain_kernel_version(monkeypatch):
    """The "xla" norm and epilogue are the JAX package's composition on
    torch ops: no kernel's plain version (a test and yardstick only)."""
    for module in (norm, upsample, norm_kernel, epilogue_kernel,
                   upsample_kernel):
        for name in dir(module):
            if name.endswith("_plain"):
                monkeypatch.setattr(module, name, None)
    x = torch.randn(1, 6, 6, 8, requires_grad=True)
    s, b = torch.ones(8, requires_grad=True), torch.zeros(8, requires_grad=True)
    y = norm.instance_norm_act_pad(x, s, b, 1, impl="xla")
    y = norm.instance_norm(y, s, b, impl="xla")
    y.sum().backward()
    assert x.grad is not None


@pytest.mark.parametrize("pad,slope", [(0, 0.2), (1, 0.0), (3, 0.0)])
def test_xla_epilogue_matches_jax(pad, slope):
    shape = (2, 8, 9, 8)
    x, g = _rand(5, *shape), _rand(6, shape[0], 8 + 2 * pad, 9 + 2 * pad, 8)
    scale, bias = _rand(7, 8, offset=1.0), _rand(8, 8)
    fn = functools.partial(jax_norm.instance_norm_act_pad, pad=pad,
                           impl="xla", negative_slope=slope)
    want, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(scale),
                        jnp.asarray(bias))
    args = [_t(a).requires_grad_() for a in (x, scale, bias)]
    got = norm.instance_norm_act_pad(*args, pad, negative_slope=slope,
                                     impl="xla")
    np.testing.assert_allclose(got.detach().numpy(), want, **OP_TOL)
    for ours, theirs in zip(torch.autograd.grad(got, args, _t(g)),
                            vjp(jnp.asarray(g))):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("pad,shape", [(1, (2, 6, 7, 5)), (3, (1, 9, 12, 4)),
                                       (1, (1, 16, 16, 16))])
def test_reflect_conv_matches_jax(pad, shape):
    k = 2 * pad + 1
    x, kernel = _rand(9, *shape), _rand(10, k, k, shape[-1], 6) * 0.3
    g = _rand(11, *shape[:3], 6)
    want, vjp = jax.vjp(lambda a, b: jax_padding.reflect_conv(a, b, pad),
                        jnp.asarray(x), jnp.asarray(kernel))
    xt = _t(x).requires_grad_()
    kt = _t(kernel).requires_grad_()
    got = to_nhwc(padding.reflect_conv(to_nchw(xt), kt.permute(3, 2, 0, 1),
                                       pad))
    np.testing.assert_allclose(got.detach().numpy(), want, **OP_TOL)
    dx, dk = torch.autograd.grad(got, (xt, kt), _t(g))
    want_dx, want_dk = vjp(jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), want_dx, **OP_TOL)
    np.testing.assert_allclose(dk.numpy(), want_dk, rtol=0, atol=1e-4)


def test_reflect_conv_rejects_what_jax_rejects():
    x = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="kernel"):
        padding.reflect_conv(x, torch.zeros(3, 2, 5, 5), 1)
    with pytest.raises(ValueError, match="H, W > 2"):
        padding.reflect_conv(x, torch.zeros(3, 2, 7, 7), 3)


@pytest.mark.parametrize("impl", ["dense", "zeroskip"])
@pytest.mark.parametrize("shape,cout", [((2, 5, 7, 6), 4), ((1, 8, 8, 16), 8)])
def test_conv_transpose_up2_matches_jax(impl, shape, cout):
    x, kernel = _rand(12, *shape), _rand(13, 3, 3, shape[-1], cout) * 0.3
    n, h, w, _ = shape
    g = _rand(14, n, 2 * h, 2 * w, cout)
    want, vjp = jax.vjp(
        lambda a, b: jax_upsample.conv_transpose_up2(a, b, impl=impl),
        jnp.asarray(x), jnp.asarray(kernel))
    xt, kt = _t(x).requires_grad_(), _t(kernel).requires_grad_()
    got = upsample.conv_transpose_up2(xt, kt, impl)
    np.testing.assert_allclose(got.detach().numpy(), want, **OP_TOL)
    for ours, theirs in zip(torch.autograd.grad(got, (xt, kt), _t(g)),
                            vjp(jnp.asarray(g))):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-4)


@pytest.mark.parametrize("shape,dtype,pad,eligible", [
    ((1, 64, 64, 256), torch.float32, 1, True),
    ((1, 256, 256, 64), torch.float32, 3, True),
    ((1, 512, 512, 64), torch.float32, 3, True),
    ((1, 512, 512, 64), torch.bfloat16, 3, True),
    ((1, 1024, 1024, 64), torch.float32, 3, True),
    ((1, 2048, 2048, 64), torch.float32, 3, False),  # no plan fits
    ((1, 32, 32, 512), torch.float64, 0, True),  # references decide as f32
    ((1, 8, 8, 12), torch.bfloat16, 1, False),  # bf16 needs C % 8 == 0
    ((1, 8, 8, 12), torch.float32, 1, True),  # f32 takes 4-byte copies
    ((1, 3, 3, 8), torch.float32, 3, False),  # pad >= min(H, W)
    ((1, 64, 64, 256), torch.float16, 1, False),  # no f16 kernel
    ((64, 64, 256), torch.float32, 1, False),  # not NHWC
])
def test_epilogue_eligible_decisions(shape, dtype, pad, eligible):
    assert epilogue_eligible(shape, dtype, pad) is eligible


def test_eligibility_decides_each_epilogue_site(monkeypatch):
    """An epilogue site under "pallas" or "auto" runs the kernel (here its
    plain version) exactly where epilogue_eligible says so, and the
    composition elsewhere; under "xla" never the kernel."""
    calls = []
    real = norm.instance_norm_act_pad_plain
    monkeypatch.setattr(norm, "instance_norm_act_pad_plain",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x, s, b = torch.randn(1, 4, 4, 8), torch.ones(8), torch.zeros(8)
    for impl in ("pallas", "auto"):
        norm.instance_norm_act_pad(x, s, b, 1, impl=impl)
    monkeypatch.setattr(norm, "epilogue_eligible", lambda *a: False)
    norm.instance_norm_act_pad(x, s, b, 1, impl="pallas")
    monkeypatch.undo()
    norm.instance_norm_act_pad(x, s, b, 1, impl="xla")
    assert len(calls) == 2


# -- the networks and the train step over the layout matrix ---------------

@functools.lru_cache(maxsize=None)
def _signal(size=SIZE, gen=tuple(GEN.items()), disc=tuple(DISC.items())):
    g, d = pc.GeneratorConfig(**dict(gen)), pc.DiscriminatorConfig(**dict(disc))
    rng = np.random.default_rng(5)
    x, y = (rng.uniform(-1, 1, (BATCH, size, size, 3)).astype(np.float32)
            for _ in range(2))
    return ({"g": signal_flax_params(g, 1), "f": signal_flax_params(g, 2),
             "dx": signal_discriminator_flax_params(d, 3),
             "dy": signal_discriminator_flax_params(d, 4)}, x, y)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_generator_and_discriminator_match_jax(name):
    jax_cfg, port_cfg = _configs(LAYOUTS[name])
    params, x, _ = _signal()
    jax_gen, jax_disc = jax_build_models(jax_cfg)
    gen, _, disc, _ = build_models(port_cfg, "cpu")
    gen.load_state_dict(state_from_flax_params(params["g"]))
    disc.load_state_dict(state_from_flax_params(params["dx"], disc=True))
    with torch.no_grad():
        fake = gen(torch.from_numpy(x))
        logits = disc(fake)
    want_fake = np.asarray(jax_gen.apply(_tree(params["g"]), jnp.asarray(x)))
    # A real signal: spread, and not saturated in the tanh.
    assert 0.05 < np.std(want_fake) and np.mean(np.abs(want_fake) > 0.99) < 0.05
    np.testing.assert_allclose(fake.numpy(), want_fake, rtol=0,
                               atol=FORWARD_ATOL)
    want_logits = np.asarray(jax_disc.apply(_tree(params["dx"]),
                                            jnp.asarray(fake.numpy())))
    assert logits.shape == want_logits.shape == (BATCH, 8, 8, 1)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=0,
                               atol=FORWARD_ATOL)


def state_from_flax_params(flat, disc=False):
    from cyclegan_tpu_torch.convert import (
        discriminator_state_from_flax,
        generator_state_from_flax,
    )
    return (discriminator_state_from_flax if disc
            else generator_state_from_flax)(flat)


def _numpy_state(state):
    out = {"step": int(state.step)}
    for name in NETWORKS:
        adam = getattr(state, f"{name}_opt")[0]
        out[f"{name}_params"] = _flat(getattr(state, f"{name}_params"))
        out[f"{name}_opt"] = {"count": int(adam.count), "mu": _flat(adam.mu),
                              "nu": _flat(adam.nu)}
    return out


def jax_signal_step(jax_cfg, params, x, y, w):
    """The JAX grad fn's gradients (flat) and losses at ``params``, and
    the numpy form of its state with those parameters."""
    state = jax_create_state(jax_cfg, jax.random.PRNGKey(0))
    state = state.replace(**{f"{n}_params": _tree(params[n])
                             for n in NETWORKS})
    grads, metrics = jax.jit(jax_grad_fn(jax_cfg, BATCH))(
        state.g_params, state.f_params, state.dx_params, state.dy_params,
        x, y, w)
    return ([_flat(g) for g in grads], {k: float(v) for k, v in
                                        metrics.items()}, _numpy_state(state))


def hold_step(port_cfg, grads, metrics, numpy_state, x, y, w):
    """The port's grad fn from the same state against the JAX one's
    gradients and losses."""
    state = state_from_flax(numpy_state, port_cfg, device="cpu")
    ours, our_metrics = make_grad_fn(port_cfg, BATCH)(
        state, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w))
    assert set(our_metrics) == set(metrics)
    for k, want in metrics.items():
        np.testing.assert_allclose(our_metrics[k].item(), want, err_msg=k,
                                   **SCALAR_TOL)
    assert abs(metrics["loss_G/loss"] - 1.0) > 0.1  # a real adversarial signal
    for name, ours_tree, theirs in zip(NETWORKS, ours, grads):
        ours_flat = flax_from_state_dict(ours_tree)
        assert ours_flat.keys() == theirs.keys()
        for key, want in theirs.items():
            np.testing.assert_allclose(ours_flat[key], want,
                                       err_msg=f"{name} {key}", **GRAD_TOL)


def _step_signal():
    return _signal(STEP_SIZE, tuple(STEP_GEN.items()), tuple(STEP_DISC.items()))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_train_step_matches_jax(name):
    jax_cfg, port_cfg = _step_configs(LAYOUTS[name])
    params, x, y = _step_signal()
    w = np.ones(BATCH, np.float32)
    grads, metrics, numpy_state = jax_signal_step(jax_cfg, params, x, y, w)
    hold_step(port_cfg, grads, metrics, numpy_state, x, y, w)


# Each kernel's plain version, as the ops modules call it on the CPU, by
# the kernel's name in ops/cuda/LAUNCHES.
PLAIN_SITES = {
    "instance_norm": (norm, "instance_norm_plain"),
    "instance_norm_backward": (norm, "instance_norm_backward_plain"),
    "epilogue": (norm, "instance_norm_act_pad_plain"),
    "epilogue_backward": (norm, "instance_norm_act_pad_backward_plain"),
    "upsample": (upsample, "upsample_norm_relu_pad_plain"),
}


def count_plain_calls(monkeypatch) -> dict:
    counts = dict.fromkeys(PLAIN_SITES, 0)
    for kernel, (module, fname) in PLAIN_SITES.items():
        real = getattr(module, fname)

        def counted(*a, _real=real, _kernel=kernel, **k):
            counts[_kernel] += 1
            return _real(*a, **k)
        monkeypatch.setattr(module, fname, counted)
    return counts


LAUNCH_LAYOUTS = {**LAYOUTS, "kernel_layout": pc.KERNEL_LAYOUT,
                  "kernel_layout_remat": dict(pc.KERNEL_LAYOUT, remat=True),
                  "perturb_pallas": dict(trunk_impl="perturb",
                                         instance_norm_impl="pallas",
                                         pad_impl="fused")}


@pytest.mark.parametrize("name", list(LAUNCH_LAYOUTS))
def test_kernel_sites_match_the_layout_count(name, monkeypatch):
    _, port_cfg = _configs(LAUNCH_LAYOUTS[name])
    want = port_layout.train_step_launches(port_cfg)
    counts = count_plain_calls(monkeypatch)
    state = create_state(port_cfg, 0, device="cpu")
    x = torch.zeros(BATCH, SIZE, SIZE, 3)
    make_grad_fn(port_cfg, BATCH)(state, x, x, torch.ones(BATCH))
    assert counts == {k: want.get(k, 0) for k in counts}
    if name == "jax_default":
        assert not any(counts.values())
    if name == "kernel_layout":
        g, d = port_cfg.model.generator, port_cfg.model.discriminator
        assert counts["upsample"] == 6 * g.num_upsample_blocks
        assert counts["epilogue"] == (6 * g.num_residual_blocks
                                      + 6 * d.num_downsampling)


def test_remat_gradients_equal_the_plain_step_bitwise():
    _, plain_cfg = _configs(pc.KERNEL_LAYOUT)
    _, remat_cfg = _configs(dict(pc.KERNEL_LAYOUT, remat=True))
    params, x, y = _signal()
    w = torch.ones(BATCH)
    runs = []
    for cfg in (plain_cfg, remat_cfg):
        state = create_state(cfg, 0, device="cpu")
        for net, name in zip(state.networks, NETWORKS):
            net.load_state_dict(state_from_flax_params(
                params[name], disc=name.startswith("d")))
        runs.append(make_grad_fn(cfg, BATCH)(
            state, torch.from_numpy(x), torch.from_numpy(y), w))
    (plain, plain_metrics), (remat, remat_metrics) = runs
    for a, b in zip(plain, remat):
        assert a.keys() == b.keys()
        for key in a:
            assert torch.equal(a[key], b[key]), key
    for key in plain_metrics:
        assert torch.equal(plain_metrics[key], remat_metrics[key]), key


# -- the engine's int8 tier in the served layout ----------------------------

def test_int8_tier_in_the_dense_layout_matches_jax():
    """The int8 tier runs the served layout (here the JAX default: dense
    upsample, norms on torch ops) over the widened int8 weights, as the
    JAX engine's int8 tier does; the tanh output at atol 1e-4, the int8
    tests' tolerance (tests/test_torch_port_int8.py TIER_ATOL)."""
    from cyclegan_tpu.serve import engine as jax_engine
    from cyclegan_tpu_torch.convert import generator_state_from_flax
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig

    params = signal_flax_params(pc.GeneratorConfig(**GEN), 12)
    theirs = jax_engine.InferenceEngine(
        jc.ModelConfig(generator=jc.GeneratorConfig(**GEN), image_size=SIZE),
        _tree(params), serve_cfg=jax_engine.ServeConfig(
            batch_buckets=(1,), sizes=(SIZE,), int8_tier=True))
    ours = InferenceEngine(
        pc.ModelConfig(generator=pc.GeneratorConfig(**GEN), image_size=SIZE),
        generator_state_from_flax(params), serve_cfg=ServeConfig(
            batch_buckets=(1,), sizes=(SIZE,), int8_tier=True), device="cpu")
    x = np.random.default_rng(13).uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(
        np.float32)
    for tier in ("base", "int8"):
        (got,), _ = ours.run(x, tier=tier)
        (want,), _ = theirs.run(x.copy(), size=SIZE, tier=tier)
        want = np.asarray(want)
        assert 0.05 < np.std(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=FORWARD_ATOL, err_msg=tier)
    assert ours._skeletons["int8"].Upsample_0.impl == "dense"


# -- the config and the CLI --------------------------------------------------

REJECTED = [
    dict(pad_mode="zero", pad_impl="fused"),
    dict(pad_mode="zero", pad_impl="epilogue"),
    dict(pad_impl="epilogue", instance_norm_impl="xla"),
    dict(upsample_impl="zeroskip_fused", instance_norm_impl="xla"),
    dict(trunk_impl="perturb", scan_blocks=True),
    dict(trunk_impl="perturb", pad_impl="epilogue"),
    dict(spatial_impl="halo", pad_impl="fused"),
    dict(spatial_impl="halo", pad_impl="epilogue"),
    dict(pad_mode="Reflect"),
    dict(instance_norm_impl="fast"),
    dict(pad_impl="none"),
    dict(trunk_impl="dense"),
    dict(upsample_impl="bilinear"),
    dict(spatial_impl="mesh"),
]


@pytest.mark.parametrize("fields", REJECTED,
                         ids=["-".join(f"{k}={v}" for k, v in f.items())
                              for f in REJECTED])
def test_config_rejects_what_jax_rejects(fields):
    with pytest.raises(ValueError) as theirs:
        jc.ModelConfig(**fields)
    with pytest.raises(ValueError) as ours:
        pc.ModelConfig(**fields)
    first = str(theirs.value).split(":")[0].split(",")[0].split(" —")[0]
    assert first in str(ours.value)


def test_config_takes_every_layout_jax_takes():
    choices = dict(pad_mode=("reflect", "zero"),
                   instance_norm_impl=("auto", "xla", "pallas"),
                   pad_impl=("pad", "fused", "epilogue"),
                   trunk_impl=("resnet", "perturb"),
                   upsample_impl=("dense", "zeroskip", "zeroskip_fused"),
                   remat=(False, True), scan_blocks=(False, True))
    import itertools
    taken = 0
    for values in itertools.product(*choices.values()):
        fields = dict(zip(choices, values))
        try:
            jc.ModelConfig(**fields)
        except ValueError:
            with pytest.raises(ValueError):
                pc.ModelConfig(**fields)
            continue
        assert dataclasses.asdict(pc.ModelConfig(**fields)).items() >= \
            fields.items()
        taken += 1
    assert taken > 100
    for field in ("instance_norm_impl", "pad_mode", "pad_impl", "trunk_impl",
                  "upsample_impl", "remat", "scan_blocks", "spatial_impl"):
        assert (getattr(pc.ModelConfig(), field)
                == getattr(jc.ModelConfig(), field)), field
    with pytest.raises(ValueError, match="not ported yet"):
        pc.ModelConfig(spatial_impl="halo")


def test_epilogue_start_up_check_uses_the_kernel_plan(monkeypatch):
    assert pc.ModelConfig(**pc.KERNEL_LAYOUT, image_size=512)
    monkeypatch.setattr(epilogue_kernel, "epilogue_eligible",
                        lambda *a, **k: False)
    with pytest.raises(ValueError, match="pad_impl='epilogue' is ineligible"):
        pc.ModelConfig(pad_impl="epilogue")
    assert pc.ModelConfig(pad_impl="fused")


class _Parsed(Exception):
    pass


@functools.lru_cache(maxsize=None)
def _jax_parser():
    """The JAX CLI's parser: its main.py builds it under ``__main__``, so
    run that with ``parse_args`` raising the parser."""
    import argparse
    import os
    import runpy

    def grab(self, *args, **kwargs):
        raise _Parsed(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", grab)
        try:
            runpy.run_path(os.path.join(os.path.dirname(__file__), os.pardir,
                                        "main.py"), run_name="__main__")
        except _Parsed as e:
            return e.args[0]
    raise AssertionError("the JAX CLI built no parser")


@pytest.mark.parametrize("flag", ["--pad_mode", "--remat", "--scan_blocks",
                                  "--trunk_impl", "--norm_impl",
                                  "--pad_impl", "--upsample_impl"])
def test_cli_layout_flags_match_jax(flag):
    theirs = {a.option_strings[0]: a for a in _jax_parser()._actions
              if a.option_strings}
    ours = {a.option_strings[0]: a for a in port_main.build_parser()._actions
            if a.option_strings}
    assert ours[flag].default == theirs[flag].default
    assert ours[flag].choices == theirs[flag].choices
    assert type(ours[flag]) is type(theirs[flag])


def test_model_from_meta_reads_the_jax_default_meta():
    meta = jc.Config().model_meta()
    got = pc.Config.model_from_meta(meta)
    assert got == pc.ModelConfig()
    for field in ("instance_norm_impl", "pad_impl", "upsample_impl",
                  "pad_mode", "trunk_impl", "remat", "scan_blocks"):
        assert getattr(got, field) == meta["model"][field]
    perturb = jc.Config(model=jc.ModelConfig(
        trunk_impl="perturb", pad_impl="fused", image_size=128)).model_meta()
    got = pc.Config.model_from_cli_and_meta(perturb, filters=16,
                                            residual_blocks=3)
    assert (got.trunk_impl, got.pad_impl, got.image_size) == (
        "perturb", "fused", 128)
    assert got.generator.filters == got.discriminator.filters == 16
    assert got.generator.num_residual_blocks == 3
    assert pc.Config.model_from_cli_and_meta({}, scan_blocks=True).scan_blocks
