"""The port's train step against the JAX package's, on the CPU.

A small CycleGAN (generators of 4 filters with 1 downsampling, 1 residual
and 1 upsampling block; discriminators of 4 filters with 3 downsampling
blocks; 32², batch 2) in the JAX package's kernel layout
(``instance_norm_impl="pallas"``, ``pad_impl="epilogue"``,
``upsample_impl="zeroskip_fused"``, ``grad_impl="combined"``; Pallas in
interpret mode). A JAX state goes to the port through
``convert.state_from_flax``; images come from a numpy seed.

Tolerances, as tests/test_torch_parity.py holds its torch reference
(f32 sums in another order): the ten loss scalars rtol 2e-5, atol 2e-6;
the four gradient trees leaf by leaf rtol 1e-3, atol 3e-6. At the init
distribution the discriminators output about 0 whatever they see, so
"signal" weights (convert.py) exercise the adversarial gradient, with
weights [1, 1] and [1, 0]. Adam is compared alone, on the same (JAX)
gradients, at 1e-7 abs: one Adam step maps a gradient of ~1e-6 through
g / (|g| + 1e-7), so post-update weights from independently computed
gradients would compare noise. Three whole steps of each side then agree
to rtol 1e-3 on the ten scalars.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from cyclegan_tpu import config as jc
from cyclegan_tpu.train.state import create_state as jax_create_state
from cyclegan_tpu.train.steps import make_cycle_step as jax_cycle_step
from cyclegan_tpu.train.steps import make_grad_fn as jax_grad_fn
from cyclegan_tpu.train.steps import make_test_step as jax_test_step
from cyclegan_tpu.train.steps import make_update_fn as jax_update_fn
from cyclegan_tpu_torch import config as pc
from cyclegan_tpu_torch.convert import (
    NETWORKS,
    discriminator_state_from_flax,
    flax_from_state_dict,
    generator_state_from_flax,
    signal_discriminator_flax_params,
    signal_flax_params,
    state_from_flax,
    state_to_flax,
)
from cyclegan_tpu_torch.ops.cuda import LAUNCHES
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.train.steps import (
    METRIC_KEYS,
    TEST_ERROR_KEYS,
    make_cycle_step,
    make_grad_fn,
    make_test_step,
    make_train_step,
    make_update_fn,
)

BATCH = 2
LAYOUT = dict(instance_norm_impl="pallas", pad_impl="epilogue",
              upsample_impl="zeroskip_fused")
JAX_CONFIG = jc.Config(
    model=jc.ModelConfig(
        generator=jc.GeneratorConfig(filters=4, num_downsampling_blocks=1,
                                     num_residual_blocks=1,
                                     num_upsample_blocks=1),
        discriminator=jc.DiscriminatorConfig(filters=4, num_downsampling=3),
        image_size=32, **LAYOUT),
    train=jc.TrainConfig(batch_size=BATCH, grad_impl="combined"),
    obs=jc.ObsConfig(health=False))
CONFIG = pc.Config(
    model=pc.ModelConfig(
        generator=pc.GeneratorConfig(filters=4, num_downsampling_blocks=1,
                                     num_residual_blocks=1,
                                     num_upsample_blocks=1),
        discriminator=pc.DiscriminatorConfig(filters=4, num_downsampling=3),
        image_size=32),
    train=pc.TrainConfig(batch_size=BATCH))
SCALAR_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=1e-3, atol=3e-6)


def _flat(tree):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(tree["params"], sep="/").items()}


def _tree(flat):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def _numpy_state(state):
    """A JAX CycleGANState as the numpy dict convert.state_from_flax
    reads; optax.adam's state is (ScaleByAdamState, EmptyState)."""
    out = {"step": int(state.step)}
    for name in NETWORKS:
        adam = getattr(state, f"{name}_opt")[0]
        out[f"{name}_params"] = _flat(getattr(state, f"{name}_params"))
        out[f"{name}_opt"] = {"count": int(adam.count), "mu": _flat(adam.mu),
                              "nu": _flat(adam.nu)}
    return out


def _with_params(jax_state, flat_params):
    """The JAX state with each network's parameters replaced."""
    return jax_state.replace(**{f"{n}_params": _tree(flat_params[n])
                                for n in NETWORKS})


def _port_grads_as_flax(grads):
    return [flax_from_state_dict(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _jax():
    """The JAX side, built and compiled once per test process."""
    init = jax_create_state(JAX_CONFIG, jax.random.PRNGKey(0))
    g, d = CONFIG.model.generator, CONFIG.model.discriminator
    signal = {"g": signal_flax_params(g, 1), "f": signal_flax_params(g, 2),
              "dx": signal_discriminator_flax_params(d, 3),
              "dy": signal_discriminator_flax_params(d, 4)}
    rng = np.random.default_rng(5)
    x, y = (rng.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32)
            for _ in range(2))
    return dict(init=init, signal=_with_params(init, signal), x=x, y=y,
                grad_fn=jax.jit(jax_grad_fn(JAX_CONFIG, BATCH)),
                update=jax.jit(jax_update_fn(JAX_CONFIG)))


def _jax_grads(state, w):
    j = _jax()
    grads, metrics = j["grad_fn"](state.g_params, state.f_params,
                                  state.dx_params, state.dy_params,
                                  j["x"], j["y"], w)
    return grads, {k: float(v) for k, v in metrics.items()}


def _inputs(w):
    j = _jax()
    return torch.from_numpy(j["x"]), torch.from_numpy(j["y"]), torch.from_numpy(w)


@pytest.mark.parametrize("weights,w", [("init", [1, 1]), ("signal", [1, 1]),
                                       ("signal", [1, 0])])
def test_grads_and_losses_match_jax(weights, w):
    w = np.asarray(w, np.float32)
    jax_state = _jax()[weights]
    grads, metrics = _jax_grads(jax_state, w)
    state = state_from_flax(_numpy_state(jax_state), CONFIG, device="cpu")
    ours, our_metrics = make_grad_fn(CONFIG, BATCH)(state, *_inputs(w))

    assert set(our_metrics) == set(METRIC_KEYS) == set(metrics)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(our_metrics[k].item(), metrics[k],
                                   err_msg=k, **SCALAR_TOL)
    if weights == "init":
        # The discriminators output ~0, so the adversarial terms are ~1.
        assert abs(metrics["loss_G/loss"] - 1.0) < 1e-3
    else:
        assert abs(metrics["loss_G/loss"] - 1.0) > 0.1
    for name, ours_flat, theirs in zip(NETWORKS, _port_grads_as_flax(ours), grads):
        theirs_flat = _flat(theirs)
        assert ours_flat.keys() == theirs_flat.keys()
        for key, want in theirs_flat.items():
            np.testing.assert_allclose(ours_flat[key], want,
                                       err_msg=f"{name} {key}", **GRAD_TOL)


def test_adam_matches_optax_on_the_same_gradients():
    """Two updates (count 0 -> 1 -> 2, so the bias correction changes)
    from the JAX gradients, converted, against optax."""
    w = np.ones(BATCH, np.float32)
    j = _jax()
    jax_state = j["signal"]
    grads, _ = _jax_grads(jax_state, w)
    state = state_from_flax(_numpy_state(jax_state), CONFIG, device="cpu")
    update = make_update_fn()
    for scale in (1.0, 0.5):
        step_grads = jax.tree.map(lambda g: g * scale, grads)
        jax_state = j["update"](jax_state, step_grads)
        port_grads = [
            (discriminator_state_from_flax if n.startswith("d")
             else generator_state_from_flax)(_flat(g))
            for n, g in zip(NETWORKS, step_grads)]
        state = update(state, port_grads)
    want, got = _numpy_state(jax_state), state_to_flax(state)
    assert got["step"] == want["step"] == 2
    for name in NETWORKS:
        assert got[f"{name}_opt"]["count"] == want[f"{name}_opt"]["count"] == 2
        for part, ours, theirs in (
                ("params", got[f"{name}_params"], want[f"{name}_params"]),
                ("mu", got[f"{name}_opt"]["mu"], want[f"{name}_opt"]["mu"]),
                ("nu", got[f"{name}_opt"]["nu"], want[f"{name}_opt"]["nu"])):
            for key in theirs:
                np.testing.assert_allclose(ours[key], theirs[key], rtol=0,
                                           atol=1e-7,
                                           err_msg=f"{name} {part} {key}")


def test_three_train_steps_match_jax():
    w = np.ones(BATCH, np.float32)
    j = _jax()
    jax_state = j["signal"]
    state = state_from_flax(_numpy_state(jax_state), CONFIG, device="cpu")
    train_step = make_train_step(CONFIG, BATCH)
    for step in range(3):
        grads, metrics = _jax_grads(jax_state, w)
        jax_state = j["update"](jax_state, grads)
        state, ours = train_step(state, *_inputs(w))
        for k in METRIC_KEYS:
            np.testing.assert_allclose(ours[k].item(), metrics[k], rtol=1e-3,
                                       err_msg=f"step {step} {k}")
    assert state.step == int(jax_state.step) == 3


def test_test_and_cycle_steps_match_jax():
    w = np.asarray([1, 0], np.float32)
    j = _jax()
    jax_state = j["signal"]
    want = jax.jit(jax_test_step(JAX_CONFIG, BATCH))(jax_state, j["x"], j["y"], w)
    want_images = jax.jit(jax_cycle_step(JAX_CONFIG))(jax_state, j["x"], j["y"])
    state = state_from_flax(_numpy_state(jax_state), CONFIG, device="cpu")
    x, y, wt = _inputs(w)
    got = make_test_step(CONFIG, BATCH)(state, x, y, wt)
    assert set(got) == set(METRIC_KEYS + TEST_ERROR_KEYS) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), err_msg=k,
                                   **SCALAR_TOL)
    # Images through up to two generators: the generator tests' 1e-4 abs.
    for ours, theirs in zip(make_cycle_step()(state, x, y), want_images):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                                   atol=1e-4)


def test_state_from_flax_round_trips():
    j = _jax()
    grads, _ = _jax_grads(j["signal"], np.ones(BATCH, np.float32))
    numpy_state = _numpy_state(j["update"](j["signal"], grads))
    assert numpy_state["g_opt"]["count"] == 1
    back = state_to_flax(state_from_flax(numpy_state, CONFIG, device="cpu"))
    assert back["step"] == numpy_state["step"] == 1
    for name in NETWORKS:
        assert back[f"{name}_opt"]["count"] == 1
        for part in ("mu", "nu"):
            mine, theirs = back[f"{name}_opt"][part], numpy_state[f"{name}_opt"][part]
            assert mine.keys() == theirs.keys()
            for key in theirs:
                np.testing.assert_array_equal(mine[key], theirs[key])
        for key, value in numpy_state[f"{name}_params"].items():
            np.testing.assert_array_equal(back[f"{name}_params"][key], value)


def test_create_state_is_seeded_and_steps_on_the_cpu_without_kernels():
    a, b = create_state(CONFIG, 7, device="cpu"), create_state(CONFIG, 7, device="cpu")
    c = create_state(CONFIG, 8, device="cpu")
    for name in NETWORKS:
        pa, pb, pc_ = (state_to_flax(s)[f"{name}_params"] for s in (a, b, c))
        assert all(np.array_equal(pa[k], pb[k]) for k in pa)
        assert not all(np.array_equal(pa[k], pc_[k]) for k in pa)
    assert state_to_flax(a)["g_opt"]["count"] == 0
    assert a.g_opt.defaults["eps"] == 1e-7
    assert a.g_opt.defaults["betas"] == (0.5, 0.9)
    before = dict(LAUNCHES)
    w = np.ones(BATCH, np.float32)
    a, metrics = make_train_step(CONFIG, BATCH)(a, *_inputs(w))
    assert a.step == 1 and set(metrics) == set(METRIC_KEYS)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert LAUNCHES == before
