"""The port's FusedProp grad fn (``grad_impl="fusedprop"``) against the
JAX package's, and against the port's combined grad fn, on the CPU.

The small CycleGAN, inputs, weights and tolerances of
tests/test_torch_port_train.py (32², batch 2; scalars rtol 2e-5, atol
2e-6; gradient leaves rtol 1e-3, atol 3e-6; init and signal weights,
w = [1, 1] and [1, 0]), with the health metrics on, so the metric key
sets include the ``_health/`` moments. Against the port's own combined
grad fn the bar is the JAX package's for its two engines
(tests/test_fusedprop.py): rtol 1e-5, atol 1e-6.

The kernel sites are counted through their plain versions: each
discriminator runs twice a step, not three times, and the fake's graph is
pulled twice, which is what chip_smoke.py's launch counts assume.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from chip_smoke import train_launches_per_step
from cyclegan_tpu.train.steps import make_grad_fn as jax_grad_fn
from cyclegan_tpu.train.steps import make_train_step as jax_train_step
from cyclegan_tpu_torch.convert import NETWORKS, state_from_flax
from cyclegan_tpu_torch.ops import norm as port_norm
from cyclegan_tpu_torch.ops import upsample as port_upsample
from cyclegan_tpu_torch.train.steps import (
    METRIC_KEYS,
    make_accum_grad_fn,
    make_grad_fn,
    make_train_step,
)

from tests.test_torch_port_train import (
    BATCH,
    CONFIG,
    GRAD_TOL,
    JAX_CONFIG,
    SCALAR_TOL,
    _flat,
    _inputs,
    _jax,
    _numpy_state,
    _port_grads_as_flax,
)

ENGINE_TOL = dict(rtol=1e-5, atol=1e-6)


def _config(base, grad_impl, health=True):
    return dataclasses.replace(
        base, train=dataclasses.replace(base.train, grad_impl=grad_impl),
        obs=dataclasses.replace(base.obs, health=health))


FUSED = _config(CONFIG, "fusedprop")
COMBINED = _config(CONFIG, "combined")
JAX_FUSED = _config(JAX_CONFIG, "fusedprop")


@functools.lru_cache(maxsize=None)
def _jax_fused_grad_fn():
    return jax.jit(jax_grad_fn(JAX_FUSED, BATCH))


def _port_state(weights):
    return state_from_flax(_numpy_state(_jax()[weights]), CONFIG, device="cpu")


CASES = [("init", [1, 1]), ("signal", [1, 1]), ("signal", [1, 0])]


@pytest.mark.parametrize("weights,w", CASES)
def test_fusedprop_grads_and_metrics_match_jax(weights, w):
    w = np.asarray(w, np.float32)
    j = _jax()
    s = j[weights]
    grads, metrics = _jax_fused_grad_fn()(s.g_params, s.f_params, s.dx_params,
                                          s.dy_params, j["x"], j["y"], w)
    ours, our_metrics = make_grad_fn(FUSED, BATCH)(_port_state(weights),
                                                   *_inputs(w))
    assert set(our_metrics) == set(metrics)
    assert set(METRIC_KEYS) < set(metrics)
    assert any(k.startswith("_health/") for k in metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(our_metrics[k].item(), float(v),
                                   err_msg=k, **SCALAR_TOL)
    for name, mine, theirs in zip(NETWORKS, _port_grads_as_flax(ours), grads):
        theirs = _flat(theirs)
        assert mine.keys() == theirs.keys()
        for key, want in theirs.items():
            np.testing.assert_allclose(mine[key], want,
                                       err_msg=f"{name} {key}", **GRAD_TOL)


@pytest.mark.parametrize("weights,w", CASES)
def test_fusedprop_matches_the_combined_grad_fn(weights, w):
    w = np.asarray(w, np.float32)
    state = _port_state(weights)
    fused, m_f = make_grad_fn(FUSED, BATCH)(state, *_inputs(w))
    combined, m_c = make_grad_fn(COMBINED, BATCH)(state, *_inputs(w))
    assert set(m_f) == set(m_c)
    for k in m_c:
        np.testing.assert_allclose(m_f[k].item(), m_c[k].item(), err_msg=k,
                                   **ENGINE_TOL)
    for name, a, b in zip(NETWORKS, fused, combined):
        assert a.keys() == b.keys()
        for key in b:
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                       err_msg=f"{name} {key}", **ENGINE_TOL)


def test_fusedprop_train_step_matches_jax():
    """One whole step with the health metrics, finalized after the
    update: the same keys, the losses and moments at the scalar
    tolerance, the norm-based signals at the gradients' rtol."""
    w = np.ones(BATCH, np.float32)
    j = _jax()
    want = jax.jit(jax_train_step(JAX_FUSED, BATCH))(j["signal"], j["x"],
                                                     j["y"], w)[1]
    state, got = make_train_step(FUSED, BATCH)(_port_state("signal"),
                                               *_inputs(w))
    assert set(got) == set(want)
    assert state.step == 1
    for k, v in want.items():
        tol = (dict(rtol=1e-3, atol=1e-6)
               if k.startswith(("health/gnorm", "health/upd_ratio"))
               else SCALAR_TOL)
        np.testing.assert_allclose(got[k].item(), float(v), err_msg=k, **tol)
    assert got["health/nonfinite"].item() == 0


class _Counts:
    """Calls of each kernel site's plain version (what a launch is on the
    card), under chip_smoke.py's names."""

    SITES = {"instance_norm": (port_norm, "instance_norm_plain"),
             "instance_norm_backward": (port_norm,
                                        "instance_norm_backward_plain"),
             "epilogue": (port_norm, "instance_norm_act_pad_plain"),
             "epilogue_backward": (port_norm,
                                   "instance_norm_act_pad_backward_plain"),
             "upsample": (port_upsample, "upsample_norm_relu_pad_plain")}

    def __init__(self, monkeypatch):
        self.n = {k: 0 for k in self.SITES}
        for name, (module, attr) in self.SITES.items():
            monkeypatch.setattr(module, attr, self._wrap(name,
                                                         getattr(module, attr)))

    def _wrap(self, name, fn):
        def counted(*args, **kw):
            self.n[name] += 1
            return fn(*args, **kw)
        return counted


@pytest.mark.parametrize("grad_impl,accum", [("combined", 1),
                                             ("fusedprop", 1),
                                             ("fusedprop", 2)])
def test_kernel_sites_per_step_are_chip_smokes_launch_counts(
        monkeypatch, grad_impl, accum):
    config = _config(CONFIG, grad_impl)
    counts = _Counts(monkeypatch)
    w = np.ones(BATCH, np.float32)
    fn = (make_grad_fn(config, BATCH) if accum == 1
          else make_accum_grad_fn(config, BATCH, accum))
    fn(_port_state("signal"), *_inputs(w))
    per_step = train_launches_per_step(config)
    want = {k: accum * per_step[k] for k in counts.n}
    assert counts.n == want
    # The f32 step launches no other kernel (K6, the bf16 forms).
    assert not any(v for k, v in per_step.items() if k not in counts.n)
    d_sites = config.model.discriminator.num_downsampling
    combined = train_launches_per_step(COMBINED)
    if grad_impl == "fusedprop":
        # Two discriminator forwards a step fewer, the same backwards.
        assert combined["epilogue"] * accum - counts.n["epilogue"] == (
            2 * d_sites * accum)
        assert counts.n["epilogue_backward"] == (
            combined["epilogue_backward"] * accum)
