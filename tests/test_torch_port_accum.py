"""The port's gradient accumulation (``grad_accum``) against the JAX
package's ``make_accum_train_step``, and against its own single big-batch
step, on the CPU.

The small CycleGAN, signal weights and tolerances of
tests/test_torch_port_train.py, with the health metrics on, over an
effective batch of 4 (A = 2 microbatches of 2, A = 4 of 1), w all ones
and with a padded row. The JAX side takes the batch as
``reshape(accum, -1, ...)``; the port takes the effective batch and cuts
microbatch i from rows [i * micro, (i + 1) * micro), the same rows.
Against the port's own big-batch step the bar is the JAX package's
(tests/test_accum.py): rtol 1e-5, atol 1e-6 on the metrics and the
gradients.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from cyclegan_tpu.train.steps import make_accum_train_step as jax_accum_step
from cyclegan_tpu_torch.convert import NETWORKS, state_from_flax
from cyclegan_tpu_torch.train.steps import (
    make_accum_grad_fn,
    make_accum_train_step,
    make_grad_fn,
    make_train_step,
)

from tests.test_torch_port_train import (
    CONFIG,
    JAX_CONFIG,
    SCALAR_TOL,
    _jax,
    _numpy_state,
)

EFFECTIVE = 4
EXACT_TOL = dict(rtol=1e-5, atol=1e-6)


def _config(base, accum, grad_impl="combined"):
    return dataclasses.replace(
        base, train=dataclasses.replace(base.train, grad_accum=accum,
                                        grad_impl=grad_impl),
        obs=dataclasses.replace(base.obs, health=True))


@functools.lru_cache(maxsize=None)
def _batch():
    rng = np.random.default_rng(9)
    return tuple(rng.uniform(-1, 1, (EFFECTIVE, 32, 32, 3)).astype(np.float32)
                 for _ in range(2))


@functools.lru_cache(maxsize=None)
def _jax_step(accum):
    return jax.jit(jax_accum_step(_config(JAX_CONFIG, accum), EFFECTIVE,
                                  accum))


def _port_state():
    return state_from_flax(_numpy_state(_jax()["signal"]), CONFIG,
                           device="cpu")


@pytest.mark.parametrize("accum", [2, 4])
@pytest.mark.parametrize("w", [[1, 1, 1, 1], [1, 1, 1, 0]])
def test_accum_step_matches_jax(accum, w):
    x, y = _batch()
    w = np.asarray(w, np.float32)
    split = lambda a: a.reshape(accum, -1, *a.shape[1:])  # noqa: E731
    _, want = _jax_step(accum)(_jax()["signal"], split(x), split(y), split(w))
    state, got = make_accum_train_step(_config(CONFIG, accum), EFFECTIVE,
                                       accum)(
        _port_state(), torch.from_numpy(x), torch.from_numpy(y),
        torch.from_numpy(w))
    assert set(got) == set(want)
    assert any(k.startswith("health/") for k in got)
    assert state.step == 1  # one update
    for k, v in want.items():
        tol = (dict(rtol=1e-3, atol=1e-6)
               if k.startswith(("health/gnorm", "health/upd_ratio"))
               else SCALAR_TOL)
        np.testing.assert_allclose(got[k].item(), float(v), err_msg=k, **tol)


@pytest.mark.parametrize("accum", [2, 4])
@pytest.mark.parametrize("grad_impl", ["combined", "fusedprop"])
def test_accum_equals_the_big_batch(accum, grad_impl):
    x, y = (torch.from_numpy(a) for a in _batch())
    w = torch.tensor([1, 1, 1, 0], dtype=torch.float32)
    state = _port_state()
    big_grads, big = make_grad_fn(_config(CONFIG, 1, grad_impl), EFFECTIVE)(
        state, x, y, w)
    acc_grads, acc = make_accum_grad_fn(_config(CONFIG, accum, grad_impl),
                                        EFFECTIVE, accum)(state, x, y, w)
    assert set(acc) == set(big)
    for k in big:
        np.testing.assert_allclose(acc[k].item(), big[k].item(), err_msg=k,
                                   **EXACT_TOL)
    for name, a, b in zip(NETWORKS, acc_grads, big_grads):
        for key in b:
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                       err_msg=f"{name} {key}", **EXACT_TOL)


def test_accum_refuses_a_batch_that_does_not_split():
    x, y = (torch.from_numpy(a[:3]) for a in _batch())
    step = make_accum_train_step(_config(CONFIG, 2), 3, 2)
    with pytest.raises(ValueError, match="does not split"):
        step(_port_state(), x, y, torch.ones(3))


def test_the_health_stats_of_an_accumulated_step_are_the_big_batchs():
    """The moments are linear, so they sum over the microbatches; the
    norms are taken after the sum, so they are the big batch's."""
    x, y = (torch.from_numpy(a) for a in _batch())
    w = torch.ones(EFFECTIVE)
    _, big = make_train_step(_config(CONFIG, 1), EFFECTIVE)(_port_state(),
                                                            x, y, w)
    _, acc = make_accum_train_step(_config(CONFIG, 2), EFFECTIVE, 2)(
        _port_state(), x, y, w)
    for k in big:
        # Adam's g / (|g| + eps) magnifies the rounding of tiny gradients.
        tol = (dict(rtol=1e-3, atol=1e-6) if k.startswith("health/upd_ratio")
               else EXACT_TOL)
        np.testing.assert_allclose(acc[k].item(), big[k].item(), err_msg=k,
                                   **tol)
