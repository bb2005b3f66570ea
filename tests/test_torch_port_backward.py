"""The port's backward ops against the JAX package, on the CPU.

The backward kernels' plain versions (K2: the instance-norm VJP, K4: the
epilogue's VJP) and the three ``torch.autograd.Function``s of
``cyclegan_tpu_torch/ops`` are held against ``jax.vjp`` of the JAX
package's Pallas entries, run in interpret mode as its own tests run them.
Inputs and cotangents come from a numpy seed and go to both sides.

Tolerances: dx (and the upsample's dkernel) rtol 2e-4, atol 5e-5; dscale
and dbias, sums over N*H*W terms that the two sides add in another order,
1e-4 of the sum of the terms' magnitudes (sum |g * xhat|, sum |g|).
float64 ``gradcheck`` on the three Functions is an independent check of
the hand-derived VJPs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.ops.pallas import epilogue_kernel as jax_epilogue
from cyclegan_tpu.ops.pallas import norm_kernel as jax_norm
from cyclegan_tpu.ops.pallas import upsample_kernel as jax_upsample
from cyclegan_tpu.ops.upsample import conv_transpose_zeroskip as jax_zeroskip
from cyclegan_tpu_torch.ops import norm, upsample
from cyclegan_tpu_torch.ops.cuda import LAUNCHES
from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
    instance_norm_act_pad_backward_cuda,
    instance_norm_act_pad_backward_plain,
    instance_norm_act_pad_plain,
    reflect_pad_transpose,
)
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
    instance_norm_backward_cuda,
    instance_norm_backward_plain,
    instance_norm_plain,
)
from cyclegan_tpu_torch.ops.padding import reflect_pad

RTOL, ATOL = 2e-4, 5e-5
SUM_TOL = 1e-4


def _inputs(seed, x_shape, g_shape, c):
    rng = np.random.default_rng(seed)
    # Conv-output-like activations (a mean away from 0), unit cotangents,
    # norm parameters around the signal-weight distribution.
    x = (rng.standard_normal(x_shape) * 2 + 0.5).astype(np.float32)
    g = rng.standard_normal(g_shape).astype(np.float32)
    scale = rng.normal(1.0, 0.3, (c,)).astype(np.float32)
    bias = rng.normal(0.0, 0.2, (c,)).astype(np.float32)
    return x, g, scale, bias


def _t(a):
    return torch.from_numpy(a)


def _close_sum(got, want, terms):
    """A reduction over N*H*W: 1e-4 of the sum of the terms' magnitudes."""
    tol = SUM_TOL * np.abs(terms).sum(axis=(0, 1, 2))
    assert np.all(np.abs(np.asarray(got) - np.asarray(want)) <= tol), (
        np.abs(np.asarray(got) - np.asarray(want)).max(), tol.min())


def _check_norm_grads(got, want, xhat, g_unpadded):
    """got/want: (dx, dscale, dbias); xhat and the cotangent that reaches
    the norm, for the reductions' tolerances."""
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=RTOL, atol=ATOL)
    _close_sum(got[1], want[1], g_unpadded * xhat)
    _close_sum(got[2], want[2], g_unpadded)


def _xhat(x):
    mean = x.mean(axis=(1, 2), keepdims=True)
    return (x - mean) / np.sqrt(((x - mean) ** 2).mean(axis=(1, 2), keepdims=True) + 1e-3)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (3, 9, 6, 8), (2, 7, 5, 40)])
def test_instance_norm_backward_matches_jax_kernel(shape):
    c = shape[-1]
    x, g, scale, bias = _inputs(0, shape, shape, c)
    _, pull = jax.vjp(lambda a, s, b: jax_norm.instance_norm_pallas(
        a, s, b, interpret=True), jnp.asarray(x), jnp.asarray(scale),
        jnp.asarray(bias))
    want = pull(jnp.asarray(g))

    _, mean, inv = instance_norm_plain(_t(x), _t(scale), _t(bias))
    dx, dscale_nc, dbias_nc = instance_norm_backward_plain(
        _t(x), _t(scale), mean, inv, _t(g))
    assert dscale_nc.shape == dbias_nc.shape == (shape[0], c)
    _check_norm_grads((dx, dscale_nc.sum(0), dbias_nc.sum(0)), want,
                      _xhat(x), g)

    # The same through the autograd Function.
    xs, ss, bs = (_t(a).requires_grad_() for a in (x, scale, bias))
    got = torch.autograd.grad(norm.instance_norm(xs, ss, bs), (xs, ss, bs),
                              _t(g))
    _check_norm_grads(got, want, _xhat(x), g)


def _epilogue_mask(x, scale, bias, slope):
    pre = _xhat(x) * scale + bias
    return np.where(pre > 0, 1.0, slope).astype(np.float32)


@pytest.mark.parametrize("shape,pad,slope", [
    ((2, 7, 9, 8), 3, 0.0),
    ((2, 7, 9, 8), 3, 0.2),
    ((1, 8, 8, 128), 3, 0.0),
    ((1, 4, 5, 8), 3, 0.2),
    ((2, 5, 6, 3), 1, 0.0),
    ((2, 6, 5, 40), 1, 0.2),
    ((3, 4, 4, 8), 0, 0.2),
    ((2, 6, 5, 3), 0, 0.0),
])
def test_epilogue_backward_matches_jax_kernel(shape, pad, slope):
    n, h, w, c = shape
    x, g, scale, bias = _inputs(1, shape, (n, h + 2 * pad, w + 2 * pad, c), c)
    _, pull = jax.vjp(lambda a, s, b: jax_epilogue.instance_norm_relu_pad_pallas(
        a, s, b, pad=pad, negative_slope=slope, interpret=True),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = pull(jnp.asarray(g))
    folded = reflect_pad_transpose(_t(g), pad).numpy()
    g_norm = folded * _epilogue_mask(x, scale, bias, slope)

    _, mean, inv = instance_norm_act_pad_plain(_t(x), _t(scale), _t(bias), pad,
                                               slope)
    dx, dscale_nc, dbias_nc = instance_norm_act_pad_backward_plain(
        _t(x), _t(scale), _t(bias), mean, inv, _t(g), pad, slope)
    _check_norm_grads((dx, dscale_nc.sum(0), dbias_nc.sum(0)), want,
                      _xhat(x), g_norm)

    xs, ss, bs = (_t(a).requires_grad_() for a in (x, scale, bias))
    y = norm.instance_norm_act_pad(xs, ss, bs, pad, negative_slope=slope)
    got = torch.autograd.grad(y, (xs, ss, bs), _t(g))
    _check_norm_grads(got, want, _xhat(x), g_norm)


@pytest.mark.parametrize("shape,pad", [((2, 5, 7, 3), 1), ((1, 4, 4, 2), 3),
                                       ((2, 7, 4, 1), 3), ((1, 6, 9, 2), 2)])
def test_reflect_pad_transpose_is_the_pads_adjoint(shape, pad):
    """<reflect_pad(a), b> == <a, fold(b)> for every a and b: the fold is
    exactly the transpose of the pad, bands and corners included."""
    rng = np.random.default_rng(2)
    a = _t(rng.standard_normal(shape))
    n, h, w, c = shape
    b = _t(rng.standard_normal((n, h + 2 * pad, w + 2 * pad, c)))
    lhs = (reflect_pad(a, pad) * b).sum().item()
    rhs = (a * reflect_pad_transpose(b, pad)).sum().item()
    assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("shape,cout,pad", [
    ((2, 4, 4, 8), 8, 0),
    ((1, 5, 3, 8), 4, 3),
    ((2, 3, 5, 3), 8, 3),
    ((1, 4, 6, 40), 8, 0),
])
def test_upsample_backward_matches_jax_kernel(shape, cout, pad):
    n, h, w, cin = shape
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    kernel = (rng.standard_normal((3, 3, cin, cout))
              / np.sqrt(4 * cin)).astype(np.float32)
    _, g, scale, bias = _inputs(4, (1,), (n, 2 * h + 2 * pad, 2 * w + 2 * pad,
                                          cout), cout)
    _, pull = jax.vjp(lambda a, k, s, b: jax_upsample.upsample_norm_relu_pad_pallas(
        a, k, s, b, pad=pad, interpret=True), jnp.asarray(x),
        jnp.asarray(kernel), jnp.asarray(scale), jnp.asarray(bias))
    want_dx, want_dk, want_ds, want_db = pull(jnp.asarray(g))

    args = [_t(a).requires_grad_() for a in (x, kernel, scale, bias)]
    y = upsample.upsample_norm_relu_pad(*args, pad)
    dx, dk, ds, db = torch.autograd.grad(y, args, _t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), rtol=RTOL, atol=ATOL)
    conv = upsample.conv_transpose_zeroskip(_t(x), _t(kernel)).numpy()
    g_norm = reflect_pad_transpose(_t(g), pad).numpy() * _epilogue_mask(
        conv, scale, bias, 0.0)
    _close_sum(ds, want_ds, g_norm * _xhat(conv))
    _close_sum(db, want_db, g_norm)


@pytest.mark.parametrize("shape,cout", [((2, 4, 4, 8), 6), ((1, 3, 5, 3), 4)])
def test_conv_transpose_vjp_matches_jax(shape, cout):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    kernel = rng.standard_normal((3, 3, shape[-1], cout)).astype(np.float32)
    g = rng.standard_normal((shape[0], 2 * shape[1], 2 * shape[2], cout)
                            ).astype(np.float32)
    _, pull = jax.vjp(jax_zeroskip, jnp.asarray(x), jnp.asarray(kernel))
    want_dx, want_dk = pull(jnp.asarray(g))
    dx, dk = upsample.conv_transpose_vjp(_t(x), _t(kernel), _t(g))
    assert dx.shape == x.shape and dk.shape == kernel.shape
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(want_dk), rtol=RTOL, atol=ATOL)


def _f64(seed, *shapes):
    gen = torch.Generator().manual_seed(seed)
    return [(torch.randn(s, generator=gen, dtype=torch.float64) + 0.3
             ).requires_grad_() for s in shapes]


def test_instance_norm_gradcheck():
    args = _f64(6, (2, 3, 4, 3), (3,), (3,))
    assert torch.autograd.gradcheck(norm.instance_norm, args)


@pytest.mark.parametrize("pad,slope", [(0, 0.2), (1, 0.0), (3, 0.2), (3, 0.0)])
def test_epilogue_gradcheck(pad, slope):
    args = _f64(7, (2, 4, 5, 3), (3,), (3,))
    assert torch.autograd.gradcheck(
        lambda x, s, b: norm.instance_norm_act_pad(x, s, b, pad,
                                                   negative_slope=slope), args)


@pytest.mark.parametrize("pad", [0, 3])
def test_upsample_gradcheck(pad):
    args = _f64(8, (2, 2, 3, 3), (3, 3, 3, 2), (2,), (2,))
    assert torch.autograd.gradcheck(
        lambda x, k, s, b: upsample.upsample_norm_relu_pad(x, k, s, b, pad), args)


def test_no_grad_paths_save_nothing():
    """Under inference_mode (serving) and no_grad, and with no input that
    wants a gradient, the ops run their forwards alone: no autograd node,
    nothing saved."""
    x, _, scale, bias = _inputs(9, (1, 4, 4, 8), (1,), 8)
    params = [torch.nn.Parameter(_t(a)) for a in (scale, bias)]
    kernel = torch.nn.Parameter(torch.zeros(3, 3, 8, 4))
    up_params = [torch.nn.Parameter(torch.ones(4)), torch.nn.Parameter(torch.zeros(4))]
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            assert norm.instance_norm(_t(x), *params).grad_fn is None
            assert norm.instance_norm_act_pad(_t(x), *params, 1).grad_fn is None
            assert upsample.upsample_norm_relu_pad(_t(x), kernel, *up_params,
                                                   3).grad_fn is None
    assert norm.instance_norm(_t(x), _t(scale), _t(bias)).grad_fn is None
    y = norm.instance_norm_act_pad(_t(x), *params, 1)
    assert type(y.grad_fn).__name__ == "_InstanceNormActPadBackward"


def test_backward_wrappers_reject_cpu_and_bad_inputs():
    before = dict(LAUNCHES)
    x, g, scale, bias = _inputs(10, (1, 4, 4, 8), (1, 6, 6, 8), 8)
    stats = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="CUDA"):
        instance_norm_backward_cuda(_t(x), _t(scale), stats, stats, _t(x))
    with pytest.raises(ValueError, match="CUDA"):
        instance_norm_act_pad_backward_cuda(_t(x), _t(scale), _t(bias), stats,
                                            stats, _t(g), 1)
    with pytest.raises(ValueError, match="reflect pad"):
        instance_norm_act_pad_backward_plain(_t(x), _t(scale), _t(bias), stats,
                                             stats, _t(g), 4)
    assert LAUNCHES == before
