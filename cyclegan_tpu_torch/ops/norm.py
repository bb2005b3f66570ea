"""Instance norm and the fused conv epilogue for NHWC tensors.

The counterparts of the JAX package's ``ops/norm.py`` ``instance_norm``
and ``instance_norm_act_pad``: per-(sample, channel) statistics over H
and W, biased variance, eps 1e-3, all in f32, for f32 or bf16 activations
(a bf16 output rounded once; scale, bias and their gradients f32, dx in
the activations' type). Each takes ``impl``, with the JAX semantics
(``ops/norm.py:126-229``):

- ``"pallas"``: the hand-written kernel (``ops/cuda/``). On a CUDA tensor
  the standalone norm launches K1, the epilogue K3; on a CPU tensor each
  runs its kernel's plain version. Nothing falls back: a kernel that fails
  raises.
- ``"xla"``: the JAX package's own composition without a kernel
  (``_build_xla``, ``:79-111``), as torch ops: a
  ``torch.autograd.Function`` whose forward computes in f32 and saves only
  ``x`` in its own dtype, ``scale``, ``bias`` and the per-(n, c) ``mean``
  and ``inv``, and whose backward is JAX ``instance_norm_backward``
  (``:54-76``). The epilogue under ``"xla"`` is that norm, then the
  (leaky) ReLU and the reflect pad as torch ops.
- ``"auto"``: ``"xla"`` for the standalone norm (JAX ``:142``); at an
  epilogue site, K3 wherever ``epilogue_eligible`` says the port's K3 takes
  the shape, else the ``"xla"`` composition. Eligibility is a pure function
  of shape, dtype and pad, decided before any launch; ``"pallas"``
  epilogue sites follow the same rule, as in the JAX package.

The functions default to ``"pallas"``, the kernel ops themselves; the
modules pass their layout's impl, whose default is the JAX package's
``"auto"`` (models/modules.py).

With a kernel and where a gradient is wanted, each function is a
``torch.autograd.Function`` as the JAX package's are ``jax.custom_vjp``s:
the forward is the forward kernel and saves ``x``, the parameters and the
per-(n, c) ``mean`` and ``inv``; the backward is the backward kernel (K2
for the norm, K4 for the epilogue), whose per-(n, c) dscale and dbias
partials are summed over N here, as the JAX package's ``norm_kernel.py``
does. Without a gradient (``inference_mode``, ``no_grad``, or no input
that requires one) the forward kernel runs alone and nothing is saved.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
    epilogue_eligible,
    instance_norm_act_pad_backward_cuda,
    instance_norm_act_pad_backward_plain,
    instance_norm_act_pad_cuda,
    instance_norm_act_pad_plain,
)
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
    instance_norm_backward_cuda,
    instance_norm_backward_plain,
    instance_norm_cuda,
    instance_norm_plain,
)
from cyclegan_tpu_torch.ops.padding import reflect_pad

NORM_IMPLS = ("pallas", "xla", "auto")


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an op on these inputs."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def instance_norm_act_pad_backward(x: torch.Tensor, scale: torch.Tensor,
                                   bias: torch.Tensor, mean: torch.Tensor,
                                   inv: torch.Tensor, g: torch.Tensor,
                                   pad: int, negative_slope: float = 0.0):
    """The epilogue's VJP: (dx, dscale, dbias) with dscale and dbias [C]."""
    fn = (instance_norm_act_pad_backward_cuda if on_card(x)
          else instance_norm_act_pad_backward_plain)
    dx, dscale_nc, dbias_nc = fn(x, scale, bias, mean, inv, g.contiguous(),
                                 pad, negative_slope)
    return dx, dscale_nc.sum(0), dbias_nc.sum(0)


class _InstanceNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        fn = instance_norm_cuda if on_card(x) else instance_norm_plain
        y, mean, inv = fn(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, mean, inv = ctx.saved_tensors
        fn = (instance_norm_backward_cuda if on_card(x)
              else instance_norm_backward_plain)
        dx, dscale_nc, dbias_nc = fn(x, scale, mean, inv, g.contiguous())
        return dx, dscale_nc.sum(0), dbias_nc.sum(0), None


class _InstanceNormActPad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, pad, eps, negative_slope):
        fn = instance_norm_act_pad_cuda if on_card(x) else instance_norm_act_pad_plain
        y, mean, inv = fn(x, scale, bias, pad, negative_slope, eps)
        ctx.save_for_backward(x, scale, bias, mean, inv)
        ctx.pad, ctx.negative_slope = pad, negative_slope
        return y

    @staticmethod
    def backward(ctx, g):
        dx, dscale, dbias = instance_norm_act_pad_backward(
            *ctx.saved_tensors, g, ctx.pad, ctx.negative_slope)
        return dx, dscale, dbias, None, None, None


def _wide(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the type the norm computes in: f32 for f32 and bf16 (JAX
    ``x.astype(jnp.float32)``), float64 for the float64 references."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _xla_forward(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 eps: float):
    """JAX ``_xla_forward``: subtract-first normalise, every elementwise
    step in f32, the result cast to x's dtype; (y, mean, inv) with the
    statistics [N, 1, 1, C] f32."""
    xf = _wide(x)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=(1, 2), keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = centered * inv * _wide(scale) + _wide(bias)
    return y.to(x.dtype), mean, inv


def _xla_backward(x, scale, bias, mean, inv, g):
    """JAX ``instance_norm_backward``: all math in f32, outputs in the
    parameters' and the activations' dtypes.

      xhat   = (x - mean) * inv
      dbias  = sum_{N,HW} g
      dscale = sum_{N,HW} g * xhat
      dx     = scale * inv * (g - mean_hw(g) - xhat * mean_hw(g * xhat))
    """
    xf, gf = _wide(x), _wide(g)
    xhat = (xf - mean) * inv
    gx = gf * xhat
    dbias = gf.sum(dim=(0, 1, 2))
    dscale = gx.sum(dim=(0, 1, 2))
    g_mean = gf.mean(dim=(1, 2), keepdim=True)
    gx_mean = gx.mean(dim=(1, 2), keepdim=True)
    dx = _wide(scale) * inv * (gf - g_mean - xhat * gx_mean)
    return dx.to(x.dtype), dscale.to(scale.dtype), dbias.to(bias.dtype)


class _InstanceNormXla(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, inv = _xla_forward(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, bias, mean, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        return (*_xla_backward(*ctx.saved_tensors, g), None)


def instance_norm_xla(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """The ``"xla"`` instance norm: torch ops, no kernel, on any device."""
    if wants_grad(x, scale, bias):
        return _InstanceNormXla.apply(x, scale, bias, eps)
    return _xla_forward(x, scale, bias, eps)[0]


def _check_impl(impl: str) -> None:
    if impl not in NORM_IMPLS:
        raise ValueError(f"instance norm impl must be one of {NORM_IMPLS}, "
                         f"got {impl!r}")


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-3, impl: str = "pallas") -> torch.Tensor:
    """[N, H, W, C] -> (x - mean) / sqrt(var + eps) * scale + bias; K1
    under ``impl="pallas"``, torch ops under ``"xla"`` and ``"auto"``."""
    _check_impl(impl)
    if impl != "pallas":
        return instance_norm_xla(x, scale, bias, eps)
    if wants_grad(x, scale, bias):
        return _InstanceNorm.apply(x, scale, bias, eps)
    fn = instance_norm_cuda if on_card(x) else instance_norm_plain
    return fn(x, scale, bias, eps)[0]


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """flax's ``nn.leaky_relu``, ``where(x >= 0, x, slope * x)``, whose
    gradient at 0 is 1 (torch's ``F.leaky_relu`` takes the slope there)."""
    return torch.where(x >= 0, x, negative_slope * x)


def epilogue_on_kernel(x: torch.Tensor, pad: int, impl: str) -> bool:
    """Whether an epilogue site under ``impl`` runs the epilogue kernel
    (K3 forward, K4 backward) for ``x``: under "pallas" and "auto" where
    ``epilogue_eligible`` takes the shape, never under "xla"."""
    _check_impl(impl)
    return impl != "xla" and epilogue_eligible(tuple(x.shape), x.dtype, pad)


def instance_norm_act_pad(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, pad: int, eps: float = 1e-3,
                          negative_slope: float = 0.0,
                          impl: str = "pallas") -> torch.Tensor:
    """instance_norm -> LeakyReLU(negative_slope) -> reflect-pad(pad):
    [N, H, W, C] -> [N, H+2p, W+2p, C]. Slope 0 is the residual block's
    ReLU; slope 0.2 with pad 0 the discriminator's tail. The epilogue
    kernel where ``epilogue_on_kernel``, else the JAX package's
    composition ``reflect_pad(act(instance_norm_xla(x)))``."""
    if not epilogue_on_kernel(x, pad, impl):
        if pad and pad >= min(x.shape[1], x.shape[2]):
            raise ValueError(f"reflect pad {pad} needs 0 <= pad < min(H, W) "
                             f"for input {tuple(x.shape)}")
        y = instance_norm_xla(x, scale, bias, eps)
        y = leaky_relu(y, negative_slope) if negative_slope else torch.relu(y)
        return reflect_pad(y, pad)
    if wants_grad(x, scale, bias):
        return _InstanceNormActPad.apply(x, scale, bias, pad, eps,
                                         negative_slope)
    fn = instance_norm_act_pad_cuda if on_card(x) else instance_norm_act_pad_plain
    return fn(x, scale, bias, pad, negative_slope, eps)[0]
