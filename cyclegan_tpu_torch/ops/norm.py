"""Instance norm and the fused conv epilogue for NHWC tensors.

The counterparts of the JAX package's ``ops/norm.py`` ``instance_norm``
and ``instance_norm_act_pad``: per-(sample, channel) statistics over H
and W, biased variance, eps 1e-3, all in f32. On a CUDA tensor each
function launches its hand-written kernel (``ops/cuda/``); on a CPU
tensor it runs the kernel's plain version. Nothing falls back: a kernel
that fails raises.

Where a gradient is wanted, each function is a ``torch.autograd.Function``
as the JAX package's are ``jax.custom_vjp``s: the forward is the forward
kernel and saves ``x``, the parameters and the per-(n, c) ``mean`` and
``inv``; the backward is the backward kernel (K2 for the norm, K4 for the
epilogue), whose per-(n, c) dscale and dbias partials are summed over N
here, as the JAX package's ``norm_kernel.py`` does. Without a gradient
(``inference_mode``, ``no_grad``, or no input that requires one) the
forward kernel runs alone and nothing is saved.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
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


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-3) -> torch.Tensor:
    """[N, H, W, C] -> (x - mean) / sqrt(var + eps) * scale + bias."""
    if wants_grad(x, scale, bias):
        return _InstanceNorm.apply(x, scale, bias, eps)
    fn = instance_norm_cuda if on_card(x) else instance_norm_plain
    return fn(x, scale, bias, eps)[0]


def instance_norm_act_pad(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, pad: int, eps: float = 1e-3,
                          negative_slope: float = 0.0) -> torch.Tensor:
    """instance_norm -> LeakyReLU(negative_slope) -> reflect-pad(pad):
    [N, H, W, C] -> [N, H+2p, W+2p, C]. Slope 0 is the residual block's
    ReLU; slope 0.2 with pad 0 the discriminator's tail."""
    if wants_grad(x, scale, bias):
        return _InstanceNormActPad.apply(x, scale, bias, pad, eps,
                                         negative_slope)
    fn = instance_norm_act_pad_cuda if on_card(x) else instance_norm_act_pad_plain
    return fn(x, scale, bias, pad, negative_slope, eps)[0]
