"""Stride-2 3x3 SAME transposed convolution and the fused Upsample block.

Counterparts of the JAX package's ``ops/upsample.py``. The kernel stays in
flax HWIO [3, 3, Cin, Cout] and is applied without a flip, as flax's
``nn.ConvTranspose`` does:

  out[o] = sum_j K[j] * dilated[o + j - 2],  dilated[2t] = x[t]

``conv_transpose_up2_dense`` computes exactly that; the zero-skip form
(``conv_transpose_zeroskip``) splits it into four output phases that
never multiply an inserted zero. ``upsample_norm_relu_pad`` is the whole
Upsample block: on a CUDA tensor the hand-written kernel, on a CPU tensor
its plain version.

Where a gradient is wanted the block is a ``torch.autograd.Function``. The
JAX package has no backward kernel for it and composes its VJP; so does
the port: the epilogue backward (K4, slope 0, the block's pad) over the
transposed conv's output folds the pad, applies the ReLU mask and the
instance norm's VJP, and then the transposed conv's own VJP gives dx and
dkernel through one ``aten.convolution_backward`` call (cuDNN on the
card). The JAX package recomputes the conv output in its backward; the
port keeps the one the forward kernel already writes, one [N, 2H, 2W,
Cout] tensor per block held until the backward, instead of running the
transposed conv a second time. Under bf16 compute that tensor is the bf16
conv output, the very values whose statistics the forward took; the
parameter gradients come back f32 (dkernel in bf16 from the conv's VJP,
widened by the cast that made the bf16 kernel), dx in bf16.

``upsample_norm_relu_pad_int8`` is the block with int8 weights and their
per-output-channel scale (the ``int8_fused`` serving tier): on a CUDA
tensor K6, on a CPU tensor its plain version. It is forward-only, as in
the JAX package, which registers no VJP for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
    conv_transpose_zeroskip,
    upsample_norm_relu_pad_cuda,
    upsample_norm_relu_pad_int8_cuda,
    upsample_norm_relu_pad_int8_plain,
    upsample_norm_relu_pad_plain,
)
from cyclegan_tpu_torch.ops.norm import (
    instance_norm_act_pad_backward,
    on_card,
    wants_grad,
)
from cyclegan_tpu_torch.ops.padding import to_nchw, to_nhwc

__all__ = ["conv_transpose_up2_dense", "conv_transpose_zeroskip",
           "conv_transpose_vjp", "upsample_norm_relu_pad",
           "upsample_norm_relu_pad_int8"]


def conv_transpose_up2_dense(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The dilated form: [N, H, W, Cin] x [3, 3, Cin, Cout] -> [N, 2H, 2W, Cout].
    Zeros go between the input pixels, the result is padded (2, 1) and
    correlated with the unflipped kernel."""
    n, h, w, cin = x.shape
    dilated = x.new_zeros((n, 2 * h - 1, 2 * w - 1, cin))
    dilated[:, ::2, ::2] = x
    padded = F.pad(to_nchw(dilated), (2, 1, 2, 1))
    return to_nhwc(F.conv2d(padded, kernel.permute(3, 2, 0, 1)))


def conv_transpose_vjp(x: torch.Tensor, kernel: torch.Tensor,
                       g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dx, dkernel) of the transposed conv [N, H, W, Cin] x [3, 3, Cin,
    Cout] -> [N, 2H, 2W, Cout] for the cotangent ``g`` of its output.

    The conv is torch's stride-2 ``conv_transpose2d`` with the flax kernel
    flipped to [Cin, Cout, 3, 3], whose [N, Cout, 2H+1, 2W+1] output is
    cropped to its first 2H rows and 2W columns; so the cropped row and
    column get a zero cotangent, and dkernel comes back flipped."""
    weight = kernel.permute(2, 3, 0, 1).flip(2, 3)
    g_full = F.pad(to_nchw(g), (0, 1, 0, 1))
    dx, dweight, _ = torch.ops.aten.convolution_backward(
        g_full, to_nchw(x), weight, None, [2, 2], [0, 0], [1, 1], True,
        [0, 0], 1, [True, True, False])
    return to_nhwc(dx), dweight.flip(2, 3).permute(2, 3, 0, 1).contiguous()


class _Upsample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, scale, bias, pad, eps):
        fn = upsample_norm_relu_pad_cuda if on_card(x) else upsample_norm_relu_pad_plain
        y, mean, inv, conv_out = fn(x, kernel, scale, bias, pad, eps,
                                    keep_conv=True)
        ctx.save_for_backward(x, kernel, scale, bias, mean, inv, conv_out)
        ctx.pad = pad
        return y

    @staticmethod
    def backward(ctx, g):
        x, kernel, scale, bias, mean, inv, conv_out = ctx.saved_tensors
        dconv, dscale, dbias = instance_norm_act_pad_backward(
            conv_out, scale, bias, mean, inv, g, ctx.pad, 0.0)
        dx, dkernel = conv_transpose_vjp(x, kernel, dconv)
        return dx, dkernel, dscale, dbias, None, None


def upsample_norm_relu_pad(x: torch.Tensor, kernel: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           pad: int = 0, eps: float = 1e-3) -> torch.Tensor:
    """Zero-skip upsample -> instance norm -> ReLU -> reflect-pad(pad):
    [N, H, W, Cin] -> [N, 2H+2p, 2W+2p, Cout]."""
    if wants_grad(x, kernel, scale, bias):
        return _Upsample.apply(x, kernel, scale, bias, pad, eps)
    fn = upsample_norm_relu_pad_cuda if on_card(x) else upsample_norm_relu_pad_plain
    return fn(x, kernel, scale, bias, pad, eps)[0]


def upsample_norm_relu_pad_int8(x: torch.Tensor, kernel_q: torch.Tensor,
                                kernel_scale: torch.Tensor,
                                scale: torch.Tensor, bias: torch.Tensor,
                                pad: int = 0, eps: float = 1e-3) -> torch.Tensor:
    """The Upsample block over an int8 [3, 3, Cin, Cout] kernel and its f32
    per-output-channel scale: [N, H, W, Cin] -> [N, 2H+2p, 2W+2p, Cout].
    Raises TypeError for a kernel that is not int8, and RuntimeError where
    autograd would want a gradient through it."""
    if wants_grad(x, kernel_scale, scale, bias):
        raise RuntimeError(
            "upsample_norm_relu_pad_int8 is forward-only (the int8_fused "
            "serving tier): it has no gradient; run it under "
            "torch.inference_mode() or torch.no_grad()")
    fn = (upsample_norm_relu_pad_int8_cuda if on_card(x)
          else upsample_norm_relu_pad_int8_plain)
    return fn(x, kernel_q, kernel_scale, scale, bias, pad, eps)[0]
