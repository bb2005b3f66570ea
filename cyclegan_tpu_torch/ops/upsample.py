"""Stride-2 3x3 SAME transposed convolution and the fused Upsample block.

Counterparts of the JAX package's ``ops/upsample.py``. The kernel stays in
flax HWIO [3, 3, Cin, Cout] and is applied without a flip, as flax's
``nn.ConvTranspose`` does:

  out[o] = sum_j K[j] * dilated[o + j - 2],  dilated[2t] = x[t]

``conv_transpose_up2(x, kernel, impl)`` computes it with
``impl="dense"`` (``conv_transpose_up2_dense``: cuDNN's stride-2
transposed conv with the kernel flipped, cropped to [2H, 2W]) or
``impl="zeroskip"`` (``conv_transpose_up2_zeroskip``: the JAX package's
four output phases, each a cuDNN conv of a sub-kernel over the
un-dilated input, interleaved depth-to-space; JAX ``ops/upsample.py:
68-93``). Both are torch ops with autograd's gradients, as the JAX package
computes them outside any Pallas kernel. ``upsample_norm_relu_pad`` is
the whole Upsample block of ``upsample_impl="zeroskip_fused"``: on a CUDA
tensor the hand-written kernel (K5), on a CPU tensor its plain version.

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

__all__ = ["conv_transpose_up2", "conv_transpose_up2_dense",
           "conv_transpose_up2_zeroskip", "conv_transpose_zeroskip",
           "conv_transpose_vjp", "upsample_norm_relu_pad",
           "upsample_norm_relu_pad_int8"]


def conv_transpose_up2_dense(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The dense form: [N, H, W, Cin] x [3, 3, Cin, Cout] -> [N, 2H, 2W, Cout]
    as cuDNN's stride-2 transposed conv with the flax kernel flipped to
    [Cin, Cout, 3, 3], whose [2H + 1, 2W + 1] output is cropped to its
    first 2H rows and 2W columns (JAX ``lax.conv_transpose`` SAME)."""
    h, w = x.shape[1], x.shape[2]
    weight = kernel.permute(2, 3, 0, 1).flip(2, 3)
    y = F.conv_transpose2d(to_nchw(x), weight, stride=2)
    return to_nhwc(y[:, :, :2 * h, :2 * w])


def conv_transpose_up2_zeroskip(x: torch.Tensor,
                                kernel: torch.Tensor) -> torch.Tensor:
    """The zero-skip form (JAX ``conv_transpose_zeroskip``): four output
    phases, each a VALID cuDNN conv over x with one leading zero row and
    column, of a sub-kernel of the taps that phase sees, interleaved
    depth-to-space: out[2p+r, 2q+s] = phase[r][s][p, q]."""
    n, h, w, _ = x.shape
    cout = kernel.shape[-1]
    xp = F.pad(to_nchw(x), (1, 0, 1, 0))

    def conv(inp, k):
        return F.conv2d(inp, k.permute(3, 2, 0, 1))

    ee = conv(xp, kernel[0::2, 0::2])
    eo = conv(xp[:, :, :, 1:], kernel[0::2, 1:2])
    oe = conv(xp[:, :, 1:, :], kernel[1:2, 0::2])
    oo = conv(to_nchw(x), kernel[1:2, 1:2])
    y = torch.stack([to_nhwc(t) for t in (ee, eo, oe, oo)], dim=-1)
    y = y.reshape(n, h, w, cout, 2, 2).permute(0, 1, 4, 2, 5, 3)
    return y.reshape(n, 2 * h, 2 * w, cout)


UPSAMPLE_IMPLS = ("dense", "zeroskip")


def conv_transpose_up2(x: torch.Tensor, kernel: torch.Tensor,
                       impl: str = "dense") -> torch.Tensor:
    """Stride-2 3x3 SAME transposed conv, [N, H, W, Cin] x [3, 3, Cin, Cout]
    -> [N, 2H, 2W, Cout], by ``impl`` "dense" or "zeroskip"."""
    if impl == "dense":
        return conv_transpose_up2_dense(x, kernel)
    if impl == "zeroskip":
        return conv_transpose_up2_zeroskip(x, kernel)
    raise ValueError(f"conv_transpose_up2 impl must be one of "
                     f"{UPSAMPLE_IMPLS}, got {impl!r}")


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
