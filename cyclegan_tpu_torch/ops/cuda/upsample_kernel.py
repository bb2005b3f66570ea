"""Zero-skip upsample forward (3x3/s2 SAME transposed conv -> instance norm
-> ReLU -> reflect-pad): the CUDA kernels' wrappers and their plain
versions, with f32 weights (K5) and with int8 weights (K6).

K5 (``csrc/upsample.cu``) replaces the TPU kernel
``cyclegan_tpu/ops/pallas/upsample_kernel.py:_forward``. Both versions map
NHWC f32 ``x`` [N, H, W, Cin] and the flax HWIO kernel [3, 3, Cin, Cout],
applied without a flip, to ``(y, mean, inv)`` with ``y``
[N, 2H+2p, 2W+2p, Cout]; with ``keep_conv=True`` also the pre-norm
transposed-conv output [N, 2H, 2W, Cout], which the training path keeps
for the backward (ops/upsample.py).

K6 (the same source) replaces ``_forward_int8``: the kernel arrives as
int8 [3, 3, Cin, Cout] with its f32 per-output-channel scale (Cout values,
as [Cout] or as the quantized tree's [1, 1, 1, Cout]), the weights widen
to f32 inside the kernel and each output phase is multiplied by the scale
after its C_in and tap sum. It is forward-only and returns ``(y, mean,
inv)``.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.ops.cuda import LAUNCHES, build
from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
    check_pad,
    instance_norm_act_pad_plain,
)
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
    check_activation,
    check_param,
    stats_buffers,
    stats_chunking,
)


def conv_transpose_zeroskip(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The transposed conv as four output phases, each a sum of taps over
    the un-dilated input with x[-1] = 0: [N, H, W, Cin] x [3, 3, Cin, Cout]
    -> [N, 2H, 2W, Cout]. Pixel (2p+r, 2q+s) comes from phase (r, s)."""
    n, h, w, _ = x.shape
    cout = kernel.shape[-1]
    # One leading zero row and column: xp[i + 1, j + 1] = x[i, j].
    xp = torch.nn.functional.pad(x, (0, 0, 1, 0, 1, 0))
    prev_prev = xp[:, :h, :w]      # x[p-1, q-1]
    prev_row = xp[:, :h, 1:]       # x[p-1, q]
    prev_col = xp[:, 1:, :w]       # x[p, q-1]
    here = x                       # x[p, q]
    ee = (prev_prev @ kernel[0, 0] + prev_row @ kernel[0, 2]
          + prev_col @ kernel[2, 0] + here @ kernel[2, 2])
    eo = prev_row @ kernel[0, 1] + here @ kernel[2, 1]
    oe = prev_col @ kernel[1, 0] + here @ kernel[1, 2]
    oo = here @ kernel[1, 1]
    y = torch.stack([ee, eo, oe, oo], dim=-1).reshape(n, h, w, cout, 2, 2)
    return y.permute(0, 1, 4, 2, 5, 3).reshape(n, 2 * h, 2 * w, cout)


def upsample_norm_relu_pad_plain(x: torch.Tensor, kernel: torch.Tensor,
                                 scale: torch.Tensor, bias: torch.Tensor,
                                 pad: int = 0, eps: float = 1e-3,
                                 keep_conv: bool = False):
    """Plain PyTorch version of the upsample kernel."""
    conv_out = conv_transpose_zeroskip(x, kernel)
    y, mean, inv = instance_norm_act_pad_plain(conv_out, scale, bias, pad,
                                               0.0, eps)
    return (y, mean, inv, conv_out) if keep_conv else (y, mean, inv)


def check_int8_kernel(kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                      cin: int) -> int:
    """Raise unless ``kernel_q`` is an int8 [3, 3, cin, Cout] kernel and
    ``kernel_scale`` holds Cout f32 scales; return Cout. A kernel of
    another type raises TypeError, as the JAX package's entry does."""
    if kernel_q.dtype != torch.int8:
        raise TypeError(
            f"kernel_q must be int8, got {kernel_q.dtype}: pass the quantized "
            "weights, not a dequantized kernel")
    if kernel_q.dim() != 4 or tuple(kernel_q.shape[:3]) != (3, 3, cin):
        raise ValueError(f"int8 upsample kernel must be [3, 3, {cin}, Cout], "
                         f"got {tuple(kernel_q.shape)}")
    cout = kernel_q.shape[3]
    if kernel_scale.numel() != cout or kernel_scale.dtype != torch.float32:
        raise ValueError(f"kernel_scale must hold {cout} float32 scales, got "
                         f"{kernel_scale.dtype} {tuple(kernel_scale.shape)}")
    return cout


def upsample_norm_relu_pad_int8_plain(x: torch.Tensor, kernel_q: torch.Tensor,
                                      kernel_scale: torch.Tensor,
                                      scale: torch.Tensor, bias: torch.Tensor,
                                      pad: int = 0, eps: float = 1e-3):
    """Plain PyTorch version of the int8 upsample kernel: the phases over
    the widened kernel, then the scale, then the norm tail."""
    cout = check_int8_kernel(kernel_q, kernel_scale, x.shape[-1])
    conv_out = (conv_transpose_zeroskip(x, kernel_q.to(x.dtype))
                * kernel_scale.reshape(cout))
    return instance_norm_act_pad_plain(conv_out, scale, bias, pad, 0.0, eps)


def _upsample_buffers(x: torch.Tensor, cout: int, pad: int):
    """Checks shared by both kernels, and their outputs and scratch:
    (rows, chunks, conv_out, y, part_mean, part_m2, mean, inv)."""
    n, h, w, _ = x.shape
    check_pad((n, 2 * h, 2 * w, cout), pad)
    if n * 4 * h * w * cout >= 2**31:
        raise ValueError(f"upsample_norm_relu_pad: unsupported size {tuple(x.shape)}")
    rows, chunks = stats_chunking(x, n, 4 * h * w, cout)
    conv_out = torch.empty((n, 2 * h, 2 * w, cout), device=x.device,
                           dtype=x.dtype)
    y = torch.empty((n, 2 * h + 2 * pad, 2 * w + 2 * pad, cout),
                    device=x.device, dtype=x.dtype)
    return (rows, chunks, conv_out, y) + stats_buffers(x, n, cout, chunks)


def upsample_norm_relu_pad_cuda(x: torch.Tensor, kernel: torch.Tensor,
                                scale: torch.Tensor, bias: torch.Tensor,
                                pad: int = 0, eps: float = 1e-3,
                                keep_conv: bool = False):
    """Launch the upsample kernel (phase convolution, then the norm tail
    through the instance-norm statistics and the epilogue apply) on the
    current stream."""
    check_activation(x, "upsample_norm_relu_pad")
    n, h, w, cin = x.shape
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, cin):
        raise ValueError(f"upsample kernel must be [3, 3, {cin}, Cout], got "
                         f"{tuple(kernel.shape)}")
    cout = kernel.shape[3]
    check_param(kernel, (3, 3, cin, cout), x, "upsample kernel")
    check_param(scale, (cout,), x, "upsample scale")
    check_param(bias, (cout,), x, "upsample bias")
    rows, chunks, conv_out, y, part_mean, part_m2, mean, inv = \
        _upsample_buffers(x, cout, pad)
    lib = build.library()
    status = lib.cg_upsample_forward(
        x.data_ptr(), kernel.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        conv_out.data_ptr(), y.data_ptr(), part_mean.data_ptr(),
        part_m2.data_ptr(), mean.data_ptr(), inv.data_ptr(), n, h, w, cin,
        cout, pad, float(eps), rows, chunks,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "cg_upsample_forward")
    LAUNCHES["upsample"] += 1
    return (y, mean, inv, conv_out) if keep_conv else (y, mean, inv)


def upsample_norm_relu_pad_int8_cuda(x: torch.Tensor, kernel_q: torch.Tensor,
                                     kernel_scale: torch.Tensor,
                                     scale: torch.Tensor, bias: torch.Tensor,
                                     pad: int = 0, eps: float = 1e-3):
    """Launch the int8 upsample kernel (phase convolution over the int8
    kernel, scaled per output channel, then the norm tail) on the current
    stream."""
    check_activation(x, "upsample_norm_relu_pad_int8")
    n, h, w, cin = x.shape
    cout = check_int8_kernel(kernel_q, kernel_scale, cin)
    if kernel_q.device != x.device or not kernel_q.is_contiguous():
        raise ValueError(f"int8 upsample kernel: expected contiguous on "
                         f"{x.device}, got {kernel_q.device}")
    kernel_scale = kernel_scale.reshape(cout)
    check_param(kernel_scale, (cout,), x, "int8 upsample kernel_scale")
    check_param(scale, (cout,), x, "upsample scale")
    check_param(bias, (cout,), x, "upsample bias")
    rows, chunks, conv_out, y, part_mean, part_m2, mean, inv = \
        _upsample_buffers(x, cout, pad)
    lib = build.library()
    status = lib.cg_upsample_int8_forward(
        x.data_ptr(), kernel_q.data_ptr(), kernel_scale.data_ptr(),
        scale.data_ptr(), bias.data_ptr(), conv_out.data_ptr(), y.data_ptr(),
        part_mean.data_ptr(), part_m2.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), n, h, w, cin, cout, pad, float(eps), rows, chunks,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "cg_upsample_int8_forward")
    LAUNCHES["upsample_int8"] += 1
    return y, mean, inv
