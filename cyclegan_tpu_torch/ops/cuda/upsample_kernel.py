"""Zero-skip upsample forward (3x3/s2 SAME transposed conv -> instance norm
-> ReLU -> reflect-pad): the CUDA kernel's wrapper and its plain version.

The kernel (``csrc/upsample.cu``) replaces the TPU kernel
``cyclegan_tpu/ops/pallas/upsample_kernel.py:_forward``. Both versions map
NHWC f32 ``x`` [N, H, W, Cin] and the flax HWIO kernel [3, 3, Cin, Cout],
applied without a flip, to ``(y, mean, inv)`` with ``y``
[N, 2H+2p, 2W+2p, Cout]; with ``keep_conv=True`` also the pre-norm
transposed-conv output [N, 2H, 2W, Cout], which the training path keeps
for the backward (ops/upsample.py).
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
    check_pad((n, 2 * h, 2 * w, cout), pad)
    if n * 4 * h * w * cout >= 2**31:
        raise ValueError(f"upsample_norm_relu_pad: unsupported size {tuple(x.shape)}")
    rows, chunks = stats_chunking(x, n, 4 * h * w, cout)
    conv_out = torch.empty((n, 2 * h, 2 * w, cout), device=x.device,
                           dtype=x.dtype)
    y = torch.empty((n, 2 * h + 2 * pad, 2 * w + 2 * pad, cout),
                    device=x.device, dtype=x.dtype)
    part_mean, part_m2, mean, inv = stats_buffers(x, n, cout, chunks)
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
