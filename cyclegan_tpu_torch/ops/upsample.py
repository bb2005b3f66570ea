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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
    conv_transpose_zeroskip,
    upsample_norm_relu_pad_cuda,
    upsample_norm_relu_pad_plain,
)
from cyclegan_tpu_torch.ops.norm import on_card
from cyclegan_tpu_torch.ops.padding import to_nchw, to_nhwc

__all__ = ["conv_transpose_up2_dense", "conv_transpose_zeroskip",
           "upsample_norm_relu_pad"]


def conv_transpose_up2_dense(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The dilated form: [N, H, W, Cin] x [3, 3, Cin, Cout] -> [N, 2H, 2W, Cout].
    Zeros go between the input pixels, the result is padded (2, 1) and
    correlated with the unflipped kernel."""
    n, h, w, cin = x.shape
    dilated = x.new_zeros((n, 2 * h - 1, 2 * w - 1, cin))
    dilated[:, ::2, ::2] = x
    padded = F.pad(to_nchw(dilated), (2, 1, 2, 1))
    return to_nhwc(F.conv2d(padded, kernel.permute(3, 2, 0, 1)))


def upsample_norm_relu_pad(x: torch.Tensor, kernel: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor,
                           pad: int = 0, eps: float = 1e-3) -> torch.Tensor:
    """Zero-skip upsample -> instance norm -> ReLU -> reflect-pad(pad):
    [N, H, W, Cin] -> [N, 2H+2p, 2W+2p, Cout]."""
    fn = upsample_norm_relu_pad_cuda if on_card(x) else upsample_norm_relu_pad_plain
    return fn(x, kernel, scale, bias, pad, eps)[0]
