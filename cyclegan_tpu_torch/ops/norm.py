"""Instance norm and the fused conv epilogue for NHWC tensors.

The counterparts of the JAX package's ``ops/norm.py`` ``instance_norm``
and ``instance_norm_act_pad``: per-(sample, channel) statistics over H
and W, biased variance, eps 1e-3, all in f32. On a CUDA tensor each
function launches its hand-written kernel (``ops/cuda/``); on a CPU
tensor it runs the kernel's plain version. Nothing falls back: a kernel
that fails raises.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
    instance_norm_act_pad_cuda,
    instance_norm_act_pad_plain,
)
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
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


def instance_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-3) -> torch.Tensor:
    """[N, H, W, C] -> (x - mean) / sqrt(var + eps) * scale + bias."""
    fn = instance_norm_cuda if on_card(x) else instance_norm_plain
    return fn(x, scale, bias, eps)[0]


def instance_norm_act_pad(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, pad: int, eps: float = 1e-3,
                          negative_slope: float = 0.0) -> torch.Tensor:
    """instance_norm -> LeakyReLU(negative_slope) -> reflect-pad(pad):
    [N, H, W, C] -> [N, H+2p, W+2p, C]. Slope 0 is the residual block's
    ReLU; slope 0.2 with pad 0 the discriminator's tail."""
    fn = instance_norm_act_pad_cuda if on_card(x) else instance_norm_act_pad_plain
    return fn(x, scale, bias, pad, negative_slope, eps)[0]
