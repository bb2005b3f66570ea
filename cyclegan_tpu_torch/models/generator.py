"""ResNet-9 CycleGAN generator (the JAX package's models/generator.py).

  c7s1-64: reflect-pad 3, Conv7x7 (no bias), IN, ReLU
  2 downsampling blocks, 64 > 128 > 256 filters
  9 residual blocks at 256
  2 upsampling blocks, 256 > 128 > 64; the last one's norm tail also
    reflect-pads by 3 for the tail conv
  Conv7x7 VALID -> 3 channels (with bias), tanh

About 11.4M parameters at the default sizes. In the layout served here
every instance norm is one of three kernels: 12 instance-norm sites
(Conv_0's, the downsamples', each residual block's InstanceNorm_1), 9
epilogue sites (each residual block's InstanceNorm_0) and 2 upsample
sites. The JAX package takes the fused pad 3 of the last upsample only
when it fits the TPU's VMEM; the port always takes it, which changes
the scheduling and not the function.

``upsample_impl="zeroskip_fused_int8"`` holds the two upsample kernels
quantized and runs them on the int8 upsample kernel (the ``int8_fused``
serving tier); every other parameter is as in the default layout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cyclegan_tpu_torch.config import GeneratorConfig
from cyclegan_tpu_torch.models.modules import (
    Conv,
    Downsample,
    InstanceNorm,
    ResidualBlock,
    Upsample,
)

# The tail conv's reflect padding, fused into the last upsample.
TAIL_PAD = 3


def use_full_fp32() -> None:
    """Keep f32 convolutions and matmuls in full f32 on the card: cuDNN
    convolutions default to TF32 on Hopper (about three decimal digits),
    which the f32 serving path must not take."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class ResNetGenerator(nn.Module):
    def __init__(self, config: GeneratorConfig = GeneratorConfig(),
                 in_channels: int = 3, out_channels: int = 3,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 upsample_impl: str = "zeroskip_fused"):
        super().__init__()
        f = config.filters
        kw = {"device": device, "generator": generator}
        self.Conv_0 = Conv(in_channels, f, 7, padding="reflect", **kw)
        self.InstanceNorm_0 = InstanceNorm(f, **kw)
        self.stages = []
        for i in range(config.num_downsampling_blocks):
            self._stage(f"Downsample_{i}", Downsample(f, 2 * f, **kw))
            f *= 2
        for i in range(config.num_residual_blocks):
            self._stage(f"ResidualBlock_{i}", ResidualBlock(f, **kw))
        for i in range(config.num_upsample_blocks):
            last = i == config.num_upsample_blocks - 1
            self._stage(f"Upsample_{i}", Upsample(
                f, f // 2, pad_after=TAIL_PAD if last else 0,
                upsample_impl=upsample_impl, **kw))
            f //= 2
        self.Conv_1 = Conv(f, out_channels, 7, use_bias=True, **kw)

    def _stage(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.stages.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W, C] f32 in [-1, 1] -> [N, H, W, out_channels] f32."""
        if x.is_cuda:
            use_full_fp32()
        y = torch.relu(self.InstanceNorm_0(self.Conv_0(x)))
        for name in self.stages:
            y = getattr(self, name)(y)
        return torch.tanh(self.Conv_1(y))
