"""70x70 PatchGAN discriminator (the JAX package's models/discriminator.py).

  Conv4x4 stride 2 -> 64 (with bias), LeakyReLU(0.2)
  3 downsampling blocks (no bias): 128 stride 2, 256 stride 2, 512
    stride 1, each IN > LeakyReLU(0.2)
  Conv4x4 stride 1 SAME -> 1 (with bias), no activation: raw patch logits

A [N, 32, 32, 1] patch map for a 256² input; about 2.77M parameters at
the default sizes. In the layout the port runs (the JAX package's
``pad_impl="epilogue"``) each block's IN > LeakyReLU(0.2) tail is one
epilogue kernel with no pad: at 256² the sites are [N, 64, 64, 128],
[N, 32, 32, 256] and [N, 32, 32, 512]. Submodules carry the flax names
(``Conv_0``, ``Downsample_i``, ``Conv_1``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from cyclegan_tpu_torch.config import DiscriminatorConfig
from cyclegan_tpu_torch.models.generator import use_full_fp32
from cyclegan_tpu_torch.models.modules import Conv, Downsample, leaky_relu

NEGATIVE_SLOPE = 0.2


class PatchGANDiscriminator(nn.Module):
    def __init__(self, config: DiscriminatorConfig = DiscriminatorConfig(),
                 in_channels: int = 3, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = config.filters
        kw = {"device": device, "generator": generator}
        self.Conv_0 = Conv(in_channels, f, 4, stride=2, padding="same",
                           use_bias=True, **kw)
        self.blocks = []
        for i in range(config.num_downsampling):
            name = f"Downsample_{i}"
            self.add_module(name, Downsample(
                f, 2 * f, kernel_size=4, stride=2 if i < 2 else 1,
                fused_slope=NEGATIVE_SLOPE, **kw))
            self.blocks.append(name)
            f *= 2
        self.Conv_1 = Conv(f, 1, 4, padding="same", use_bias=True, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W, C] f32 -> [N, H/8, W/8, 1] raw logits (at 3
        downsampling blocks)."""
        if x.is_cuda:
            use_full_fp32()
        y = leaky_relu(self.Conv_0(x), NEGATIVE_SLOPE)
        for name in self.blocks:
            y = getattr(self, name)(y)
        return self.Conv_1(y)
