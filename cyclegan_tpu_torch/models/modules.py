"""Building blocks of the generator and the discriminator, in the layout
the port runs.

Counterparts of the JAX package's ``models/modules.py`` under
``pad_impl="epilogue"``, ``upsample_impl="zeroskip_fused"`` (or its
int8 serving form ``"zeroskip_fused_int8"``) and
``instance_norm_impl="pallas"``. Every module takes and returns NHWC
tensors. Submodules and parameters carry the flax names (``Conv_0``,
``InstanceNorm_1``, ``ConvTranspose_0``...), so a ``state_dict`` key is the
flax path with dots; conv kernels are torch's OIHW ``weight``, the
transposed-conv kernel stays flax HWIO ``kernel`` (convert.py).

Initialisation is the JAX package's ``init_normal``: conv kernels and
instance-norm scales N(0, 0.02), biases zero.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cyclegan_tpu_torch.ops.norm import instance_norm, instance_norm_act_pad
from cyclegan_tpu_torch.ops.padding import reflect_pad, same_pad, to_nchw, to_nhwc
from cyclegan_tpu_torch.ops.upsample import (
    upsample_norm_relu_pad,
    upsample_norm_relu_pad_int8,
)

INIT_STDDEV = 0.02


def init_normal_(t: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """N(0, 0.02) in place (the JAX package's ``init_normal``)."""
    if t.device.type != "meta":
        with torch.no_grad():
            t.normal_(0.0, INIT_STDDEV, generator=generator)


class Conv(nn.Module):
    """2-D conv on NHWC tensors. ``padding``: "valid" (the input is already
    padded), "reflect" (tf-REFLECT pad of k // 2, then VALID) or "same"
    (TensorFlow's SAME zero padding, for the strided convs)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: str = "valid", use_bias: bool = False,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if padding not in ("valid", "reflect", "same"):
            raise ValueError(f"unknown conv padding {padding!r}")
        self.stride = stride
        self.padding = padding
        # channels_last, as the activations: load_state_dict copies into
        # this storage and keeps its layout.
        self.weight = nn.Parameter(torch.empty(
            (cout, cin, kernel_size, kernel_size), device=device,
            memory_format=torch.channels_last))
        init_normal_(self.weight, generator)
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        if self.padding == "reflect":
            x = reflect_pad(x, k // 2)
        x = to_nchw(x)
        if self.padding == "same":
            x = same_pad(x, k, self.stride)
        return to_nhwc(F.conv2d(x, self.weight, self.bias, self.stride))


class NormParams(nn.Module):
    """Instance norm's ``scale`` (N(0, 0.02)) and ``bias`` (zeros)."""

    def __init__(self, channels: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels, device=device))
        init_normal_(self.scale, generator)
        self.bias = nn.Parameter(torch.zeros(channels, device=device))


class InstanceNorm(NormParams):
    """Learned instance norm, eps 1e-3 (the instance-norm kernel)."""

    eps = 1e-3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.scale, self.bias, self.eps)


class FusedNormReluPad(NormParams):
    """Instance norm -> LeakyReLU(slope) -> reflect-pad(pad) as one op (the
    epilogue kernel); same parameters as ``InstanceNorm``."""

    eps = 1e-3

    def __init__(self, channels: int, pad: int, negative_slope: float = 0.0,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__(channels, device, generator)
        self.pad = pad
        self.negative_slope = negative_slope

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm_act_pad(x, self.scale, self.bias, self.pad,
                                     self.eps, self.negative_slope)


class ResidualBlock(nn.Module):
    """reflect-pad(1) > Conv3x3 > [IN > ReLU > reflect-pad(1)] > Conv3x3
    VALID > IN > + skip, the bracket one epilogue kernel (the JAX
    package's ResidualBlock under pad_impl="epilogue")."""

    def __init__(self, channels: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(channels, channels, 3, padding="reflect",
                           device=device, generator=generator)
        self.InstanceNorm_0 = FusedNormReluPad(channels, pad=1, device=device,
                                               generator=generator)
        self.Conv_1 = Conv(channels, channels, 3, device=device,
                           generator=generator)
        self.InstanceNorm_1 = InstanceNorm(channels, device=device,
                                           generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.InstanceNorm_0(self.Conv_0(x))
        return x + self.InstanceNorm_1(self.Conv_1(y))


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """flax's ``nn.leaky_relu``, ``where(x >= 0, x, slope * x)``, whose
    gradient at 0 is 1 (torch's ``F.leaky_relu`` takes the slope there)."""
    return torch.where(x >= 0, x, negative_slope * x)


class Downsample(nn.Module):
    """Conv k x k (stride 2 by default) SAME (no bias) > IN > activation.
    ``fused_slope`` None: the instance-norm kernel, then ReLU (the
    generator's blocks). A slope: IN > LeakyReLU(slope) as one epilogue
    kernel with no pad (the discriminator's blocks under
    pad_impl="epilogue")."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 2, fused_slope: Optional[float] = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel_size, stride=stride,
                           padding="same", device=device, generator=generator)
        self.fused = fused_slope is not None
        if self.fused:
            self.InstanceNorm_0 = FusedNormReluPad(
                cout, pad=0, negative_slope=fused_slope, device=device,
                generator=generator)
        else:
            self.InstanceNorm_0 = InstanceNorm(cout, device=device,
                                               generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.InstanceNorm_0(self.Conv_0(x))
        return y if self.fused else torch.relu(y)


class ZeroSkipKernel(nn.Module):
    """The transposed conv's flax HWIO ``kernel`` [3, 3, Cin, Cout]."""

    def __init__(self, cin: int, cout: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty((3, 3, cin, cout), device=device))
        init_normal_(self.kernel, generator)


class QuantZeroSkipKernel(nn.Module):
    """The transposed conv's ``kernel`` quantized per output channel, as
    the JAX package's QuantZeroSkipKernel holds it: ``kernel.int8_q`` int8
    [3, 3, Cin, Cout] and ``kernel.int8_scale`` f32 [1, 1, 1, Cout]. Both
    are buffers, not parameters: the quantized tiers only serve."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.kernel = nn.Module()
        self.kernel.register_buffer("int8_q", torch.zeros(
            (3, 3, cin, cout), dtype=torch.int8, device=device))
        self.kernel.register_buffer("int8_scale", torch.ones(
            (1, 1, 1, cout), device=device))


UPSAMPLE_IMPLS = ("zeroskip_fused", "zeroskip_fused_int8")


class Upsample(nn.Module):
    """ConvTranspose3x3 stride 2 SAME (no bias) > IN > ReLU
    (> reflect-pad(pad_after)), the whole block one upsample kernel (the
    JAX package's Upsample under upsample_impl="zeroskip_fused"). Under
    "zeroskip_fused_int8" the kernel is held quantized and stays int8
    into the int8 upsample kernel; that form only serves."""

    eps = 1e-3

    def __init__(self, cin: int, cout: int, pad_after: int = 0, device=None,
                 generator: Optional[torch.Generator] = None,
                 upsample_impl: str = "zeroskip_fused"):
        super().__init__()
        if upsample_impl not in UPSAMPLE_IMPLS:
            raise ValueError(f"unknown upsample_impl {upsample_impl!r}")
        self.pad_after = pad_after
        self.quantized = upsample_impl == "zeroskip_fused_int8"
        self.ConvTranspose_0 = (
            QuantZeroSkipKernel(cin, cout, device) if self.quantized
            else ZeroSkipKernel(cin, cout, device, generator))
        self.InstanceNorm_0 = NormParams(cout, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = self.InstanceNorm_0
        if self.quantized:
            q = self.ConvTranspose_0.kernel
            return upsample_norm_relu_pad_int8(
                x, q.int8_q, q.int8_scale, norm.scale, norm.bias,
                self.pad_after, self.eps)
        return upsample_norm_relu_pad(x, self.ConvTranspose_0.kernel,
                                      norm.scale, norm.bias, self.pad_after,
                                      self.eps)
