"""Building blocks of the generator and the discriminator, in every
layout of the JAX package.

Counterparts of the JAX package's ``models/modules.py``. Every module
takes and returns NHWC tensors. Submodules and parameters carry the flax
names (``Conv_0``, ``InstanceNorm_1``, ``ConvTranspose_0``...), so a
``state_dict`` key is the flax path with dots; conv kernels are torch's
OIHW ``weight``, the transposed-conv kernel stays flax HWIO ``kernel``
(convert.py). The layouts of the resnet trunk share one parameter tree;
``PerturbBlock`` has 1x1 kernels.

The layout arguments keep the JAX names and values:
- ``norm_impl`` (``instance_norm_impl``): "pallas", "xla" or "auto"
  (``ops/norm.py``): the standalone norms on K1 or on torch ops; an
  epilogue site on K3 wherever its eligibility function takes the shape;
- ``pad_mode`` "reflect" or "zero", and ``pad_impl`` "pad" (a padded copy,
  then a VALID conv), "fused" (``ops/padding.py`` ``reflect_conv``) or
  "epilogue" (the IN > ReLU > reflect-pad chain of each residual block
  as one epilogue site, the other sites' pads copies; ``parity_padding``);
- ``upsample_impl``: "dense" and "zeroskip" (the transposed conv on cuDNN,
  ``ops/upsample.py``, then the norm tail), "zeroskip_fused" (the whole
  Upsample block on K5) and the serving form "zeroskip_fused_int8" (K6).

Initialisation is the JAX package's ``init_normal``: conv kernels and
instance-norm scales N(0, 0.02), biases zero.

``dtype`` is the compute dtype, as the flax modules' ``dtype`` is: None
(f32) or ``torch.bfloat16``. Parameters stay f32 either way; a conv casts
its input, its kernel and its bias to ``dtype`` (flax ``modules.py:68-71``),
so does the upsample with its input and kernel, the perturb block with its
activation and mask (JAX ``:350-353``), and the instance norms take the
bf16 activations with their f32 ``scale`` and ``bias`` (f32 statistics,
bf16 output).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cyclegan_tpu_torch.ops import prng
from cyclegan_tpu_torch.ops.norm import (
    instance_norm,
    instance_norm_act_pad,
    leaky_relu,
)
from cyclegan_tpu_torch.ops.padding import (
    reflect_conv,
    reflect_pad,
    same_pad,
    same_pad_amounts,
    to_nchw,
    to_nhwc,
)
from cyclegan_tpu_torch.ops.upsample import (
    conv_transpose_up2,
    upsample_norm_relu_pad,
    upsample_norm_relu_pad_int8,
)

INIT_STDDEV = 0.02
# ModelConfig.compute_dtype -> the modules' dtype.
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(name: str) -> Optional[torch.dtype]:
    """The modules' ``dtype`` for a config's compute dtype name."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"unknown compute dtype {name!r}")
    return COMPUTE_DTYPES[name]


def cast(t: Optional[torch.Tensor], dtype: Optional[torch.dtype]):
    """``t`` in ``dtype`` (as it is where either is None)."""
    return t if t is None or dtype is None else t.to(dtype)


def init_normal_(t: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    """N(0, 0.02) in place (the JAX package's ``init_normal``)."""
    if t.device.type != "meta":
        with torch.no_grad():
            t.normal_(0.0, INIT_STDDEV, generator=generator)


# Conv paddings: the input already padded, a reflect-pad copy then VALID,
# reflect semantics as reflect_conv, and TensorFlow's SAME zero padding.
CONV_PADDINGS = ("valid", "reflect", "reflect_fused", "same")


class Conv(nn.Module):
    """2-D conv on NHWC tensors. ``padding``: "valid" (the input is already
    padded), "reflect" (tf-REFLECT pad of k // 2, then VALID),
    "reflect_fused" (the same function as ``ops/padding.py``
    ``reflect_conv``, with no padded copy) or "same" (TensorFlow's SAME
    zero padding; the strided convs, and every stride-1 site under
    ``pad_mode="zero"``). ``forward`` may take another padding for one
    call (the generator's tail conv, whose input the last upsample may
    have padded already)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int = 1,
                 padding: str = "valid", use_bias: bool = False,
                 device=None, generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if padding not in CONV_PADDINGS:
            raise ValueError(f"unknown conv padding {padding!r}")
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        # channels_last, as the activations: load_state_dict copies into
        # this storage and keeps its layout.
        self.weight = nn.Parameter(torch.empty(
            (cout, cin, kernel_size, kernel_size), device=device,
            memory_format=torch.channels_last))
        init_normal_(self.weight, generator)
        self.bias = (nn.Parameter(torch.zeros(cout, device=device))
                     if use_bias else None)

    def forward(self, x: torch.Tensor,
                padding: Optional[str] = None) -> torch.Tensor:
        padding = padding or self.padding
        k = self.weight.shape[-1]
        x = cast(x, self.dtype)
        weight, bias = cast(self.weight, self.dtype), cast(self.bias, self.dtype)
        if padding == "reflect_fused":
            return to_nhwc(reflect_conv(to_nchw(x), weight, k // 2, bias))
        if padding == "reflect":
            x = reflect_pad(x, k // 2)
        x = to_nchw(x)
        if padding == "same":
            pads = [same_pad_amounts(x.shape[d], k, self.stride) for d in (2, 3)]
            if self.stride == 1 and all(lo == hi for lo, hi in pads):
                return to_nhwc(F.conv2d(x, weight, bias,
                                        padding=(pads[0][0], pads[1][0])))
            x = same_pad(x, k, self.stride)
        return to_nhwc(F.conv2d(x, weight, bias, self.stride))


def parity_padding(pad_mode: str, pad_impl: str) -> str:
    """The ``Conv`` padding of a reference reflect-pad site that no
    epilogue site pads (JAX ``parity_conv``): SAME zero padding under
    ``pad_mode="zero"``, ``reflect_conv`` under ``pad_impl="fused"``, a
    padded copy under "pad" and "epilogue". The JAX package schedules the
    epilogue layout's other sites (the edge convs, each block's Conv_0) as
    under "fused"; the port keeps the padded copy there, as its kernel
    layout has since it was first ported: on the card the copy is one
    small kernel where ``reflect_conv`` adds four border convs and their
    backward, and the function is the same."""
    if pad_mode == "zero":
        return "same"
    if pad_mode != "reflect":
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    return "reflect_fused" if pad_impl == "fused" else "reflect"


class NormParams(nn.Module):
    """Instance norm's ``scale`` (N(0, 0.02)) and ``bias`` (zeros)."""

    def __init__(self, channels: int, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(channels, device=device))
        init_normal_(self.scale, generator)
        self.bias = nn.Parameter(torch.zeros(channels, device=device))


class InstanceNorm(NormParams):
    """Learned instance norm, eps 1e-3: K1 under ``impl="pallas"``, torch
    ops under "xla" and "auto"."""

    eps = 1e-3

    def __init__(self, channels: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 impl: str = "auto"):
        super().__init__(channels, device, generator)
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm(x, self.scale, self.bias, self.eps, self.impl)


class FusedNormReluPad(NormParams):
    """Instance norm -> LeakyReLU(slope) -> reflect-pad(pad) as one op (the
    epilogue kernel wherever ``ops/norm.py`` ``epilogue_on_kernel``, else
    torch ops); same parameters as ``InstanceNorm``."""

    eps = 1e-3

    def __init__(self, channels: int, pad: int, negative_slope: float = 0.0,
                 device=None, generator: Optional[torch.Generator] = None,
                 impl: str = "auto"):
        super().__init__(channels, device, generator)
        self.pad = pad
        self.negative_slope = negative_slope
        self.impl = impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return instance_norm_act_pad(x, self.scale, self.bias, self.pad,
                                     self.eps, self.negative_slope, self.impl)


def norm_act(x: torch.Tensor, norm: NormParams, pad_after: int,
             negative_slope: float, fuse: bool, impl: str) -> torch.Tensor:
    """The IN > activation tail of Downsample and Upsample (JAX
    ``_norm_act_epilogue``): one epilogue site where ``pad_after`` > 0 or
    ``fuse``, else a standalone norm, then the (leaky) ReLU."""
    if pad_after or fuse:
        return instance_norm_act_pad(x, norm.scale, norm.bias, pad_after,
                                     InstanceNorm.eps, negative_slope, impl)
    y = instance_norm(x, norm.scale, norm.bias, InstanceNorm.eps, impl)
    return leaky_relu(y, negative_slope) if negative_slope else torch.relu(y)


class ResidualBlock(nn.Module):
    """reflect-pad(1) > Conv3x3 VALID > IN > ReLU > reflect-pad(1) > Conv3x3
    VALID > IN > + skip (JAX ``ResidualBlock``, ``:242-298``). The pads are
    copies under ``pad_impl="pad"``, ``reflect_conv`` under "fused"; under
    "epilogue" the middle IN > ReLU > pad is one epilogue site and Conv_1
    a plain VALID conv over its padded output (``parity_padding`` for
    Conv_0's pad); under ``pad_mode="zero"`` both convs pad with zeros."""

    def __init__(self, channels: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, norm_impl: str = "auto",
                 pad_mode: str = "reflect", pad_impl: str = "pad"):
        super().__init__()
        kw = {"device": device, "generator": generator}
        padding = parity_padding(pad_mode, pad_impl)
        self.epilogue = pad_mode == "reflect" and pad_impl == "epilogue"
        self.Conv_0 = Conv(channels, channels, 3, padding=padding,
                           dtype=dtype, **kw)
        if self.epilogue:
            self.InstanceNorm_0 = FusedNormReluPad(channels, pad=1,
                                                   impl=norm_impl, **kw)
        else:
            self.InstanceNorm_0 = InstanceNorm(channels, impl=norm_impl, **kw)
        self.Conv_1 = Conv(channels, channels, 3,
                           padding="valid" if self.epilogue else padding,
                           dtype=dtype, **kw)
        self.InstanceNorm_1 = InstanceNorm(channels, impl=norm_impl, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.InstanceNorm_0(self.Conv_0(x))
        if not self.epilogue:
            y = torch.relu(y)
        return x + self.InstanceNorm_1(self.Conv_1(y))


class PerturbBlock(nn.Module):
    """Perturbative-GAN residual block (JAX ``PerturbBlock``,
    ``:326-369``): each 3x3 conv of ResidualBlock becomes
    Conv1x1(ReLU(x + mask)) with a fixed random mask per (block, layer),
    then IN, and the skip; K1 at both norms under ``norm_impl="pallas"``.
    The masks are non-persistent buffers ``mask_0`` and ``mask_1``, never
    in the ``state_dict``: copied to the activation's device at the first
    call (and again for another shape or device) from the host, where
    ``ops/prng.py`` draws each (block, layer, shape) once."""

    def __init__(self, channels: int, salt: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, norm_impl: str = "auto"):
        super().__init__()
        kw = {"device": device, "generator": generator}
        self.salt = salt
        self.dtype = dtype
        self.Conv_0 = Conv(channels, channels, 1, dtype=dtype, **kw)
        self.InstanceNorm_0 = InstanceNorm(channels, impl=norm_impl, **kw)
        self.Conv_1 = Conv(channels, channels, 1, dtype=dtype, **kw)
        self.InstanceNorm_1 = InstanceNorm(channels, impl=norm_impl, **kw)

    def mask(self, layer: int, y: torch.Tensor) -> torch.Tensor:
        name = f"mask_{layer}"
        shape = tuple(y.shape[1:])
        held = getattr(self, name, None)
        if held is None or tuple(held.shape) != shape or held.device != y.device:
            self.register_buffer(name, torch.tensor(
                prng.perturb_mask(self.salt, layer, shape), device=y.device),
                persistent=False)
        return getattr(self, name)

    def _perturb_conv(self, layer: int, conv: Conv,
                      y: torch.Tensor) -> torch.Tensor:
        mask = self.mask(layer, y)
        y, mask = cast(y, self.dtype), cast(mask, self.dtype)
        return conv(torch.relu(y + mask))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.InstanceNorm_0(self._perturb_conv(0, self.Conv_0, x))
        y = self.InstanceNorm_1(self._perturb_conv(1, self.Conv_1, y))
        return x + y


class Downsample(nn.Module):
    """Conv k x k (stride 2 by default) SAME (no bias) > IN > (leaky) ReLU
    (JAX ``Downsample``). ``fuse``: IN > LeakyReLU as one epilogue site
    with no pad (the discriminator's blocks under pad_impl="epilogue");
    else a standalone norm (K1 under "pallas"), then the activation."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 2, negative_slope: float = 0.0,
                 fuse: bool = False, device=None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, norm_impl: str = "auto"):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel_size, stride=stride,
                           padding="same", device=device, generator=generator,
                           dtype=dtype)
        self.InstanceNorm_0 = NormParams(cout, device, generator)
        self.negative_slope = negative_slope
        self.fuse = fuse
        self.norm_impl = norm_impl

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_act(self.Conv_0(x), self.InstanceNorm_0, 0,
                        self.negative_slope, self.fuse, self.norm_impl)


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


UPSAMPLE_IMPLS = ("dense", "zeroskip", "zeroskip_fused", "zeroskip_fused_int8")


class Upsample(nn.Module):
    """ConvTranspose3x3 stride 2 SAME (no bias) > IN > ReLU
    (> reflect-pad(pad_after)) (JAX ``Upsample``, ``:520-625``). Under
    "dense" and "zeroskip" the transposed conv runs on cuDNN
    (``ops/upsample.py``) and the tail is a standalone norm (or, with a
    pad, an epilogue site); under "zeroskip_fused" the whole block is one
    upsample kernel (K5). Under "zeroskip_fused_int8" the kernel is held
    quantized and stays int8 into the int8 upsample kernel (K6); that form
    only serves, in f32. ``forward`` takes the pad, which the generator
    decides from the output's shape."""

    eps = 1e-3

    def __init__(self, cin: int, cout: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 upsample_impl: str = "dense",
                 dtype: Optional[torch.dtype] = None, norm_impl: str = "auto"):
        super().__init__()
        if upsample_impl not in UPSAMPLE_IMPLS:
            raise ValueError(f"unknown upsample_impl {upsample_impl!r}")
        self.dtype = dtype
        self.impl = upsample_impl
        self.norm_impl = norm_impl
        self.ConvTranspose_0 = (
            QuantZeroSkipKernel(cin, cout, device)
            if upsample_impl == "zeroskip_fused_int8"
            else ZeroSkipKernel(cin, cout, device, generator))
        self.InstanceNorm_0 = NormParams(cout, device, generator)

    def forward(self, x: torch.Tensor, pad_after: int = 0) -> torch.Tensor:
        norm = self.InstanceNorm_0
        if self.impl == "zeroskip_fused_int8":
            q = self.ConvTranspose_0.kernel
            return upsample_norm_relu_pad_int8(
                x, q.int8_q, q.int8_scale, norm.scale, norm.bias, pad_after,
                self.eps)
        x = cast(x, self.dtype)
        kernel = cast(self.ConvTranspose_0.kernel, self.dtype)
        if self.impl == "zeroskip_fused":
            return upsample_norm_relu_pad(x, kernel, norm.scale, norm.bias,
                                          pad_after, self.eps)
        return norm_act(conv_transpose_up2(x, kernel, self.impl), norm,
                        pad_after, 0.0, False, self.norm_impl)
