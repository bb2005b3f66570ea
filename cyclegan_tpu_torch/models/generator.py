"""ResNet-9 CycleGAN generator (the JAX package's models/generator.py).

  c7s1-64: reflect-pad 3, Conv7x7 (no bias), IN, ReLU
  2 downsampling blocks, 64 > 128 > 256 filters
  9 residual blocks at 256 (or perturb blocks: ``trunk_impl="perturb"``)
  2 upsampling blocks, 256 > 128 > 64
  reflect-pad 3, Conv7x7 VALID -> 3 channels (with bias), tanh

About 11.4M parameters at the default sizes. The layout arguments are the
JAX generator's (``:88-229``): ``norm_impl``, ``pad_mode``, ``pad_impl``,
``trunk_impl``, ``upsample_impl``, ``remat`` and ``scan_blocks``
(models/modules.py; ``ModelConfig.layout`` gives them from a config).

- Under ``pad_impl="epilogue"`` the last upsample's norm tail also
  reflect-pads by 3 for the tail conv, as one epilogue site (or inside
  K5 under "zeroskip_fused"), wherever the epilogue kernel's plan takes
  the [N, H, W, filters] output slab (``epilogue_eligible``, decided from
  the trunk's shape at each call); the tail conv is then VALID.
- ``remat``: each residual or perturb block runs under
  ``torch.utils.checkpoint`` (non-reentrant, no RNG state: the blocks
  draw no random numbers, and ``get_rng_state`` is illegal in a CUDA
  graph's capture), so its activations are recomputed in the backward and
  its forward kernels run twice a step.
- ``scan_blocks``: the trunk's parameters are stacked on a leading axis
  under ``ScannedTrunk.ResidualBlock_0.*`` (JAX ``:116-145``), and the
  blocks run one by one over their slices. torch has no ``lax.scan`` to
  compile, so this is a storage layout: the ``state_dict``, the slots and
  Adam's state hold the stacked tensors.

In the kernel layout (``config.KERNEL_LAYOUT``) every instance norm is one
of three kernels: 12 instance-norm sites (Conv_0's, the downsamples',
each residual block's InstanceNorm_1), 9 epilogue sites (each residual
block's InstanceNorm_0) and 2 upsample sites. In the JAX default layout
(``auto``, ``pad``, ``dense``) none is: the norms resolve to torch ops and
the upsample to cuDNN. ``models/layout.py`` counts each kernel's
launches for a layout.

``upsample_impl="zeroskip_fused_int8"`` holds the two upsample kernels
quantized and runs them on the int8 upsample kernel (the ``int8_fused``
serving tier); every other parameter is as in the served layout.

``dtype=torch.bfloat16`` is the JAX package's bfloat16 compute: the input
is cast to bf16, every site computes in bf16 over the same f32 parameters
(models/modules.py), and the output is cast back to the input's type after
the tanh (JAX ``generator.py:97-99``, ``:227-228``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from cyclegan_tpu_torch.config import GeneratorConfig
from cyclegan_tpu_torch.models.modules import (
    Conv,
    Downsample,
    InstanceNorm,
    PerturbBlock,
    ResidualBlock,
    Upsample,
    cast,
    parity_padding,
)
from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import epilogue_eligible

# The tail conv's reflect padding, fused into the last upsample under
# pad_impl="epilogue".
TAIL_PAD = 3
TRUNK_IMPLS = ("resnet", "perturb")


def use_full_fp32() -> None:
    """Keep f32 convolutions and matmuls in full f32 on the card: cuDNN
    convolutions default to TF32 on Hopper (about three decimal digits),
    which the f32 serving path must not take."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def remat_call(fn, remat: bool, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where ``remat`` and
    autograd records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


class ScannedTrunk(nn.Module):
    """The residual trunk with its parameters stacked on a leading axis:
    ``ResidualBlock_0`` holds every parameter of a ResidualBlock as one
    tensor of [num_blocks, ...] (conv weights laid out so that each
    block's slice is ``channels_last``), and ``forward`` runs block i as a
    ResidualBlock over slice i (``torch.func.functional_call`` over a
    skeleton on the meta device). Initial weights are the unrolled trunk's
    for the same generator."""

    def __init__(self, channels: int, num_blocks: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False, **block_kw):
        super().__init__()
        self.num_blocks = num_blocks
        self.remat = remat
        blocks = [ResidualBlock(channels, device=device, generator=generator,
                                **block_kw) for _ in range(num_blocks)]
        self.ResidualBlock_0 = ResidualBlock(channels, device="meta",
                                             **block_kw)
        for name, _ in list(blocks[0].named_parameters()):
            owner_name, _, leaf = name.rpartition(".")
            parts = [dict(b.named_parameters())[name].detach()
                     for b in blocks]
            stacked = torch.stack(parts)
            if stacked.dim() == 5:  # conv weights: each slice channels_last
                stacked = stacked.permute(0, 1, 3, 4, 2).contiguous().permute(
                    0, 1, 4, 2, 3)
            owner = self.ResidualBlock_0.get_submodule(owner_name)
            setattr(owner, leaf, nn.Parameter(stacked))
        # Not a submodule: its parameters stay on the meta device and are
        # never in the state_dict.
        self.__dict__["skeleton"] = ResidualBlock(channels, device="meta",
                                                  **block_kw)

    def block(self, i: int, y: torch.Tensor) -> torch.Tensor:
        params = {name: p[i] for name, p in
                  self.ResidualBlock_0.named_parameters()}
        return torch.func.functional_call(self.skeleton, params, (y,))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            y = remat_call(self.block, self.remat, i, y)
        return y


class ResNetGenerator(nn.Module):
    def __init__(self, config: GeneratorConfig = GeneratorConfig(),
                 in_channels: int = 3, out_channels: int = 3,
                 device="cuda", generator: Optional[torch.Generator] = None,
                 upsample_impl: str = "dense",
                 dtype: Optional[torch.dtype] = None, *,
                 norm_impl: str = "auto", pad_mode: str = "reflect",
                 pad_impl: str = "pad", trunk_impl: str = "resnet",
                 remat: bool = False, scan_blocks: bool = False):
        super().__init__()
        if trunk_impl not in TRUNK_IMPLS:
            raise ValueError(f"unknown trunk_impl {trunk_impl!r}")
        if scan_blocks and trunk_impl != "resnet":
            raise ValueError(
                "scan_blocks requires trunk_impl='resnet' (perturb blocks "
                "need per-block mask salts; the scanned trunk shares one "
                f"body), got {trunk_impl!r}")
        f = config.filters
        self.dtype = dtype
        self.remat = remat
        self.trunk_impl = trunk_impl
        self.scan_blocks = scan_blocks
        self.epilogue = pad_mode == "reflect" and pad_impl == "epilogue"
        self.edge_padding = parity_padding(pad_mode, pad_impl)
        self.upsample_blocks = config.num_upsample_blocks
        self.filters = f
        kw = {"device": device, "generator": generator}
        self.Conv_0 = Conv(in_channels, f, 7, padding=self.edge_padding,
                           dtype=dtype, **kw)
        self.InstanceNorm_0 = InstanceNorm(f, impl=norm_impl, **kw)
        self.stages = []
        for i in range(config.num_downsampling_blocks):
            self._stage(f"Downsample_{i}", Downsample(
                f, 2 * f, dtype=dtype, norm_impl=norm_impl, **kw))
            f *= 2
        self.trunk = []
        block_kw = dict(dtype=dtype, norm_impl=norm_impl)
        if scan_blocks:
            self.ScannedTrunk = ScannedTrunk(
                f, config.num_residual_blocks, remat=remat, pad_mode=pad_mode,
                pad_impl=pad_impl, **block_kw, **kw)
            self.trunk.append("ScannedTrunk")
        for i in range(0 if scan_blocks else config.num_residual_blocks):
            if trunk_impl == "perturb":
                block = PerturbBlock(f, salt=i, **block_kw, **kw)
            else:
                block = ResidualBlock(f, pad_mode=pad_mode, pad_impl=pad_impl,
                                      **block_kw, **kw)
            self.add_module(f"ResidualBlock_{i}", block)
            self.trunk.append(f"ResidualBlock_{i}")
        self.ups = []
        for i in range(config.num_upsample_blocks):
            self.add_module(f"Upsample_{i}", Upsample(
                f, f // 2, upsample_impl=upsample_impl, dtype=dtype,
                norm_impl=norm_impl, **kw))
            self.ups.append(f"Upsample_{i}")
            f //= 2
        self.Conv_1 = Conv(f, out_channels, 7, padding=self.edge_padding,
                           use_bias=True, dtype=dtype, **kw)

    def _stage(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.stages.append(name)

    def tail_pad(self, y: torch.Tensor) -> int:
        """The reflect pad the last upsample takes for the tail conv, from
        the trunk's output ``y``: 3 under ``pad_impl="epilogue"`` where the
        epilogue kernel's plan takes the output slab, else 0 (JAX
        ``generator.py:185-199``)."""
        if not self.epilogue:
            return 0
        scale = 2 ** self.upsample_blocks
        out = (y.shape[0], y.shape[1] * scale, y.shape[2] * scale,
               self.filters)
        return TAIL_PAD if epilogue_eligible(out, y.dtype, TAIL_PAD) else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, H, W, C] f32 in [-1, 1] -> [N, H, W, out_channels] f32 (the
        input's type), computed in ``dtype``."""
        if x.is_cuda:
            use_full_fp32()
        in_dtype = x.dtype
        y = torch.relu(self.InstanceNorm_0(self.Conv_0(cast(x, self.dtype))))
        for name in self.stages:
            y = getattr(self, name)(y)
        for name in self.trunk:
            block = getattr(self, name)
            # The scanned trunk takes remat block by block itself.
            y = block(y) if name == "ScannedTrunk" else \
                remat_call(block, self.remat, y)
        pad = self.tail_pad(y)
        for i, name in enumerate(self.ups):
            y = getattr(self, name)(y, pad if i == len(self.ups) - 1 else 0)
        y = self.Conv_1(y, "valid" if pad else None)
        return torch.tanh(y).to(in_dtype)
