"""Analytic FLOPs of the CycleGAN train step: the port's copy of the JAX
package's ``utils/flops.py`` (``train_step_flops_per_image`` and what it
calls), with the card's peak in place of the TPU table.

Counts convolution multiply-accumulates (the >99% term; norms,
activations and padding are bound by bytes, not FLOPs) over the
architectures of ``models/generator.py`` and ``models/discriminator.py``.
A backward costs about twice a forward, so with ``grad_impl="combined"``
the 6 generator applies and the 4 discriminator applies with live weights
cost 3 forwards each, the 2 discriminator applies with detached weights
(the adversarial terms) 2: a step is 18g + 16d. ``perf/tflops_per_sec``
and ``perf/mfu`` (``main.py``) divide by these.

The upsample counts only the live taps of its phase decomposition
(``upsample_impl="zeroskip_fused"``, the port's layout): in_h*in_w*
c_in*c_out*9 MACs, a quarter of the dense transposed conv's.
"""

from __future__ import annotations

from typing import List, Tuple

from cyclegan_tpu_torch.config import Config

# Conv layer spec: (out_h, out_w, c_in, c_out, k_h, k_w). MACs = product.
_Layer = Tuple[int, int, int, int, int, int]


def _conv_macs(layers: List[_Layer]) -> int:
    return sum(h * w * ci * co * kh * kw for h, w, ci, co, kh, kw in layers)


def generator_layers(
    image_size: int,
    filters: int = 64,
    num_residual_blocks: int = 9,
    num_downsampling_blocks: int = 2,
    num_upsample_blocks: int = 2,
    in_channels: int = 3,
    out_channels: int = 3,
) -> List[_Layer]:
    """Conv shapes of ResNetGenerator (models/generator.py)."""
    s = image_size
    f = filters
    layers: List[_Layer] = [(s, s, in_channels, f, 7, 7)]  # c7s1, reflect+valid
    for _ in range(num_downsampling_blocks):  # Conv3x3 s2 SAME
        s //= 2
        layers.append((s, s, f, 2 * f, 3, 3))
        f *= 2
    for _ in range(num_residual_blocks):  # two trunk convs, 3x3
        layers.append((s, s, f, f, 3, 3))
        layers.append((s, s, f, f, 3, 3))
    for _ in range(num_upsample_blocks):
        # ConvTranspose 3x3 s2: 9 live taps per INPUT pixel.
        layers.append((s, s, f, f // 2, 3, 3))
        s *= 2
        f //= 2
    layers.append((s, s, f, out_channels, 7, 7))
    return layers


def discriminator_layers(
    image_size: int,
    filters: int = 64,
    num_downsampling: int = 3,
    in_channels: int = 3,
) -> List[_Layer]:
    """Conv shapes of PatchGANDiscriminator (models/discriminator.py)."""
    s = image_size // 2  # stem: Conv4x4 s2 SAME
    f = filters
    layers: List[_Layer] = [(s, s, in_channels, f, 4, 4)]
    for i in range(num_downsampling):  # s2, s2, then s1
        if i < 2:
            s //= 2
        layers.append((s, s, f, 2 * f, 4, 4))
        f *= 2
    layers.append((s, s, f, 1, 4, 4))  # patch logits head
    return layers


def generator_fwd_flops(config: Config) -> int:
    """Forward FLOPs (2*MACs) for one generator apply on one image."""
    g = config.model.generator
    return 2 * _conv_macs(
        generator_layers(
            config.model.image_size,
            filters=g.filters,
            num_residual_blocks=g.num_residual_blocks,
            num_downsampling_blocks=g.num_downsampling_blocks,
            num_upsample_blocks=g.num_upsample_blocks,
        )
    )


def discriminator_fwd_flops(config: Config) -> int:
    """Forward FLOPs (2*MACs) for one discriminator apply on one image."""
    d = config.model.discriminator
    return 2 * _conv_macs(
        discriminator_layers(
            config.model.image_size,
            filters=d.filters,
            num_downsampling=d.num_downsampling,
        )
    )


def train_step_flops_per_pair(config: Config) -> int:
    """FLOPs of one train step per (x, y) pair with grad_impl="combined":
    6 generator applies live (x3) + per discriminator {adversarial site
    x2, fake site x3, real site x3} = 18g + 16d. The optimizer update is
    O(params), negligible next to O(params * spatial)."""
    g = generator_fwd_flops(config)
    d = discriminator_fwd_flops(config)
    return 6 * 3 * g + 4 * 3 * d + 2 * 2 * d


def train_step_flops_per_image(config: Config) -> float:
    """FLOPs per *counted* image: throughput counts both domains' images
    (2 per pair per step), so per-image cost is half the pair cost."""
    return train_step_flops_per_pair(config) / 2.0


# The card's peak for the port's convolutions, which run in f32 with TF32
# off: the H100 SXM's f32 rate outside the tensor cores (NVIDIA data sheet),
# the figure chip_smoke.py bounds its kernels with.
H100_F32_PEAK_TFLOPS = 67.0


def peak_tflops_for_device(device) -> float | None:
    """The f32 peak of ``device`` in TFLOP/s: the H100's on an H100, None
    elsewhere (the CPU, other cards), so that no MFU is reported there."""
    import torch

    device = torch.device(device)
    if device.type != "cuda" or "H100" not in torch.cuda.get_device_name(device):
        return None
    return H100_F32_PEAK_TFLOPS
