"""Model configuration read by the port's serving path.

The port's own copy of the fields of the JAX package's ``config.py``
(``GeneratorConfig`` and the ``ModelConfig`` fields the generator reads),
with the same names. Architecture defaults are the same: ResNet-9, 64
filters, 256² f32.

The three layout flags default to the one layout ported so far, the one
in which the JAX package puts every serving-path site on a kernel:
``instance_norm_impl="pallas"``, ``pad_impl="epilogue"``,
``upsample_impl="zeroskip_fused"``. All layouts of the JAX package share
one parameter tree, so this layout serves any generator's weights. The
other values of those flags, and bfloat16 compute, are not ported yet and
raise.
"""

from __future__ import annotations

import dataclasses

# Flag values of the JAX package that later slices of the port bring in.
_LATER = {
    "instance_norm_impl": ("auto", "xla", "auto_fwd", "pallas_fwd"),
    "pad_impl": ("pad", "fused"),
    "upsample_impl": ("dense", "zeroskip", "zeroskip_fused_int8"),
    "compute_dtype": ("bfloat16",),
}
_PORTED = {
    "instance_norm_impl": "pallas",
    "pad_impl": "epilogue",
    "upsample_impl": "zeroskip_fused",
    "compute_dtype": "float32",
}


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    """ResNet generator architecture."""

    filters: int = 64
    num_downsampling_blocks: int = 2
    num_residual_blocks: int = 9
    num_upsample_blocks: int = 2

    def __post_init__(self):
        if self.filters <= 0 or self.num_residual_blocks < 0:
            raise ValueError(f"invalid generator config {self}")
        if self.num_downsampling_blocks != self.num_upsample_blocks:
            raise ValueError(
                "the generator needs as many upsample as downsample blocks, "
                f"got {self.num_downsampling_blocks} and "
                f"{self.num_upsample_blocks}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    generator: GeneratorConfig = GeneratorConfig()
    image_size: int = 256
    channels: int = 3
    compute_dtype: str = "float32"
    instance_norm_impl: str = "pallas"
    pad_impl: str = "epilogue"
    upsample_impl: str = "zeroskip_fused"

    def __post_init__(self):
        for name, ported in _PORTED.items():
            value = getattr(self, name)
            if value == ported:
                continue
            if value in _LATER[name]:
                raise ValueError(
                    f"{name}={value!r} is not ported yet: it comes with a "
                    "later slice of the port (ROADMAP.md, Queue A); this "
                    f"slice serves {name}={ported!r}")
            raise ValueError(f"unknown {name} {value!r}")
