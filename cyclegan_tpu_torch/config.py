"""Configuration read by the port's serving and training paths.

The port's own copy of the fields of the JAX package's ``config.py`` that
the port reads (``GeneratorConfig``, ``DiscriminatorConfig``, the
``ModelConfig`` fields the models read, ``OptimizerConfig``,
``LossConfig``, the ``TrainConfig`` fields of one train step, and
``Config`` holding them), with the same names and defaults: ResNet-9 and
a 70x70 PatchGAN with 64 filters, 256² f32; Adam lr 2e-4, b1 0.5, b2 0.9;
lambda_cycle 10, lambda_identity 5; batch size 1, seed 1234.

The three layout flags default to the one layout ported so far, the one
in which the JAX package puts every serving-path site on a kernel:
``instance_norm_impl="pallas"``, ``pad_impl="epilogue"``,
``upsample_impl="zeroskip_fused"``. All layouts of the JAX package share
one parameter tree, so this layout serves any generator's weights. The
other values of those flags, and bfloat16 compute, are not ported yet and
raise. The forms the JAX package builds its ``int8_fused`` serving tier
with (``upsample_impl="zeroskip_fused_int8"``, ``instance_norm_impl=
"pallas_fwd"``/``"auto_fwd"``) raise too: the port's engine builds that
tier itself from f32 weights (``ServeConfig(infer_tier=True)``). So do
the training options of later slices: ``grad_impl=
"fusedprop"``, ``grad_accum > 1`` and the health metrics
(``ObsConfig.health``).
"""

from __future__ import annotations

import dataclasses

# Flag values of the JAX package that later slices of the port bring in.
_LATER = {
    "instance_norm_impl": ("auto", "xla"),
    "pad_impl": ("pad", "fused"),
    "upsample_impl": ("dense", "zeroskip"),
    "compute_dtype": ("bfloat16",),
}
_PORTED = {
    "instance_norm_impl": "pallas",
    "pad_impl": "epilogue",
    "upsample_impl": "zeroskip_fused",
    "compute_dtype": "float32",
}
# The JAX package's int8_fused tier forms, which the port's engine selects.
_FUSED_TIER = {
    "instance_norm_impl": ("pallas_fwd", "auto_fwd"),
    "upsample_impl": ("zeroskip_fused_int8",),
}
_LATER_TRAIN = {"grad_impl": ("fusedprop",)}
_PORTED_TRAIN = {"grad_impl": "combined"}


def _check_ported(obj, ported: dict, later: dict) -> None:
    """Raise for a flag value of the JAX package that a later slice of the
    port brings in, for a form of the int8_fused tier, and for an unknown
    one."""
    for name, value_ported in ported.items():
        value = getattr(obj, name)
        if value == value_ported:
            continue
        if value in _FUSED_TIER.get(name, ()):
            raise ValueError(
                f"{name}={value!r} is a form of the int8_fused serving "
                "tier, which the engine builds itself from f32 weights: "
                "select it with ServeConfig(infer_tier=True) and keep "
                f"{name}={value_ported!r}")
        if value in later[name]:
            raise ValueError(
                f"{name}={value!r} is not ported yet: it comes with a "
                "later slice of the port (ROADMAP.md, Queue A); this "
                f"slice runs {name}={value_ported!r}")
        raise ValueError(f"unknown {name} {value!r}")


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
class DiscriminatorConfig:
    """70x70 PatchGAN discriminator architecture."""

    filters: int = 64
    num_downsampling: int = 3

    def __post_init__(self):
        if self.filters <= 0 or self.num_downsampling < 0:
            raise ValueError(f"invalid discriminator config {self}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    generator: GeneratorConfig = GeneratorConfig()
    discriminator: DiscriminatorConfig = DiscriminatorConfig()
    image_size: int = 256
    channels: int = 3
    compute_dtype: str = "float32"
    instance_norm_impl: str = "pallas"
    pad_impl: str = "epilogue"
    upsample_impl: str = "zeroskip_fused"

    def __post_init__(self):
        _check_ported(self, _PORTED, _LATER)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Four independent Adams; b2 0.9, not the CycleGAN paper's 0.999."""

    learning_rate: float = 2e-4
    b1: float = 0.5
    b2: float = 0.9


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """LSGAN + cycle + identity weights."""

    lambda_cycle: float = 10.0
    lambda_identity: float = 5.0


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 1  # per device; the port runs on one
    seed: int = 1234
    grad_accum: int = 1
    grad_impl: str = "combined"

    def __post_init__(self):
        if self.batch_size < 1 or self.grad_accum < 1:
            raise ValueError(f"invalid train config {self}")
        if self.grad_accum > 1:
            raise ValueError(
                f"grad_accum={self.grad_accum} is not ported yet: it comes "
                "with a later slice of the port (ROADMAP.md, Queue A); this "
                "slice runs grad_accum=1")
        _check_ported(self, _PORTED_TRAIN, _LATER_TRAIN)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Run telemetry. The health metrics of the JAX package's train step
    (``obs.health``, on there by default) come with a later slice."""

    health: bool = False

    def __post_init__(self):
        if self.health:
            raise ValueError(
                "health=True is not ported yet: it comes with a later slice "
                "of the port (ROADMAP.md, Queue A); this slice's train step "
                "returns the ten loss scalars only")


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    obs: ObsConfig = ObsConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
