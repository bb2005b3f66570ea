"""Configuration read by the port's serving and training paths.

The port's own copy of the fields of the JAX package's ``config.py`` that
the port reads (``GeneratorConfig``, ``DiscriminatorConfig``, the
``ModelConfig`` fields the models read, ``OptimizerConfig``,
``LossConfig``, ``DataConfig``, the ``TrainConfig`` fields of the train
step and of the training loop, and ``Config`` holding them), with the
same names and defaults: ResNet-9 and a 70x70 PatchGAN with 64 filters,
256² f32; Adam lr 2e-4, b1 0.5, b2 0.9; lambda_cycle 10, lambda_identity
5; batch size 1, seed 1234; resize 286, crop 256, 200 epochs, a
checkpoint every 10 and a ring of 3.

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
(``ObsConfig.health``), ``steps_per_dispatch > 1``, and any domain key
but ``horse2zebra`` (the domain registry).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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


def _later(what: str, runs: str) -> ValueError:
    return ValueError(f"{what} is not ported yet: it comes with a later "
                      "slice of the port (ROADMAP.md, Queue A); this slice "
                      f"runs {runs}")


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
            raise _later(f"{name}={value!r}", f"{name}={value_ported!r}")
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


# The domain registry comes with a later slice; its default key is the
# reference's dataset.
PORTED_DOMAIN = "horse2zebra"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline: the reference's resize 286 -> random crop 256 with a
    random horizontal flip, augmentations cached after epoch 0
    (``cache_augmented``, the reference's cache-after-augment quirk)."""

    domain: str = PORTED_DOMAIN
    dataset: str = "horse2zebra"
    data_dir: Optional[str] = None  # folder with trainA/trainB/testA/testB
    source: str = "auto"  # "folder" | "synthetic" | "auto" ("tfds": later)
    resize_size: int = 286
    crop_size: int = 256
    augment_flip: bool = True
    cache_augmented: bool = True
    synthetic_train_size: int = 64  # images per domain, source=synthetic
    synthetic_test_size: int = 16

    def __post_init__(self):
        if self.domain != PORTED_DOMAIN:
            raise _later(f"domain {self.domain!r} (the domain registry)",
                         f"domain={PORTED_DOMAIN!r}")
        if self.source not in ("auto", "folder", "synthetic", "tfds"):
            raise ValueError(f"unknown data source {self.source!r}")
        if not 0 < self.crop_size <= self.resize_size:
            raise ValueError(f"invalid data config {self}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    output_dir: str = "runs"
    epochs: int = 200
    batch_size: int = 1  # per device; the port runs on one
    verbose: int = 1
    clear_output_dir: bool = False
    seed: int = 1234
    checkpoint_every: int = 10
    # Checkpoint-ring depth: 1 = one overwritten slot named "checkpoint";
    # K > 1 keeps the K newest epoch slots, each with a sha256 manifest.
    ckpt_keep: int = 3
    plot_samples: int = 5
    steps_per_dispatch: int = 1
    # Batches the input thread stages on the device ahead of the loop;
    # 0 stages inline on the loop's thread.
    prefetch_batches: int = 2
    grad_accum: int = 1
    grad_impl: str = "combined"

    def __post_init__(self):
        if (self.batch_size < 1 or self.grad_accum < 1 or self.epochs < 0
                or self.checkpoint_every < 1 or self.steps_per_dispatch < 1
                or self.prefetch_batches < 0):
            raise ValueError(f"invalid train config {self}")
        if self.ckpt_keep < 1:
            raise ValueError(
                f"train.ckpt_keep must be >= 1, got {self.ckpt_keep}")
        if self.grad_accum > 1:
            raise _later(f"grad_accum={self.grad_accum}", "grad_accum=1")
        if self.steps_per_dispatch > 1:
            raise _later(f"steps_per_dispatch={self.steps_per_dispatch}",
                         "steps_per_dispatch=1")
        _check_ported(self, _PORTED_TRAIN, _LATER_TRAIN)


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Run telemetry. The health metrics of the JAX package's train step
    (``obs.health``, on there by default) come with a later slice."""

    health: bool = False

    def __post_init__(self):
        if self.health:
            raise _later("health=True", "health=False (the train step "
                         "returns the ten loss scalars only)")


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    loss: LossConfig = LossConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()
    obs: ObsConfig = ObsConfig()

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def model_meta(self) -> dict:
        """The architecture as JSON, kept beside each checkpoint so that
        ``translate`` rebuilds the network without repeated flags."""
        return {"model": dataclasses.asdict(self.model)}

    @staticmethod
    def model_from_meta(meta: dict, **overrides) -> ModelConfig:
        """A ``ModelConfig`` from ``model_meta``'s output; keys this port
        does not know are dropped, and ``overrides`` win."""
        recorded = dict(meta.get("model") or {})
        gen = recorded.pop("generator", None)
        disc = recorded.pop("discriminator", None)

        def known(cls, d):
            names = {f.name for f in dataclasses.fields(cls)}
            return {k: v for k, v in (d or {}).items() if k in names}

        kw = known(ModelConfig, recorded)
        if gen is not None:
            kw["generator"] = GeneratorConfig(**known(GeneratorConfig, gen))
        if disc is not None:
            kw["discriminator"] = DiscriminatorConfig(
                **known(DiscriminatorConfig, disc))
        kw.update(overrides)
        return ModelConfig(**kw)
