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

``ModelConfig`` takes every layout of the JAX package with its defaults
(``instance_norm_impl="auto"``, ``pad_mode="reflect"``,
``pad_impl="pad"``, ``upsample_impl="dense"``, ``trunk_impl="resnet"``,
``remat`` and ``scan_blocks`` off) and rejects each combination the JAX
package rejects, with its message. The JAX default layout runs no
hand-written kernel: its norms are all standalone and resolve to torch
ops, and its upsample is cuDNN's. ``KERNEL_LAYOUT`` (``pallas``,
``epilogue``, ``zeroskip_fused``) puts every norm, epilogue and upsample
site on one. All resnet-trunk layouts share one parameter tree; the
perturb trunk and the scanned storage have their own (``convert.py``).
``spatial_impl="halo"`` is not ported yet and raises.
``compute_dtype`` takes "float32" and "bfloat16" (the JAX package's mixed
precision: f32 parameters, optimizer state and gradients; bf16 convs and
activations; f32 statistics and losses). The forms the JAX package builds its ``int8_fused`` serving tier
with (``upsample_impl="zeroskip_fused_int8"``, ``instance_norm_impl=
"pallas_fwd"``/``"auto_fwd"``) raise too: the port's engine builds that
tier itself from f32 weights (``ServeConfig(infer_tier=True)``). So does
``ObsConfig.on_nan="rollback"``, which comes with a later slice.
``steps_per_dispatch`` K > 1 runs K steps a dispatch as one CUDA graph
(``train/multistep.py``), and ``preempt_deadline_s`` > 0 arms the
step-granular emergency save (``resil/elastic.py``).

The train step's options keep the JAX package's names, defaults and
validation: ``grad_impl`` ``"combined"``/``"fusedprop"``, ``grad_accum``,
the transfer fields (``init_from``, ``transfer_mode``, ``strict_domain``),
the health metrics (``ObsConfig.health``, on by default) and their
detectors' settings, and any valid domain key (``domains/registry.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Flag values of the JAX package that a later slice of the port brings in.
_LATER = {
    "spatial_impl": ("halo",),
}
COMPUTE_DTYPES = ("float32", "bfloat16")
# The JAX package's int8_fused tier forms, which the port's engine selects.
_FUSED_TIER = {
    "instance_norm_impl": ("pallas_fwd", "auto_fwd"),
    "upsample_impl": ("zeroskip_fused_int8",),
}
# The layout in which every norm, epilogue and upsample site of the
# generator and the discriminator is a hand-written kernel (K1-K5).
KERNEL_LAYOUT = {
    "instance_norm_impl": "pallas",
    "pad_impl": "epilogue",
    "upsample_impl": "zeroskip_fused",
}


def _later(what: str, runs: str) -> ValueError:
    return ValueError(f"{what} is not ported yet: it comes with a later "
                      "slice of the port (ROADMAP.md, Queue A); this slice "
                      f"runs {runs}")


def _check_choice(name: str, value, choices: tuple) -> None:
    """Raise, with the JAX package's message, for a value outside
    ``choices``; for a form of the int8_fused tier, with a pointer to the
    engine's tier."""
    if value in _FUSED_TIER.get(name, ()):
        raise ValueError(
            f"{name}={value!r} is a form of the int8_fused serving tier, "
            "which the engine builds itself from f32 weights: select it "
            "with ServeConfig(infer_tier=True) and keep a training layout")
    if value not in choices:
        listed = ", ".join(repr(c) for c in choices[:-1])
        raise ValueError(f"{name} must be {listed} or {choices[-1]!r}, "
                         f"got {value!r}")


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
    """The architecture and its layout, with the JAX package's fields,
    values, defaults and refusals (JAX ``config.py:46-215``).

    - ``pad_mode``: "reflect" (the reference) or "zero" (the convs' own
      SAME padding; same parameter tree, other borders).
    - ``pad_impl``: how reflect padding is scheduled: "pad" (a padded copy,
      then a VALID conv), "fused" (``ops/padding.py`` ``reflect_conv``:
      the conv's zero padding plus thin border corrections) or "epilogue"
      (each residual block's IN > ReLU > reflect-pad, the last upsample's
      tail pad and the discriminator's IN > LeakyReLU tails as one
      epilogue kernel, K3, each; the other pads stay copies, where the
      JAX package schedules them as under "fused": models/modules.py
      ``parity_padding``).
    - ``instance_norm_impl``: "pallas" (the standalone norms on K1),
      "xla" (torch ops, no kernel) or "auto" ("xla" for a standalone norm,
      K3 at every epilogue site its plan takes).
    - ``upsample_impl``: "dense" (cuDNN's transposed conv), "zeroskip"
      (its four output phases as cuDNN convs) or "zeroskip_fused" (the
      whole block on the upsample kernel, K5).
    - ``trunk_impl``: "resnet" or "perturb" (fixed random masks and 1x1
      convs; another parameter tree).
    - ``remat``: recompute each residual block in the backward.
    - ``scan_blocks``: the trunk's parameters stacked on a leading axis
      (``ScannedTrunk.ResidualBlock_0``), the blocks run one by one.
    - ``spatial_impl``: "xla" only here ("halo" needs a mesh).

    ``pad_impl="epilogue"`` raises at start-up where K3's launch plan
    cannot take the residual trunk's slab (``ops/cuda/epilogue_kernel.py``
    ``epilogue_eligible``), as the JAX package raises where it does not
    fit the TPU's VMEM."""

    generator: GeneratorConfig = GeneratorConfig()
    discriminator: DiscriminatorConfig = DiscriminatorConfig()
    image_size: int = 256
    channels: int = 3
    compute_dtype: str = "float32"
    remat: bool = False
    scan_blocks: bool = False
    instance_norm_impl: str = "auto"
    pad_mode: str = "reflect"
    pad_impl: str = "pad"
    trunk_impl: str = "resnet"
    upsample_impl: str = "dense"
    spatial_impl: str = "xla"

    def __post_init__(self):
        _check_choice("pad_mode", self.pad_mode, ("reflect", "zero"))
        _check_choice("instance_norm_impl", self.instance_norm_impl,
                      ("auto", "xla", "pallas"))
        _check_choice("pad_impl", self.pad_impl, ("pad", "fused", "epilogue"))
        _check_choice("trunk_impl", self.trunk_impl, ("resnet", "perturb"))
        _check_choice("upsample_impl", self.upsample_impl,
                      ("dense", "zeroskip", "zeroskip_fused"))
        _check_choice("spatial_impl", self.spatial_impl, ("xla", "halo"))
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.spatial_impl == "halo" and self.pad_impl in (
                "fused", "epilogue"):
            raise ValueError(
                f"spatial_impl='halo' is incompatible with pad_impl="
                f"{self.pad_impl!r}: the halo path schedules its own "
                "pad+conv inside shard_map, so there is no separate "
                "reflect-pad site for the fused/epilogue kernels to "
                "absorb — use pad_impl='pad'")
        if self.spatial_impl in _LATER["spatial_impl"]:
            raise _later(f"spatial_impl={self.spatial_impl!r} (a spatially "
                         "sharded mesh)", "spatial_impl='xla'")
        if (self.upsample_impl == "zeroskip_fused"
                and self.instance_norm_impl == "xla"):
            raise ValueError(
                f"upsample_impl={self.upsample_impl!r} embeds a Pallas "
                "instance norm in the fused upsample kernel; "
                "instance_norm_impl='xla' contradicts it — use 'auto' (or "
                "'pallas'), or upsample_impl='zeroskip' for the pure-XLA "
                "decomposition")
        if self.trunk_impl == "perturb" and self.scan_blocks:
            raise ValueError(
                "trunk_impl='perturb' is incompatible with scan_blocks: "
                "each perturb block derives a DISTINCT fixed mask from its "
                "block index, while lax.scan shares one traced body across "
                "all blocks — unroll the trunk (scan_blocks=False)")
        if self.trunk_impl == "perturb" and self.pad_impl == "epilogue":
            raise ValueError(
                "trunk_impl='perturb' is incompatible with "
                "pad_impl='epilogue': the epilogue kernel fuses the resnet "
                "trunk's IN>ReLU>reflect-pad chains, and the perturb trunk "
                "has no 3x3 pad sites to fuse — use pad_impl='fused' (edge "
                "convs still benefit) or 'pad'")
        if self.pad_mode == "zero" and self.pad_impl != "pad":
            raise ValueError(
                f"pad_impl={self.pad_impl!r} requires pad_mode='reflect' "
                "(it schedules reflect semantics; with pad_mode='zero' "
                "there is no reflect pad to fuse)")
        if self.pad_impl == "epilogue":
            if self.instance_norm_impl == "xla":
                raise ValueError(
                    "pad_impl='epilogue' embeds a Pallas instance norm in "
                    "the fused IN>ReLU>reflect-pad kernel; "
                    "instance_norm_impl='xla' contradicts it — use 'auto' "
                    "(or 'pallas')")
            self._check_epilogue_plan()

    def _check_epilogue_plan(self) -> None:
        """Raise where K3's launch plan cannot take the residual trunk's
        slab, batch 1, in the compute dtype: every trunk site would then
        compose the norm, the ReLU and the pad from torch ops."""
        import torch

        from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
            epilogue_eligible,
        )

        gen = self.generator
        trunk = self.image_size // (2 ** gen.num_downsampling_blocks)
        shape = (1, trunk, trunk,
                 gen.filters * 2 ** gen.num_downsampling_blocks)
        dtype = torch.bfloat16 if self.compute_dtype == "bfloat16" \
            else torch.float32
        if not epilogue_eligible(shape, dtype, 1):
            raise ValueError(
                f"pad_impl='epilogue' is ineligible at image_size="
                f"{self.image_size} / compute_dtype={self.compute_dtype!r}: "
                f"the epilogue kernel's launch plan cannot take the "
                f"residual trunk's slab {list(shape)} with a reflect pad "
                "of 1 — use pad_impl='fused' for this configuration")

    @property
    def layout(self) -> dict:
        """The layout fields, as the models' constructors take them."""
        return {"norm_impl": self.instance_norm_impl,
                "pad_mode": self.pad_mode, "pad_impl": self.pad_impl,
                "trunk_impl": self.trunk_impl,
                "upsample_impl": self.upsample_impl, "remat": self.remat,
                "scan_blocks": self.scan_blocks}


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
class DataConfig:
    """Input pipeline: the reference's resize 286 -> random crop 256 with a
    random horizontal flip, augmentations cached after epoch 0
    (``cache_augmented``, the reference's cache-after-augment quirk)."""

    # Registry key of the run's domain pair (domains/registry.py): recorded
    # in every checkpoint's meta.json and checked on resume.
    domain: str = "horse2zebra"
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
        from cyclegan_tpu_torch.domains.registry import _KEY_RE, DomainError

        if not _KEY_RE.match(self.domain or ""):
            raise DomainError(
                f"data.domain {self.domain!r} is not a valid domain key "
                f"(want {_KEY_RE.pattern})")
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
    # One update from grad_accum microbatches of batch_size each
    # (train/steps.py make_accum_train_step).
    grad_accum: int = 1
    grad_impl: str = "combined"  # "combined" | "fusedprop"
    # Transfer onboarding (domains/transfer.py): a parent run directory
    # whose ring seeds the four networks' weights; "encoder_freeze" also
    # zeroes both generators' encoder gradients.
    init_from: Optional[str] = None
    transfer_mode: str = "full_finetune"  # "full_finetune" | "encoder_freeze"
    # Refuse, rather than warn, a checkpoint of another domain.
    strict_domain: bool = False
    # Preemption grace budget in seconds (resil/elastic.py). 0: a SIGTERM
    # finishes the epoch, then checkpoints. > 0: the loop polls once per
    # dispatch and, on SIGTERM, writes a step-granular slot (epoch, step,
    # data seed) within this many seconds of the signal.
    preempt_deadline_s: float = 0.0

    def __post_init__(self):
        if (self.batch_size < 1 or self.grad_accum < 1 or self.epochs < 0
                or self.checkpoint_every < 1 or self.steps_per_dispatch < 1
                or self.prefetch_batches < 0):
            raise ValueError(f"invalid train config {self}")
        if self.ckpt_keep < 1:
            raise ValueError(
                f"train.ckpt_keep must be >= 1, got {self.ckpt_keep}")
        if self.grad_impl not in ("combined", "fusedprop"):
            raise ValueError(
                f"unknown grad_impl: train.grad_impl must be 'combined' or "
                f"'fusedprop', got {self.grad_impl!r}")
        if self.transfer_mode not in ("full_finetune", "encoder_freeze"):
            raise ValueError(
                f"train.transfer_mode must be 'full_finetune' or "
                f"'encoder_freeze', got {self.transfer_mode!r}")
        if self.grad_accum > 1 and self.steps_per_dispatch > 1:
            raise ValueError(
                "--grad_accum and --steps_per_dispatch are mutually exclusive "
                "(one fuses updates, the other splits one update)")
        if self.preempt_deadline_s < 0:
            raise ValueError(
                f"train.preempt_deadline_s must be >= 0, got "
                f"{self.preempt_deadline_s}")


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Run telemetry (obs/): the JSONL event stream, the stall watchdog,
    memory watermarks, training traces, and the health metrics of the
    train step with their host-side detectors (obs/health.py), with the
    JAX package's ``ObsConfig`` names and defaults. The collective probe's
    fields come with data parallelism.

    On the card the goodput ledger's ``host`` and ``compute`` phases are
    not reliable: a launch blocks while the card's launch queue is full,
    so device time lands in the step records' ``dispatch_s`` (and so in
    ``host``) rather than at the fetch (``compute``), where the JAX
    model puts it."""

    enabled: bool = True
    # Append-only JSONL event stream; None resolves to
    # <output_dir>/telemetry.jsonl, "none" or "off" disables it.
    jsonl_path: Optional[str] = None
    # Stall watchdog: warn (and record the pending depth) when no step
    # completes within this many seconds; 0 disables the thread.
    watchdog_deadline_s: float = 0.0
    # Emit a per-dispatch `step` event every N dispatches (0 = the
    # epoch_steps aggregates only).
    step_log_every: int = 1
    # Sample the device's memory watermarks every N epochs (0 disables).
    memory_sample_every: int = 1
    # A `loop_stall` event when one dispatch's wall exceeds this multiple
    # of the rolling median (32-dispatch window, armed after 5); 0
    # disables.
    stall_multiple: float = 10.0
    # Gradient norms, update ratios, a non-finite count and the
    # discriminators' output moments, computed in the step.
    health: bool = True
    # Non-finite gradients: "warn" keeps training, "halt" ends the run
    # with the newest slot intact ("rollback" comes with a later slice).
    on_nan: str = "warn"
    # Warn when loss_G/total or loss_F/total exceeds this multiple of its
    # EMA (0 disables).
    divergence_multiple: float = 4.0
    # Warn when a discriminator's outputs stay within collapse_eps of the
    # LSGAN targets for collapse_patience rows (eps <= 0 disables).
    collapse_eps: float = 0.05
    collapse_patience: int = 50
    # Training traces (obs/train_trace.py): one `trace` event an epoch
    # whose dispatch spans tile the epoch's wall, from the step clock's
    # timestamps; 0 disables, F > 0 also gives that fraction of dispatches
    # hop-level child spans.
    train_trace_sample: float = 0.0
    # Spans a trace may hold; drops are counted in its attrs.
    train_trace_max_spans: int = 4096
    # A `train_straggler` event, blaming data_wait, device or host, when
    # one dispatch's wall exceeds this multiple of the rolling median; 0
    # disables.
    straggler_multiple: float = 4.0

    def __post_init__(self):
        if self.on_nan not in ("warn", "halt", "rollback"):
            raise ValueError(
                f"obs.on_nan must be 'warn', 'halt', or 'rollback', "
                f"got {self.on_nan!r}")
        if not (0.0 <= self.train_trace_sample <= 1.0):
            raise ValueError(
                f"obs.train_trace_sample must be in [0, 1], got "
                f"{self.train_trace_sample}")
        if self.on_nan == "rollback":
            raise _later("on_nan='rollback' (resil/)",
                         "on_nan='warn' or 'halt'")


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
    def model_from_cli_and_meta(meta: dict,
                                image_size: Optional[int] = None,
                                scan_blocks: bool = False,
                                filters: Optional[int] = None,
                                residual_blocks: Optional[int] = None
                                ) -> ModelConfig:
        """The inference CLIs' contract (JAX ``config.py:524-556``): the
        architecture recorded beside the checkpoint, with only the flags
        given applied over it, field by field."""
        cfg = Config.model_from_meta(meta)
        if image_size is not None:
            cfg = dataclasses.replace(cfg, image_size=image_size)
        if scan_blocks:
            cfg = dataclasses.replace(cfg, scan_blocks=True)
        if filters is not None:
            cfg = dataclasses.replace(
                cfg,
                generator=dataclasses.replace(cfg.generator, filters=filters),
                discriminator=dataclasses.replace(cfg.discriminator,
                                                  filters=filters))
        if residual_blocks is not None:
            cfg = dataclasses.replace(
                cfg, generator=dataclasses.replace(
                    cfg.generator, num_residual_blocks=residual_blocks))
        return cfg

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
