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
other values of those flags are not ported yet and raise.
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

# Flag values of the JAX package that later slices of the port bring in.
_LATER = {
    "instance_norm_impl": ("auto", "xla"),
    "pad_impl": ("pad", "fused"),
    "upsample_impl": ("dense", "zeroskip"),
}
_PORTED = {
    "instance_norm_impl": "pallas",
    "pad_impl": "epilogue",
    "upsample_impl": "zeroskip_fused",
}
COMPUTE_DTYPES = ("float32", "bfloat16")
# The JAX package's int8_fused tier forms, which the port's engine selects.
_FUSED_TIER = {
    "instance_norm_impl": ("pallas_fwd", "auto_fwd"),
    "upsample_impl": ("zeroskip_fused_int8",),
}


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
        if self.compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")


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
