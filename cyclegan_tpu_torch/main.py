"""Train CycleGAN with the PyTorch port on one card: the port's counterpart
of the JAX package's ``main.py``.

  python -m cyclegan_tpu_torch.main --output_dir runs --epochs 200 \
      [--data_source folder --data_dir DIR] [--device cpu]

The reference's five flags (``--output_dir``, ``--epochs``,
``--batch_size``, ``--verbose``, ``--clear_output_dir``) and the JAX CLI's
data, architecture, layout and training flags keep their names, choices
and defaults: ``--norm_impl auto --pad_mode reflect --pad_impl pad
--upsample_impl dense --trunk_impl resnet``, ``--remat`` and
``--scan_blocks`` off. At those defaults no hand-written kernel runs (the
norms are torch ops, the upsample cuDNN's); ``--norm_impl pallas
--pad_impl epilogue --upsample_impl zeroskip_fused`` puts every norm,
epilogue and upsample site on one. A combination the JAX package rejects
ends the run with its message. ``--bf16`` trains in bfloat16 compute (f32
parameters, optimizer state, gradients, statistics and losses; bf16 convs
and activations), recorded in the checkpoints' ``meta.json`` with the
whole layout. A value the port does not run yet (``--on_nan rollback``,
``--data_source tfds``) ends the run with the config's "not ported yet"
message.

The train step's options: ``--grad_impl fusedprop``, ``--grad_accum A``
(effective batches of A x ``--batch_size``; the test pass runs at
``--batch_size``), the health metrics (on unless ``--no_health``; the
``--on_nan``/``--health_*`` detectors print their findings, and ``--on_nan
halt`` ends a run with non-finite gradients with exit 3 and no save),
``--domain`` through the domain registry (``--domain_registry``,
``--strict_domain``), and transfer onboarding (``--init_from RUN_DIR
--transfer {full_finetune,encoder_freeze}``, applied only when the run
does not resume). Besides the JAX CLI's flags, ``--device``.

The driver around the loop: ``--steps_per_dispatch K`` runs K steps a
dispatch, one captured CUDA graph on the card (``train/multistep.py``;
not with ``--grad_accum``); ``--trace N`` writes a ``torch.profiler``
trace of dispatches 2..N+1 under ``<output_dir>/traces``; a SIGTERM
finishes the epoch, checkpoints and exits cleanly ("preemption requested:
checkpointed, exiting cleanly"), and with ``--preempt_deadline_s S`` it
ends the epoch at the next dispatch and writes a step-granular emergency
slot within S seconds, from which a restart resumes at the exact batch
(``resil/elastic.py``); ``--expect_partial`` restores the parameters whose
key and shape match and keeps the init for the rest.

Run telemetry (obs/), on unless ``--no_obs``: an append-only JSONL stream
at ``<output_dir>/telemetry.jsonl`` (``--obs_jsonl PATH``; ``none``
disables it) with the JAX CLI's events and fields: the run manifest
first, a ``step`` record a dispatch (``--obs_step_log_every``), an
``epoch_steps`` aggregate a pass, ``step_losses``, the ``epoch`` event
with the ``goodput`` rollup, a ``memory`` watermark
(``--obs_memory_every``), ``health`` and ``health_fault`` events, the
epoch services' ``service_job``s, ``loop_stall`` and ``train_straggler``
detections (``--obs_stall_multiple``, ``--obs_straggler_multiple``),
``stall`` from the watchdog (``--watchdog_deadline``), one ``trace`` an
epoch with ``--train_trace_sample``, and ``end`` with the run's status.
``python tools/obs_report.py <output_dir>/telemetry.jsonl`` folds it.

As the reference: clear or create ``output_dir``, seed, build the data and
the state, resume from the newest verified checkpoint slot, then each
epoch train, test, write the epoch means and the ``elapse``,
``images_per_sec`` and ``perf/*`` scalars to TensorBoard event files
(train in ``output_dir``, test in ``output_dir/test``), print the MAE
summary, and save a checkpoint with cycle plots every ``checkpoint_every``
(10) epochs and at the last. The port runs one process on one device. The
slot's write and the panels' rendering run on an ``EpochServices`` worker
(``utils/services.py``): the loop waits only for the host copies, and
waits for the worker at a preemption, before a health-fault exit and at
exit.
"""

from __future__ import annotations

import argparse
import os
import time
from shutil import rmtree

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train CycleGAN with the PyTorch port on one card.")
    # The reference's flags.
    p.add_argument("--output_dir", default="runs")
    p.add_argument("--epochs", default=200, type=int)
    p.add_argument("--batch_size", default=1, type=int)
    p.add_argument("--verbose", default=1, type=int, choices=[0, 1, 2])
    p.add_argument("--clear_output_dir", action="store_true")
    # The JAX CLI's data flags.
    p.add_argument("--domain", default="horse2zebra",
                   help="domain-pair registry key (domains/registry.py): "
                        "resolves dataset/source/sizes/augment policy; the "
                        "data flags below override the spec field by field")
    p.add_argument("--domain_registry", default=None, metavar="JSON",
                   help="extra domain specs merged over the built-ins: "
                        "{\"domains\": [{\"key\": ..., \"source\": "
                        "\"tfds|folder|synthetic\", ...}]}")
    p.add_argument("--strict_domain", action="store_true",
                   help="refuse, instead of warn, a checkpoint whose domain "
                        "differs from --domain (resume and --init_from)")
    p.add_argument("--init_from", default=None, metavar="RUN_DIR",
                   help="seed the four networks' weights from this run's "
                        "checkpoint ring (the step and Adam start fresh); "
                        "only when this run does not resume")
    p.add_argument("--transfer", default="full_finetune",
                   choices=["full_finetune", "encoder_freeze"],
                   help="under --init_from: 'encoder_freeze' gives both "
                        "generators' encoder zero gradients")
    p.add_argument("--dataset", default="horse2zebra")
    p.add_argument("--data_dir", default=None,
                   help="folder with trainA/trainB/testA/testB image dirs "
                        "(.npy files need no PIL)")
    p.add_argument("--data_source", default="auto",
                   choices=["auto", "tfds", "folder", "synthetic"],
                   help="'auto' is the folder given by --data_dir, else "
                        "synthetic images; 'tfds' is not ported")
    p.add_argument("--synthetic_train_size", default=64, type=int)
    p.add_argument("--synthetic_test_size", default=16, type=int)
    p.add_argument("--fresh_augment", action="store_true",
                   help="augment anew every epoch instead of reusing epoch "
                        "0's augmentations (the reference's behaviour)")
    # Architecture, layout and training flags.
    p.add_argument("--image_size", default=256, type=int)
    p.add_argument("--filters", default=64, type=int)
    p.add_argument("--residual_blocks", default=9, type=int)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (fp32 params/optimizer)")
    p.add_argument("--remat", action="store_true",
                   help="recompute each residual block in the backward "
                        "(torch.utils.checkpoint): less activation memory "
                        "for more compute")
    p.add_argument("--scan_blocks", action="store_true",
                   help="store the residual trunk's parameters stacked on "
                        "a leading axis (ScannedTrunk/ResidualBlock_0), "
                        "the JAX package's scanned-trunk tree; the blocks "
                        "run one by one. Checkpoints use the stacked layout "
                        "(convert with convert.stack_trunk_params)")
    p.add_argument("--pad_mode", default="reflect",
                   choices=["reflect", "zero"],
                   help="conv border handling: 'reflect' is the reference's "
                        "ReflectionPadding2D; 'zero' uses the convs' own "
                        "SAME padding: same parameter tree, other borders")
    p.add_argument("--pad_impl", default="pad",
                   choices=["pad", "fused", "epilogue"],
                   help="how pad_mode=reflect is scheduled: 'pad' makes a "
                        "reflect-padded copy for a VALID conv; 'fused' uses "
                        "the conv's zero padding plus thin border-correction "
                        "convs (ops/padding.py reflect_conv); 'epilogue' adds "
                        "the residual blocks' IN>ReLU>reflect-pad chains and "
                        "the discriminator's IN>LeakyReLU tails as one "
                        "epilogue kernel (K3) each. Checkpoints interchange")
    p.add_argument("--trunk_impl", default="resnet",
                   choices=["resnet", "perturb"],
                   help="generator residual trunk: 'resnet' is the "
                        "reference's 3x3 convs; 'perturb' (Perturbative GAN, "
                        "arXiv:1902.01514) a fixed random mask and a "
                        "learned 1x1 conv for each 3x3 conv: another "
                        "parameter tree (checkpoints record the trunk); "
                        "not with --scan_blocks")
    p.add_argument("--upsample_impl", default="dense",
                   choices=["dense", "zeroskip", "zeroskip_fused"],
                   help="the generator's transposed convs: 'dense' is "
                        "cuDNN's transposed conv; 'zeroskip' its four output "
                        "phases as cuDNN convs over the undilated input; "
                        "'zeroskip_fused' the whole Upsample block (phase "
                        "convs, IN, ReLU, trailing reflect-pad) as the "
                        "upsample kernel (K5); not with --norm_impl xla. "
                        "Checkpoints interchange")
    p.add_argument("--norm_impl", default="auto",
                   choices=["auto", "xla", "pallas"],
                   help="instance norm: 'auto' runs the standalone norms on "
                        "torch ops and each epilogue site on the epilogue "
                        "kernel (K3) where its plan takes the shape; "
                        "'pallas' puts the standalone norms on the "
                        "instance-norm kernel (K1) too; 'xla' runs no norm "
                        "kernel (not with --pad_impl epilogue). With "
                        "--norm_impl pallas --pad_impl epilogue "
                        "--upsample_impl zeroskip_fused every norm, epilogue "
                        "and upsample site is a hand-written kernel")
    p.add_argument("--grad_impl", default="combined",
                   choices=["combined", "fusedprop"])
    p.add_argument("--grad_accum", default=1, type=int)
    p.add_argument("--steps_per_dispatch", default=1, type=int)
    p.add_argument("--seed", default=1234, type=int)
    p.add_argument("--prefetch_batches", default=2, type=int,
                   help="batches staged on the device ahead of the loop by "
                        "a worker thread; 0 stages inline")
    p.add_argument("--ckpt_keep", default=3, type=int,
                   help="checkpoint-ring depth: 1 = one overwritten slot; "
                        "K > 1 keeps the K newest epoch slots")
    p.add_argument("--no_health", action="store_true",
                   help="turn off the health metrics (gradient norms, update "
                        "ratios, non-finite count, D moments) and their "
                        "detectors")
    p.add_argument("--on_nan", default="warn",
                   choices=["warn", "halt", "rollback"],
                   help="non-finite gradients: 'warn' keeps training, 'halt' "
                        "exits 3 with the newest checkpoint intact "
                        "('rollback' is not ported yet)")
    p.add_argument("--health_divergence_multiple", default=4.0, type=float,
                   help="warn when loss_G/total or loss_F/total exceeds "
                        "this multiple of its EMA (0 disables)")
    p.add_argument("--health_collapse_eps", default=0.05, type=float,
                   help="D-collapse detector: distance from the LSGAN "
                        "targets (<= 0 disables)")
    p.add_argument("--health_collapse_patience", default=50, type=int,
                   help="D-collapse detector: rows in a row")
    p.add_argument("--trace", default=0, type=int, metavar="N",
                   help="capture a torch.profiler trace of N train "
                        "dispatches (dispatches 2..N+1; the first is the "
                        "build and warm-up) to <output_dir>/traces; with "
                        "--steps_per_dispatch K the unit is one dispatch "
                        "of K steps")
    p.add_argument("--preempt_deadline_s", default=0.0, type=float,
                   metavar="S",
                   help="preemption grace budget: 0 = a SIGTERM finishes "
                        "the epoch, then checkpoints; S > 0 polls once per "
                        "dispatch and writes a step-granular emergency slot "
                        "within S seconds of the signal, from which a "
                        "resume continues at the exact sample")
    p.add_argument("--expect_partial", action="store_true",
                   help="tolerate checkpoint/model mismatches on resume: "
                        "restore matching leaves, keep fresh init for the "
                        "rest (reference load_checkpoint expect_partial)")
    # Run telemetry (obs/).
    p.add_argument("--obs_jsonl", default=None, metavar="PATH",
                   help="append-only JSONL telemetry stream (manifest, "
                        "per-step timing, epoch throughput/MFU, memory "
                        "watermarks); default <output_dir>/telemetry.jsonl, "
                        "'none' disables. Fold into a report with "
                        "tools/obs_report.py")
    p.add_argument("--no_obs", action="store_true",
                   help="disable the telemetry stream entirely")
    p.add_argument("--watchdog_deadline", default=0.0, type=float,
                   metavar="S",
                   help="stall watchdog: log a warning event (with the "
                        "pending-dispatch depth) if no step completes "
                        "within S seconds — catches a hung device; 0 "
                        "disables")
    p.add_argument("--obs_step_log_every", default=1, type=int, metavar="N",
                   help="emit a per-dispatch `step` event every N "
                        "dispatches (0 = per-epoch aggregates only)")
    p.add_argument("--obs_memory_every", default=1, type=int, metavar="N",
                   help="sample the device's memory watermarks every N "
                        "epochs (0 disables)")
    p.add_argument("--obs_stall_multiple", default=10.0, type=float,
                   metavar="X",
                   help="emit a `loop_stall` telemetry event when one "
                        "dispatch's loop-iteration wall exceeds X times the "
                        "rolling median (32-dispatch window, armed after 5 "
                        "dispatches); 0 disables")
    p.add_argument("--train_trace_sample", default=0.0, type=float,
                   metavar="F",
                   help="training-run span tracing (obs/train_trace.py): "
                        "emit one `trace` event per epoch whose dispatch "
                        "spans tile the epoch wall exactly, derived purely "
                        "from step-clock timestamps (zero extra dispatches "
                        "or syncs). F is the fraction of dispatches "
                        "carrying hop-level child spans (data_wait/submit/"
                        "resolve/host + device overlay); 0 disables "
                        "tracing. Render with tools/trace_timeline.py")
    p.add_argument("--obs_straggler_multiple", default=4.0, type=float,
                   metavar="X",
                   help="straggler observatory: emit a `train_straggler` "
                        "event with blame attribution (data_wait vs device "
                        "vs host) when one dispatch's wall exceeds X times "
                        "the rolling median; 0 disables")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions; for tests)")
    return p


def data_config_from_args(args: argparse.Namespace):
    """The ``DataConfig`` of ``--domain`` resolved through the registry,
    with the explicit data flags over the spec, as the JAX CLI does."""
    import dataclasses

    from cyclegan_tpu_torch.domains import registry as domains

    spec = domains.default_registry(args.domain_registry).resolve(args.domain)
    data = domains.data_config_for(spec)
    overrides = {
        "cache_augmented": not args.fresh_augment and spec.cache_augmented,
        "synthetic_train_size": args.synthetic_train_size,
        "synthetic_test_size": args.synthetic_test_size,
    }
    if args.dataset != "horse2zebra":
        overrides["dataset"] = args.dataset
    if args.data_dir is not None:
        overrides["data_dir"] = args.data_dir
    if args.data_source != "auto":
        overrides["source"] = args.data_source
    elif spec.source == "tfds":
        # As the JAX CLI: 'auto' instead of the spec's hard 'tfds', which
        # here is the folder of --data_dir, else synthetic images.
        overrides["source"] = "auto"
    if args.image_size != spec.crop_size:
        overrides["crop_size"] = args.image_size
        overrides["resize_size"] = int(args.image_size * spec.resize_size
                                       / spec.crop_size)
    return dataclasses.replace(data, **overrides)


def config_from_args(args: argparse.Namespace):
    """The run's ``Config``; a value the port does not run, or a bad
    domain, ends the run with the config's message."""
    from cyclegan_tpu_torch.config import (
        Config,
        DiscriminatorConfig,
        GeneratorConfig,
        ModelConfig,
        ObsConfig,
        TrainConfig,
    )

    if not 0 <= args.seed < 2 ** 32:
        raise SystemExit("--seed must be in [0, 2**32)")
    try:
        return Config(
            model=ModelConfig(
                generator=GeneratorConfig(
                    filters=args.filters,
                    num_residual_blocks=args.residual_blocks),
                discriminator=DiscriminatorConfig(filters=args.filters),
                image_size=args.image_size,
                compute_dtype="bfloat16" if args.bf16 else "float32",
                instance_norm_impl=args.norm_impl,
                pad_mode=args.pad_mode,
                pad_impl=args.pad_impl,
                trunk_impl=args.trunk_impl,
                upsample_impl=args.upsample_impl,
                remat=args.remat,
                scan_blocks=args.scan_blocks),
            data=data_config_from_args(args),
            train=TrainConfig(
                output_dir=args.output_dir, epochs=args.epochs,
                batch_size=args.batch_size, verbose=args.verbose,
                clear_output_dir=args.clear_output_dir, seed=args.seed,
                ckpt_keep=args.ckpt_keep,
                steps_per_dispatch=args.steps_per_dispatch,
                prefetch_batches=args.prefetch_batches,
                grad_accum=args.grad_accum, grad_impl=args.grad_impl,
                init_from=args.init_from, transfer_mode=args.transfer,
                strict_domain=args.strict_domain,
                preempt_deadline_s=args.preempt_deadline_s),
            obs=ObsConfig(
                enabled=not args.no_obs, jsonl_path=args.obs_jsonl,
                watchdog_deadline_s=args.watchdog_deadline,
                step_log_every=args.obs_step_log_every,
                memory_sample_every=args.obs_memory_every,
                stall_multiple=args.obs_stall_multiple,
                train_trace_sample=args.train_trace_sample,
                straggler_multiple=args.obs_straggler_multiple,
                health=not args.no_health, on_nan=args.on_nan,
                divergence_multiple=args.health_divergence_multiple,
                collapse_eps=args.health_collapse_eps,
                collapse_patience=args.health_collapse_patience))
    except ValueError as e:  # DomainError is a ValueError
        raise SystemExit(str(e))


def main(argv=None) -> None:
    from cyclegan_tpu_torch.data.pipeline import build_data
    from cyclegan_tpu_torch.domains import transfer
    from cyclegan_tpu_torch.domains.registry import DomainError
    from cyclegan_tpu_torch.obs.health import HealthFault, make_health_monitor
    from cyclegan_tpu_torch.obs.telemetry import make_telemetry
    from cyclegan_tpu_torch.resil import elastic
    from cyclegan_tpu_torch.train.multistep import make_multi_train_step
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.train.steps import (
        make_accum_train_step,
        make_cycle_step,
        make_test_step,
        make_train_step,
    )
    from cyclegan_tpu_torch.utils.checkpoint import Checkpointer
    from cyclegan_tpu_torch.utils.device import resolve_device
    from cyclegan_tpu_torch.utils.flops import (
        peak_tflops_for_device,
        train_step_flops_per_image,
    )
    from cyclegan_tpu_torch.utils.preemption import PreemptionGuard
    from cyclegan_tpu_torch.utils.profiler import maybe_trace
    from cyclegan_tpu_torch.utils.services import EpochServices
    from cyclegan_tpu_torch.utils.summary import Summary

    args = build_parser().parse_args(argv)
    config = config_from_args(args)
    device = resolve_device(args.device)
    out = config.train.output_dir
    if config.train.clear_output_dir and os.path.exists(out):
        rmtree(out)
    os.makedirs(out, exist_ok=True)
    np.random.seed(config.train.seed)
    torch.manual_seed(config.train.seed)

    # One device, one process: the global batch is the per-device batch,
    # times grad_accum, the effective batch of one update.
    accum = config.train.grad_accum
    global_batch_size = config.train.batch_size * accum
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"Devices: 1 ({device}, {name}), global batch size: "
          f"{global_batch_size}"
          + (f" ({accum}x accumulated)" if accum > 1 else ""))
    flops_per_image = train_step_flops_per_image(config)
    peak_tflops = peak_tflops_for_device(device, config.model.compute_dtype)

    # The test pass has no microbatches: it runs at the micro batch.
    try:
        data = build_data(config, global_batch_size,
                          test_batch_size=config.train.batch_size)
    except ValueError as e:  # a source the port does not read
        raise SystemExit(str(e))
    print(f"Dataset {data.source.name}: {data.n_train} train / {data.n_test} "
          f"test pairs, {data.train_steps} train steps, {data.test_steps} "
          f"test steps per epoch, cache {data.cache_nbytes() / 1e6:.0f}MB, "
          f"preprocessing {data.preprocessing}")

    summary = Summary(out)
    # Run telemetry beside the event files; its manifest is the stream's
    # first event.
    tele = make_telemetry(config.obs, out, device=device)
    tele.manifest(
        config, device=device,
        global_batch_size=global_batch_size,
        flops_per_image=flops_per_image,
        peak_tflops=peak_tflops,
        data={
            "source": data.source.name,
            "n_train": data.n_train,
            "n_test": data.n_test,
            "train_steps": data.train_steps,
            "test_steps": data.test_steps,
        },
    )
    health = make_health_monitor(config.obs, tele)
    state = create_state(config, config.train.seed, device)
    ckpt = Checkpointer(out, keep=config.train.ckpt_keep)
    try:
        resume = elastic.restore_if_exists(ckpt, state, data,
                                           partial=args.expect_partial,
                                           echo=print)
        state, start_epoch, resume_step = (resume.state, resume.start_epoch,
                                           resume.resume_step)
        if resume.resumed:
            transfer.check_domain_compat(
                ckpt.read_meta(), config.data.domain,
                strict=config.train.strict_domain, context="resume",
                telemetry=tele, echo=print)
            print(f"Resumed from {ckpt.slot} at epoch {start_epoch}"
                  + (f", step {resume_step}" if resume_step else ""))
        # Transfer init seeds a fresh run only; a run that already saved
        # resumes from its own ring and keeps its recorded provenance.
        transfer_prov = None
        if config.train.init_from:
            if not resume.resumed:
                state, transfer_prov = transfer.restore_parent(
                    config, state, telemetry=tele, echo=print)
            else:
                transfer_prov = ckpt.read_meta().get("transfer") or {
                    "parent_ckpt": config.train.init_from,
                    "transfer_mode": config.train.transfer_mode,
                    "domain": config.data.domain,
                }
    except (transfer.TransferError, DomainError) as e:
        summary.close()
        tele.close(status="failed")
        raise SystemExit(str(e))

    multi_step = None
    if accum > 1:
        train_step = make_accum_train_step(config, global_batch_size, accum)
    else:
        train_step = make_train_step(config, global_batch_size)
        if config.train.steps_per_dispatch > 1:
            # The single step's own closure: K steps a dispatch make the
            # updates of K dispatches.
            multi_step = make_multi_train_step(
                train_step, config.train.steps_per_dispatch)
    steps = dict(train=train_step, multi=multi_step,
                 test=make_test_step(config, config.train.batch_size),
                 cycle=make_cycle_step())

    # SIGTERM: finish the epoch (with --preempt_deadline_s, the dispatch),
    # checkpoint, exit; the handler flushes the summaries and the
    # telemetry's tail at once.
    guard = PreemptionGuard(on_signal=(summary.flush, tele.flush))
    tracer = maybe_trace(out, args.trace)
    services = EpochServices(telemetry=tele)
    driver = dict(guard=guard, tracer=tracer, services=services, ckpt=ckpt,
                  transfer_prov=transfer_prov, health=health, tele=tele,
                  flops_per_image=flops_per_image, peak_tflops=peak_tflops)
    run_status = "failed"  # until the epoch loop exits cleanly
    try:
        for epoch in range(start_epoch, config.train.epochs):
            print(f"Epoch {epoch + 1:03d}/{config.train.epochs:03d}")
            # A mid-epoch resume position holds for the first epoch only.
            this_start, resume_step = resume_step, 0
            state, preempted = _run_one_epoch(config, data, steps, state,
                                              summary, epoch, driver,
                                              start_step=this_start)
            if preempted:
                services.barrier()
                print("preemption requested: checkpointed, exiting cleanly")
                run_status = "preempted"
                tele.event("preempted", epoch=epoch)
                break
        else:
            run_status = "completed"
    except HealthFault as fault:
        # The non-finite tripwire under --on_nan halt: no save, so the
        # newest slot holds the last weights before the fault; the
        # monitor already wrote the health_fault event and flushed.
        run_status = "health_fault"
        services.barrier()
        print(f"HEALTH FAULT ({fault.kind}): {fault}")
        print(f"halting with last-good checkpoint intact at {ckpt.slot}")
        raise SystemExit(3)
    finally:
        # A queued save lands before the writers close; close() writes the
        # `end` event and stops the watchdog even when an epoch raised.
        tracer.stop()
        services.close()
        if services.errors:
            print(f"epoch-services: {len(services.errors)} background "
                  f"job(s) failed: " + "; ".join(services.errors[:3]))
        guard.uninstall()
        summary.close()
        tele.close(status=run_status)


def _run_one_epoch(config, data, steps, state, summary, epoch, driver,
                   start_step: int = 0):
    """Train, test, the epoch's scalars and summary, and at a checkpoint
    epoch (or on a preemption) the save and the cycle plots; (state,
    preempted). With ``preempt_deadline_s`` > 0 a SIGTERM ends the train
    pass at the next dispatch, and the emergency save replaces the test
    pass and the boundary save."""
    from cyclegan_tpu_torch.resil import elastic
    from cyclegan_tpu_torch.train import loop
    from cyclegan_tpu_torch.utils.checkpoint import save_meta
    from cyclegan_tpu_torch.utils.plotting import plot_cycle

    guard, ckpt, services = driver["guard"], driver["ckpt"], driver["services"]
    health, tele = driver["health"], driver["tele"]
    breaker = (elastic.MidEpochBreaker(guard)
               if config.train.preempt_deadline_s > 0 else None)
    start = time.time()
    state = loop.train_epoch(config, data, steps["train"], state, summary,
                             epoch, health=health,
                             multi_step_fn=steps["multi"],
                             tracer=driver["tracer"], breaker=breaker,
                             start_step=start_step, obs=tele)
    if breaker is not None and guard.requested_locally:
        elastic.emergency_save(ckpt, state, config, data, epoch,
                               start_step + breaker.batches_done, guard,
                               services=services, telemetry=tele, echo=print,
                               transfer=driver["transfer_prov"])
        return state, True
    train_elapse = time.time() - start
    results = loop.test_epoch(config, data, steps["test"], state, summary,
                              epoch, obs=tele)
    # One `health` event an epoch; the flat dict feeds the console line.
    health_rollup = (health.epoch_rollup(epoch) if health is not None
                     else None)
    elapse = time.time() - start
    summary.scalar("elapse", elapse, step=epoch)
    ips = loop.images_per_sec(2 * data.n_train, elapse)
    summary.scalar("images_per_sec", ips, step=epoch)
    # Training alone: the epoch's window also holds the test pass.
    train_ips = loop.images_per_sec(2 * data.n_train, train_elapse)
    summary.scalar("perf/train_images_per_sec", train_ips, step=epoch)
    tflops = train_ips * driver["flops_per_image"] / 1e12
    mfu = tflops / driver["peak_tflops"] if driver["peak_tflops"] else None
    summary.scalar("perf/tflops_per_sec", tflops, step=epoch)
    if mfu is not None:
        summary.scalar("perf/mfu", mfu, step=epoch)
    # The epoch's rollup in the stream (mfu null where the peak is
    # unknown, as on the CPU), the goodput ledger's phases after it, and
    # the memory watermark.
    tele.epoch(
        epoch,
        elapse_s=round(elapse, 4),
        train_elapse_s=round(train_elapse, 4),
        images_per_sec=round(ips, 4),
        train_images_per_sec=round(train_ips, 4),
        tflops_per_sec=round(tflops, 6),
        mfu=round(mfu, 6) if mfu is not None else None,
        test_metrics={key: float(v) for key, v in results.items()},
    )
    if (config.obs.memory_sample_every > 0
            and epoch % config.obs.memory_sample_every == 0):
        tele.memory(epoch)
    loop.print_epoch_summary(results, elapse, health=health_rollup)

    preempted = guard.should_stop()
    if (preempted or epoch == config.train.epochs - 1
            or epoch % config.train.checkpoint_every == 0):
        # The loop waits for the host copies only; the worker writes the
        # slot and reports its bytes and seconds itself.
        t0 = time.time()
        ckpt.save(state, epoch,
                  meta=save_meta(config, driver["transfer_prov"]),
                  services=services, echo=print)
        plot_cycle(data.plot_pairs(), steps["cycle"], state, summary, epoch,
                   services=services)
        print(f"checkpoint of epoch {epoch}: the loop waited "
              f"{time.time() - t0:.2f} s for the host copies and the cycle "
              "plots; the slot is written on epoch services")
    summary.flush()
    return state, preempted


if __name__ == "__main__":
    main()
