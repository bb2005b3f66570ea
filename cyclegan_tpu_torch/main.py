"""Train CycleGAN with the PyTorch port on one card: the port's counterpart
of the JAX package's ``main.py``.

  python -m cyclegan_tpu_torch.main --output_dir runs --epochs 200 \
      [--data_source folder --data_dir DIR] [--device cpu]

The reference's five flags (``--output_dir``, ``--epochs``,
``--batch_size``, ``--verbose``, ``--clear_output_dir``) and the JAX CLI's
data, architecture, layout and training flags keep their names and
defaults, except the layout flags, which default to the one layout the
port runs (``--norm_impl pallas --pad_impl epilogue --upsample_impl
zeroskip_fused``). A value the port does not run yet (``--bf16``,
``--grad_accum 2``, ``--steps_per_dispatch 2``, ``--grad_impl
fusedprop``, another layout or domain, ``--data_source tfds``) ends the
run with the config's "not ported yet" message. The health metrics are
not ported: they are off, as ``--no_health`` sets them.

As the reference: clear or create ``output_dir``, seed, build the data and
the state, resume from the newest verified checkpoint slot, then each
epoch train, test, write the epoch means and the ``elapse``,
``images_per_sec`` and ``perf/*`` scalars to TensorBoard event files
(train in ``output_dir``, test in ``output_dir/test``), print the MAE
summary, and save a checkpoint with cycle plots every ``checkpoint_every``
(10) epochs and at the last. The port runs one process on one device;
epoch-boundary I/O runs inline.
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
                   help="domain-pair key; only horse2zebra is ported")
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
                   help="bfloat16 compute (not ported yet)")
    p.add_argument("--pad_impl", default="epilogue",
                   choices=["pad", "fused", "epilogue"])
    p.add_argument("--norm_impl", default="pallas",
                   choices=["auto", "xla", "pallas"])
    p.add_argument("--upsample_impl", default="zeroskip_fused",
                   choices=["dense", "zeroskip", "zeroskip_fused"])
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
                   help="the health metrics are not ported and are always "
                        "off; accepted for the JAX CLI's command lines")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain "
                        "versions; for tests)")
    return p


def config_from_args(args: argparse.Namespace):
    """The run's ``Config``; a value the port does not run ends the run
    with the config's message."""
    from cyclegan_tpu_torch.config import (
        Config,
        DataConfig,
        DiscriminatorConfig,
        GeneratorConfig,
        ModelConfig,
        TrainConfig,
    )

    data = {"domain": args.domain, "dataset": args.dataset,
            "data_dir": args.data_dir, "source": args.data_source,
            "cache_augmented": not args.fresh_augment,
            "synthetic_train_size": args.synthetic_train_size,
            "synthetic_test_size": args.synthetic_test_size}
    base = DataConfig()
    if args.image_size != base.crop_size:
        data["crop_size"] = args.image_size
        data["resize_size"] = int(args.image_size * base.resize_size
                                  / base.crop_size)
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
                pad_impl=args.pad_impl,
                upsample_impl=args.upsample_impl),
            data=DataConfig(**data),
            train=TrainConfig(
                output_dir=args.output_dir, epochs=args.epochs,
                batch_size=args.batch_size, verbose=args.verbose,
                clear_output_dir=args.clear_output_dir, seed=args.seed,
                ckpt_keep=args.ckpt_keep,
                steps_per_dispatch=args.steps_per_dispatch,
                prefetch_batches=args.prefetch_batches,
                grad_accum=args.grad_accum, grad_impl=args.grad_impl))
    except ValueError as e:
        raise SystemExit(str(e))


def main(argv=None) -> None:
    from cyclegan_tpu_torch.data.pipeline import build_data
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.train.steps import (
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

    # One device, one process: the global batch is the per-device batch.
    global_batch_size = config.train.batch_size
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"Devices: 1 ({device}, {name}), global batch size: "
          f"{global_batch_size}")
    flops_per_image = train_step_flops_per_image(config)
    peak_tflops = peak_tflops_for_device(device)

    data = build_data(config, global_batch_size)
    print(f"Dataset {data.source.name}: {data.n_train} train / {data.n_test} "
          f"test pairs, {data.train_steps} train steps, {data.test_steps} "
          f"test steps per epoch, cache {data.cache_nbytes() / 1e6:.0f}MB, "
          f"preprocessing {data.preprocessing}")

    summary = Summary(out)
    state = create_state(config, config.train.seed, device)
    ckpt = Checkpointer(out, keep=config.train.ckpt_keep)
    state, start_epoch, resumed = ckpt.restore_if_exists(state)
    if resumed:
        print(f"Resumed from {ckpt.slot} at epoch {start_epoch}")

    steps = dict(train=make_train_step(config, global_batch_size),
                 test=make_test_step(config, global_batch_size),
                 cycle=make_cycle_step())
    try:
        for epoch in range(start_epoch, config.train.epochs):
            print(f"Epoch {epoch + 1:03d}/{config.train.epochs:03d}")
            state = _run_one_epoch(config, data, steps, state, summary,
                                   epoch, ckpt, flops_per_image, peak_tflops)
    finally:
        summary.close()


def _run_one_epoch(config, data, steps, state, summary, epoch, ckpt,
                   flops_per_image, peak_tflops):
    """Train, test, the epoch's scalars and summary, and at a checkpoint
    epoch the save and the cycle plots."""
    from cyclegan_tpu_torch.train import loop
    from cyclegan_tpu_torch.utils.plotting import plot_cycle

    start = time.time()
    state = loop.train_epoch(config, data, steps["train"], state, summary,
                             epoch)
    train_elapse = time.time() - start
    results = loop.test_epoch(config, data, steps["test"], state, summary,
                              epoch)
    elapse = time.time() - start
    summary.scalar("elapse", elapse, step=epoch)
    summary.scalar("images_per_sec",
                   loop.images_per_sec(2 * data.n_train, elapse), step=epoch)
    # Training alone: the epoch's window also holds the test pass.
    train_ips = loop.images_per_sec(2 * data.n_train, train_elapse)
    summary.scalar("perf/train_images_per_sec", train_ips, step=epoch)
    tflops = train_ips * flops_per_image / 1e12
    summary.scalar("perf/tflops_per_sec", tflops, step=epoch)
    if peak_tflops:
        summary.scalar("perf/mfu", tflops / peak_tflops, step=epoch)
    loop.print_epoch_summary(results, elapse)

    if (epoch == config.train.epochs - 1
            or epoch % config.train.checkpoint_every == 0):
        t0 = time.time()
        manifest = ckpt.save(state, epoch, meta=config.model_meta())
        print(f"saved checkpoint to {ckpt.slot} "
              f"({manifest['total_bytes']} bytes in "
              f"{time.time() - t0:.2f} s)")
        plot_cycle(data.plot_pairs(), steps["cycle"], state, summary, epoch)
    summary.flush()
    return state


if __name__ == "__main__":
    main()
