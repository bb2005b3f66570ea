"""Batch image translation through the port's inference engine.

Maps every image of ``--input`` (a file or a directory) through one
generator (G: A->B, or F: B->A with ``--direction BtoA``) and writes PNGs
to ``--output``; ``--panels`` also writes [input | translated | cycled]
panels, running the cycle generator.

Weights come from ``--weights G.npz [F.npz]``, each the flat flax
parameter dict of one generator (convert.py); else, with an explicit
``--seed``, they are drawn from it at the init distribution (G from the
seed, F from seed + 1); else from the newest verified slot of the
checkpoint ring under ``--output_dir`` (``runs`` by default; a training
run of ``cyclegan_tpu_torch.main``), with the architecture, the layout
(trunk, scanned storage, pads, norms, upsample) and the compute dtype
recorded in its ``meta.json`` (``--scan_blocks``, ``--filters`` and
``--residual_blocks`` override them, as the JAX translate's do), and the
run ends when the ring holds no slot, as the JAX package's translate does.
Weights from ``--weights`` or ``--seed`` run the JAX default layout, with
the trunk (resnet or perturb, scanned or not) their keys describe. ``--dtype`` overrides the
compute dtype (a bf16 run's ring translates in bf16 by default).

Inputs are ``.npy`` files (uint8 HWC), read with numpy, or raster images,
which need PIL; the PNGs are written with zlib (utils/png.py), so a run on
``.npy`` inputs needs no imaging library.

``--obs_jsonl PATH`` writes a telemetry stream: the run manifest (role
"translate") and ``end`` (``tools/obs_report.py`` folds it).

Usage:
  python -m cyclegan_tpu_torch.translate --output_dir runs \
      --input images/ --output translated/ [--panels] [--device cpu]
  python -m cyclegan_tpu_torch.translate --weights G.npz F.npz ...
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".npy")


def translate_arrays(engine, images: np.ndarray):
    """Run preprocessed images [n, size, size, 3] through ``engine`` in
    flushes of at most its largest batch bucket. Returns (fake, cycled)
    as numpy arrays, ``cycled`` None unless the engine runs the cycle."""
    fakes, cycles = [], []
    for start in range(0, len(images), engine.max_batch):
        outputs, n_valid = engine.run(images[start:start + engine.max_batch])
        fakes.append(outputs[0][:n_valid].cpu().numpy())
        if len(outputs) > 1:
            cycles.append(outputs[1][:n_valid].cpu().numpy())
    return np.concatenate(fakes), (np.concatenate(cycles) if cycles else None)


def load_weights(paths: Optional[list], seed: int):
    """(G params, F params) as flat flax dicts: from one or two .npz files
    (F is None when one is given), or full-width ones drawn from seed and
    seed + 1."""
    from cyclegan_tpu_torch.config import GeneratorConfig
    from cyclegan_tpu_torch.convert import random_flax_params

    if not paths:
        return (random_flax_params(GeneratorConfig(), seed),
                random_flax_params(GeneratorConfig(), seed + 1))
    if len(paths) > 2:
        raise SystemExit("--weights takes one or two files (G, then F)")
    loaded = []
    for path in paths:
        with np.load(path) as f:
            loaded.append({k: f[k] for k in f.files})
    return loaded[0], (loaded[1] if len(loaded) > 1 else None)


def load_checkpoint(output_dir: str, image_size=None, scan_blocks=False,
                    filters=None, residual_blocks=None):
    """(G params, F params, ModelConfig) from the newest verified slot of
    the ring under ``output_dir``, or None where it holds no slot. The
    architecture and layout are the ones its ``meta.json`` records, with
    the flags given applied over them (``Config.model_from_cli_and_meta``,
    JAX ``config.py:524-556``)."""
    from cyclegan_tpu_torch.config import Config
    from cyclegan_tpu_torch.convert import flax_from_state_dict
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.utils.checkpoint import Checkpointer

    if not os.path.isdir(os.path.join(output_dir, "checkpoints")):
        return None  # and make no directory there
    ckpt = Checkpointer(output_dir)
    if not ckpt.exists():
        return None
    model_cfg = Config.model_from_cli_and_meta(
        ckpt.read_meta(), image_size=image_size, scan_blocks=scan_blocks,
        filters=filters, residual_blocks=residual_blocks)
    state, _, _ = ckpt.restore_for_cli(
        create_state(Config(model=model_cfg), 0, device="cpu"))
    return (flax_from_state_dict(state.g.state_dict()),
            flax_from_state_dict(state.f.state_dict()), model_cfg)


def resolve_weights(args):
    """(G params, F params, ModelConfig or None) for the CLIs' flags:
    ``--weights``, else an explicit ``--seed``, else the ring under
    ``--output_dir``, which must hold a slot."""
    if args.weights or args.seed is not None:
        return (*load_weights(args.weights, args.seed), None)
    restored = load_checkpoint(
        args.output_dir, args.image_size, getattr(args, "scan_blocks", False),
        getattr(args, "filters", None), getattr(args, "residual_blocks", None))
    if restored is None:
        raise SystemExit(f"no checkpoint under {args.output_dir}/checkpoints")
    return restored


def output_stems(names: list) -> list:
    """Output stems: the name without its extension unless that collides,
    then made unique, so no translation overwrites another."""
    from collections import Counter

    bare = [os.path.splitext(n)[0] for n in names]
    counts = Counter(bare)
    used, stems = set(), []
    for n, b in zip(names, bare):
        s = b if counts[b] == 1 else n
        cand, i = s, 1
        while cand in used:
            cand = f"{s}__{i}"
            i += 1
        used.add(cand)
        stems.append(cand)
    return stems


def main(argv=None) -> None:
    from cyclegan_tpu_torch.config import Config, ModelConfig
    from cyclegan_tpu_torch.convert import (
        config_from_flax,
        generator_state_from_flax,
        layout_from_flax,
    )
    from cyclegan_tpu_torch.data.augment import preprocess_test
    from cyclegan_tpu_torch.data.sources import load_image_file
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from cyclegan_tpu_torch.utils.plotting import to_uint8
    from cyclegan_tpu_torch.utils.png import write_png

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--weights", nargs="+", default=None,
                   help="G (and F) weights: .npz of flat flax parameters")
    p.add_argument("--output_dir", default="runs",
                   help="training output dir whose checkpoints/ ring gives "
                        "G and F (when neither --weights nor --seed)")
    p.add_argument("--seed", type=int, default=None,
                   help="draw random weights from this seed (no --weights)")
    p.add_argument("--input", required=True, help="image file or directory")
    p.add_argument("--output", required=True, help="directory for the PNGs")
    p.add_argument("--image_size", type=int, default=None,
                   help="inference size (default: the checkpoint's, else "
                        "256)")
    p.add_argument("--scan_blocks", action="store_true",
                   help="the ring was trained with --scan_blocks (stacked "
                        "trunk): only needed for a meta.json that predates "
                        "recording the architecture")
    p.add_argument("--filters", default=None, type=int,
                   help="generator/discriminator base filters: only needed "
                        "for a ring without recorded architecture")
    p.add_argument("--residual_blocks", default=None, type=int,
                   help="generator trunk depth: a ring without recorded "
                        "architecture only")
    p.add_argument("--batch_size", type=int, default=8,
                   help="largest batch bucket (flush size)")
    p.add_argument("--direction", default="AtoB", choices=["AtoB", "BtoA"])
    p.add_argument("--dtype", default=None, choices=["float32", "bfloat16"],
                   help="compute dtype (default: the checkpoint's, else "
                        "float32)")
    p.add_argument("--panels", action="store_true",
                   help="also save [input | translated | cycled] panels")
    p.add_argument("--obs_jsonl", default=None,
                   help="telemetry stream path (fold with "
                        "tools/obs_report.py)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    g_params, f_params, model_cfg = resolve_weights(args)
    fwd, bwd = ((g_params, f_params) if args.direction == "AtoB"
                else (f_params, g_params))
    if fwd is None or (args.panels and bwd is None):
        raise SystemExit("this direction / --panels needs both generators: "
                         "--weights G.npz F.npz")
    if model_cfg is None:
        model_cfg = ModelConfig(generator=config_from_flax(fwd),
                                image_size=args.image_size or 256,
                                **layout_from_flax(fwd))
    size = model_cfg.image_size
    engine = InferenceEngine(
        model_cfg, generator_state_from_flax(fwd),
        generator_state_from_flax(bwd) if args.panels else None,
        serve_cfg=ServeConfig(batch_buckets=tuple(sorted({1, args.batch_size})),
                              sizes=(size,),
                              dtype=args.dtype or model_cfg.compute_dtype,
                              with_cycle=args.panels),
        device=args.device)

    if os.path.isdir(args.input):
        names = sorted(f for f in os.listdir(args.input)
                       if f.lower().endswith(IMAGE_EXTS))
        paths = [os.path.join(args.input, f) for f in names]
    else:
        names, paths = [os.path.basename(args.input)], [args.input]
    if not paths:
        raise SystemExit(f"no images found in {args.input}")

    logger = None
    if args.obs_jsonl:
        from cyclegan_tpu_torch.obs import MetricsLogger, build_manifest

        logger = MetricsLogger(args.obs_jsonl)
        logger.event("manifest", **build_manifest(
            Config(model=model_cfg), query_devices=False, role="translate"))

    t0 = time.perf_counter()
    images = np.stack([preprocess_test(load_image_file(path), size)
                       for path in paths])
    fake, cycled = translate_arrays(engine, images)
    os.makedirs(args.output, exist_ok=True)
    for i, stem in enumerate(output_stems(names)):
        write_png(os.path.join(args.output, f"{stem}.png"), to_uint8(fake[i]))
        if args.panels:
            panel = np.concatenate([images[i], fake[i], cycled[i]], axis=1)
            write_png(os.path.join(args.output, f"{stem}_panel.png"),
                      to_uint8(panel))
    elapsed = time.perf_counter() - t0
    if logger is not None:
        logger.event("end", status="completed")
        logger.close()
    print(f"translated {len(paths)} images -> {args.output} "
          f"({len(paths) / max(elapsed, 1e-9):.2f} images/sec on "
          f"{engine.device}, {engine.serve_cfg.dtype})")


if __name__ == "__main__":
    main()
