"""Batch image translation through the port's inference engine.

Maps every image of ``--input`` (a file or a directory) through one
generator (G: A->B, or F: B->A with ``--direction BtoA``) and writes PNGs
to ``--output``; ``--panels`` also writes [input | translated | cycled]
panels, running the cycle generator.

Weights come from ``--weights G.npz [F.npz]``, each the flat flax
parameter dict of one generator (convert.py); else from the newest
verified slot of the checkpoint ring under ``--output_dir`` (a training
run of ``cyclegan_tpu_torch.main``), with the architecture recorded in its
``meta.json``; else they are drawn from ``--seed`` at the init
distribution (G from the seed, F from seed + 1).

Inputs are ``.npy`` files (uint8 HWC), read with numpy, or raster images,
which need PIL; the PNGs are written with zlib (utils/png.py), so a run on
``.npy`` inputs needs no imaging library.

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


def load_checkpoint(output_dir: str, image_size=None):
    """(G params, F params, ModelConfig) from the newest verified slot of
    the ring under ``output_dir``, or None where it holds no slot."""
    from cyclegan_tpu_torch.config import Config
    from cyclegan_tpu_torch.convert import flax_from_state_dict
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.utils.checkpoint import Checkpointer

    ckpt = Checkpointer(output_dir)
    if not ckpt.exists():
        return None
    model_cfg = Config.model_from_meta(
        ckpt.read_meta(), **({"image_size": image_size} if image_size else {}))
    state, _, _ = ckpt.restore_for_cli(
        create_state(Config(model=model_cfg), 0, device="cpu"))
    return (flax_from_state_dict(state.g.state_dict()),
            flax_from_state_dict(state.f.state_dict()), model_cfg)


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
    from cyclegan_tpu_torch.config import ModelConfig
    from cyclegan_tpu_torch.convert import (
        config_from_flax,
        generator_state_from_flax,
    )
    from cyclegan_tpu_torch.data.augment import preprocess_test
    from cyclegan_tpu_torch.data.sources import load_image_file
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from cyclegan_tpu_torch.utils.plotting import to_uint8
    from cyclegan_tpu_torch.utils.png import write_png

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--weights", nargs="+", default=None,
                   help="G (and F) weights: .npz of flat flax parameters")
    p.add_argument("--output_dir", default=None,
                   help="training output dir whose checkpoints/ ring gives "
                        "G and F (when no --weights)")
    p.add_argument("--seed", type=int, default=0,
                   help="draw random weights from this seed (no --weights, "
                        "no checkpoint)")
    p.add_argument("--input", required=True, help="image file or directory")
    p.add_argument("--output", required=True, help="directory for the PNGs")
    p.add_argument("--image_size", type=int, default=None,
                   help="inference size (default: the checkpoint's, else "
                        "256)")
    p.add_argument("--batch_size", type=int, default=8,
                   help="largest batch bucket (flush size)")
    p.add_argument("--direction", default="AtoB", choices=["AtoB", "BtoA"])
    p.add_argument("--panels", action="store_true",
                   help="also save [input | translated | cycled] panels")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    restored = (load_checkpoint(args.output_dir, args.image_size)
                if args.output_dir and not args.weights else None)
    if restored is not None:
        g_params, f_params, model_cfg = restored
    else:
        if args.output_dir and not args.weights:
            raise SystemExit(f"no checkpoint under {args.output_dir}/checkpoints")
        g_params, f_params = load_weights(args.weights, args.seed)
        model_cfg = None
    fwd, bwd = ((g_params, f_params) if args.direction == "AtoB"
                else (f_params, g_params))
    if fwd is None or (args.panels and bwd is None):
        raise SystemExit("this direction / --panels needs both generators: "
                         "--weights G.npz F.npz")
    if model_cfg is None:
        model_cfg = ModelConfig(generator=config_from_flax(fwd),
                                image_size=args.image_size or 256)
    size = model_cfg.image_size
    engine = InferenceEngine(
        model_cfg, generator_state_from_flax(fwd),
        generator_state_from_flax(bwd) if args.panels else None,
        serve_cfg=ServeConfig(batch_buckets=tuple(sorted({1, args.batch_size})),
                              sizes=(size,),
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
    print(f"translated {len(paths)} images -> {args.output} "
          f"({len(paths) / max(elapsed, 1e-9):.2f} images/sec on "
          f"{engine.device})")


if __name__ == "__main__":
    main()
