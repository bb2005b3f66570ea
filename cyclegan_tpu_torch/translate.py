"""Batch image translation through the port's inference engine.

Maps every image of ``--input`` (a file or a directory) through one
generator (G: A->B, or F: B->A with ``--direction BtoA``) and writes PNGs
to ``--output``; ``--panels`` also writes [input | translated | cycled]
panels, running the cycle generator.

Weights come from ``--weights G.npz [F.npz]``, each the flat flax
parameter dict of one generator (convert.py), or are drawn from
``--seed`` at the init distribution (G from the seed, F from seed + 1).

Usage:
  python -m cyclegan_tpu_torch.translate --weights G.npz F.npz \
      --input images/ --output translated/ [--panels] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


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
    from PIL import Image

    from cyclegan_tpu_torch.config import ModelConfig
    from cyclegan_tpu_torch.convert import (
        config_from_flax,
        generator_state_from_flax,
    )
    from cyclegan_tpu_torch.data.augment import preprocess_test
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from cyclegan_tpu_torch.utils.plotting import to_uint8

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--weights", nargs="+", default=None,
                   help="G (and F) weights: .npz of flat flax parameters")
    p.add_argument("--seed", type=int, default=0,
                   help="draw random weights from this seed (no --weights)")
    p.add_argument("--input", required=True, help="image file or directory")
    p.add_argument("--output", required=True, help="directory for the PNGs")
    p.add_argument("--image_size", type=int, default=256)
    p.add_argument("--batch_size", type=int, default=8,
                   help="largest batch bucket (flush size)")
    p.add_argument("--direction", default="AtoB", choices=["AtoB", "BtoA"])
    p.add_argument("--panels", action="store_true",
                   help="also save [input | translated | cycled] panels")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    g_params, f_params = load_weights(args.weights, args.seed)
    fwd, bwd = ((g_params, f_params) if args.direction == "AtoB"
                else (f_params, g_params))
    if fwd is None or (args.panels and bwd is None):
        raise SystemExit("this direction / --panels needs both generators: "
                         "--weights G.npz F.npz")
    model_cfg = ModelConfig(generator=config_from_flax(fwd),
                            image_size=args.image_size)
    engine = InferenceEngine(
        model_cfg, generator_state_from_flax(fwd),
        generator_state_from_flax(bwd) if args.panels else None,
        serve_cfg=ServeConfig(batch_buckets=tuple(sorted({1, args.batch_size})),
                              sizes=(args.image_size,),
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

    def load(path):
        with Image.open(path) as im:
            return preprocess_test(np.asarray(im.convert("RGB")),
                                   args.image_size)

    t0 = time.perf_counter()
    images = np.stack([load(path) for path in paths])
    fake, cycled = translate_arrays(engine, images)
    os.makedirs(args.output, exist_ok=True)
    for i, stem in enumerate(output_stems(names)):
        Image.fromarray(to_uint8(fake[i])).save(
            os.path.join(args.output, f"{stem}.png"))
        if args.panels:
            panel = np.concatenate([images[i], fake[i], cycled[i]], axis=1)
            Image.fromarray(to_uint8(panel)).save(
                os.path.join(args.output, f"{stem}_panel.png"))
    elapsed = time.perf_counter() - t0
    print(f"translated {len(paths)} images -> {args.output} "
          f"({len(paths) / max(elapsed, 1e-9):.2f} images/sec on "
          f"{engine.device})")


if __name__ == "__main__":
    main()
