#!/usr/bin/env python3
"""Which of the port's kernels moves the full-width train step's gradients
away from float64, on one card.

  python3 tools/train_error_by_kernel.py [--rows 0 1 2 3]

For each image row (SyntheticSource's trainA/trainB at 256^2, batch 1),
the combined grad fn at the signal weights that ``chip_smoke.py``'s
``train_options`` phase uses runs: through every kernel, through every
plain version, with each kernel family (K1-K5) alone on its plain version
and with each alone on its kernel, and once in float64 through the plain
versions. For each run it gives every gradient leaf's relative L2
distance from float64, and prints the watched leaves and, over all rows,
the leaves where the kernels sit furthest beyond 1e-3 plus twice the plain
f32 step's distance (``chip_smoke.py``'s rule).

Then the forward norm kernels alone: every K1 and K3 call of one step
(their inputs captured on the kernel run) is run again through the kernel
and its plain version in f32 and against the plain version in float64,
and the output's relative L2 and largest absolute distance from float64
are summarized per call site shape, with the calls' largest |mean| / std
of the input.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("K1", "K2", "K3", "K4", "K5")
WATCHED = (("G", "InstanceNorm_0.bias"), ("G", "Upsample_0.InstanceNorm_0.scale"))
NETS = ("G", "F", "D_X", "D_Y")


def swaps():
    from cyclegan_tpu_torch.ops import norm, upsample
    from cyclegan_tpu_torch.ops.cuda import (
        epilogue_kernel,
        norm_kernel,
        upsample_kernel,
    )

    return {
        "K1": (norm, "instance_norm_cuda", norm_kernel.instance_norm_plain),
        "K2": (norm, "instance_norm_backward_cuda",
               norm_kernel.instance_norm_backward_plain),
        "K3": (norm, "instance_norm_act_pad_cuda",
               epilogue_kernel.instance_norm_act_pad_plain),
        "K4": (norm, "instance_norm_act_pad_backward_cuda",
               epilogue_kernel.instance_norm_act_pad_backward_plain),
        "K5": (upsample, "upsample_norm_relu_pad_cuda",
               upsample_kernel.upsample_norm_relu_pad_plain),
    }


@contextlib.contextmanager
def plain(names):
    """Route the named kernel families to their plain versions."""
    table = swaps()
    saved = {k: getattr(table[k][0], table[k][1]) for k in names}
    for k in names:
        setattr(table[k][0], table[k][1], table[k][2])
    try:
        yield
    finally:
        for k in names:
            setattr(table[k][0], table[k][1], saved[k])


def rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def grad_errors(torch, grad_fn, state, x, y, w, exact, names) -> dict:
    with plain(names):
        grads, _ = grad_fn(state, x, y, w)
    return {(NETS[i], k): rel(grads[i][k], exact[i][k])
            for i in range(4) for k in exact[i]}


def forward_errors(torch, grad_fn, state, x, y, w) -> dict:
    """K1's and K3's outputs against float64 at each call site of one
    step, kernel and plain version on the same captured inputs."""
    from cyclegan_tpu_torch.ops import norm
    from cyclegan_tpu_torch.ops.cuda import epilogue_kernel, norm_kernel

    calls = []
    originals = (norm.instance_norm_cuda, norm.instance_norm_act_pad_cuda)

    def k1(x, scale, bias, eps):
        calls.append(("K1", x.clone(), scale.clone(), bias.clone(), (eps,)))
        return originals[0](x, scale, bias, eps)

    def k3(x, scale, bias, pad, slope, eps):
        calls.append(("K3", x.clone(), scale.clone(), bias.clone(),
                      (pad, slope, eps)))
        return originals[1](x, scale, bias, pad, slope, eps)

    norm.instance_norm_cuda, norm.instance_norm_act_pad_cuda = k1, k3
    try:
        grad_fn(state, x, y, w)
    finally:
        norm.instance_norm_cuda, norm.instance_norm_act_pad_cuda = originals
    sites: dict = {}
    for family, xi, scale, bias, extra in calls:
        if family == "K1":
            kernel, plain_fn = originals[0], norm_kernel.instance_norm_plain
        else:
            kernel = originals[1]
            plain_fn = epilogue_kernel.instance_norm_act_pad_plain
        got = kernel(xi, scale, bias, *extra)[0]
        ref = plain_fn(xi, scale, bias, *extra)[0]
        exact = plain_fn(xi.double(), scale.double(), bias.double(),
                         *extra)[0]
        mean = xi.double().mean(dim=(1, 2))
        std = xi.double().std(dim=(1, 2))
        key = f"{family} {list(xi.shape)} {list(extra[:-1])}"
        site = sites.setdefault(key, dict(
            calls=0, kernel_rel_l2=0.0, plain_rel_l2=0.0, kernel_max_abs=0.0,
            plain_max_abs=0.0, max_mean_over_std=0.0))
        site["calls"] += 1
        site["kernel_rel_l2"] = max(site["kernel_rel_l2"], rel(got, exact))
        site["plain_rel_l2"] = max(site["plain_rel_l2"], rel(ref, exact))
        site["kernel_max_abs"] = max(site["kernel_max_abs"],
                                     (got.double() - exact).abs().max().item())
        site["plain_max_abs"] = max(site["plain_max_abs"],
                                    (ref.double() - exact).abs().max().item())
        site["max_mean_over_std"] = max(site["max_mean_over_std"],
                                        (mean.abs() / std).max().item())
    return sites


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, nargs="+", default=[0, 1, 2, 3])
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from cyclegan_tpu_torch.config import KERNEL_LAYOUT, Config, ModelConfig, ObsConfig
    from cyclegan_tpu_torch.data.augment import normalize_image
    from cyclegan_tpu_torch.data.sources import SyntheticSource
    from cyclegan_tpu_torch.models.generator import use_full_fp32
    from cyclegan_tpu_torch.ops.cuda import build
    from cyclegan_tpu_torch.train.steps import make_grad_fn

    use_full_fp32()
    build.build()
    build.library()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    device = torch.device("cuda")
    config = Config(model=ModelConfig(**KERNEL_LAYOUT),
                    obs=ObsConfig(health=False))
    state = chip_smoke.signal_state(config, chip_smoke.SEED + 10, device)
    grad_fn = make_grad_fn(config, 1)
    source = SyntheticSource(image_size=config.model.image_size)
    w = torch.ones(1, device=device)
    runs = {"kernels": [], "plain": list(FAMILIES)}
    for k in FAMILIES:
        runs[f"{k} plain, the rest kernels"] = [k]
        runs[f"{k} kernel, the rest plain"] = [o for o in FAMILIES if o != k]
    rows, worst = {}, {}
    for row in args.rows:
        x, y = (torch.from_numpy(normalize_image(source.load(split, row))
                                 [None]).to(device)
                for split in ("trainA", "trainB"))
        with plain(FAMILIES):
            for net in state.networks:
                net.double()
            exact, _ = grad_fn(state, x.double(), y.double(), w.double())
            for net in state.networks:
                net.float()
        errs = {label: grad_errors(torch, grad_fn, state, x, y, w, exact,
                                   names) for label, names in runs.items()}
        rows[row] = {label: {" ".join(leaf): e[leaf] for leaf in WATCHED}
                     for label, e in errs.items()}
        for leaf, e in errs["kernels"].items():
            share = e / (1e-3 + 2 * errs["plain"][leaf])
            if share > worst.get(leaf, (0.0,))[0]:
                worst[leaf] = (share, row, e, errs["plain"][leaf])
        print(f"row {row}: " + json.dumps(rows[row]), flush=True)
        del exact
    top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:8]
    worst_leaves = [dict(leaf=" ".join(leaf), share_of_rule=v[0], row=v[1],
                         kernels_vs_f64=v[2], plain_vs_f64=v[3])
                    for leaf, v in top]
    print("leaves furthest beyond 1e-3 + 2 x plain: "
          + json.dumps(worst_leaves), flush=True)
    x, y = (torch.from_numpy(normalize_image(source.load(split, args.rows[0]))
                             [None]).to(device)
            for split in ("trainA", "trainB"))
    forward = forward_errors(torch, grad_fn, state, x, y, w)
    for key, site in forward.items():
        print(f"forward {key}: {json.dumps(site)}", flush=True)
    print(json.dumps(dict(rows=rows, worst_leaves=worst_leaves,
                          forward=forward)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
