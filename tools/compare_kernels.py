#!/usr/bin/env python3
"""Median device times of the port's forward norm kernels (K1, K3) and
upsample kernels (K5, K6) at the shapes of the full-width 256^2 serving
forward (batch 1 and 4) and train step, from the package of a given tree,
so that two trees can be compared in turns on one card.

  python3 tools/compare_kernels.py [--root DIR] [--label NAME]

Imports ``cyclegan_tpu_torch`` from DIR (default: this repository; DIR may
be an unpacked ``git archive`` of another commit), builds its kernels in
DIR's git-ignored ``cyclegan_tpu_torch/_build/``, and times each wrapper
as ``chip_smoke.py`` does (the median of 30 calls by CUDA events, warm L2,
a sleep kernel first so that the events time the device). For each case
it also profiles 10 calls with torch.profiler and gives the device time
of each kernel the call launched, by name (for K5 and K6: the GEMM and the
apply pass of their tail apart). The first row times an empty kernel
(``torch.cuda._sleep(0)``) the same way: the floor of one launch in this
harness. Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

SEED = 0
TIMED_CALLS = 30
PROFILED_CALLS = 10


def median_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    pairs = []
    for _ in range(TIMED_CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_us(torch, fn) -> dict:
    """Mean device time of each kernel one call launches, in us, by the
    kernel's short name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"\w+_kernel(<[^>]*>)?", e.name)
            name = m.group(0) if m else e.name[:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us()
    return {k: v / PROFILED_CALLS for k, v in out.items()}


def cases():
    """(kernel, n, h, c, pad, slope, cout): K1 (``instance_norm``) and K3
    (``epilogue``) at the generator's and discriminator's shapes, K5
    (``upsample``) and K6 (``upsample_int8``) at the generator's two
    upsample blocks; batch 1 and the serving bucket 4."""
    out = []
    for n in (1, 4):
        for h, c in ((256, 64), (128, 128), (64, 256)):
            out.append(("instance_norm", n, h, c, 0, None, None))
        out.append(("epilogue", n, 64, 256, 1, 0.0, None))
        out.append(("epilogue", n, 32, 512, 0, 0.2, None))
        if n == 1:
            out.append(("epilogue", 1, 64, 128, 0, 0.2, None))
            out.append(("epilogue", 1, 32, 256, 0, 0.2, None))
        for kernel in ("upsample", "upsample_int8"):
            out.append((kernel, n, 64, 256, 0, None, 128))
            out.append((kernel, n, 128, 128, 3, None, 64))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 2
    import cyclegan_tpu_torch
    from cyclegan_tpu_torch.models.quant import quantize_state_int8
    from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
        instance_norm_act_pad_cuda,
    )
    from cyclegan_tpu_torch.ops.cuda.norm_kernel import instance_norm_cuda
    from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
        upsample_norm_relu_pad_cuda,
        upsample_norm_relu_pad_int8_cuda,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device = torch.device("cuda", torch.cuda.current_device())
    rng = np.random.default_rng(SEED)

    def gen(*shape, weight=False):
        a = rng.standard_normal(shape)
        a = a / np.sqrt(np.prod(shape[:-1])) if weight else a * 2 + 0.5
        return torch.from_numpy(a.astype(np.float32)).to(device)

    # The harness's floor: one empty kernel, timed the same way.
    rows = [dict(kernel="empty", ms=median_ms(
        torch, lambda: torch.cuda._sleep(0)))]
    for kernel, n, h, c, pad, slope, cout in cases():
        x = gen(n, h, h, c)
        if kernel == "instance_norm":
            s, b = gen(c), gen(c)
            fn = lambda: instance_norm_cuda(x, s, b)  # noqa: E731
        elif kernel == "epilogue":
            s, b = gen(c), gen(c)
            fn = lambda: instance_norm_act_pad_cuda(  # noqa: E731
                x, s, b, pad, slope)
        else:
            k, s, b = gen(3, 3, c, cout, weight=True), gen(cout), gen(cout)
            if kernel == "upsample":
                fn = lambda: upsample_norm_relu_pad_cuda(  # noqa: E731
                    x, k, s, b, pad)
            else:
                q = quantize_state_int8({"up.kernel": k})
                qk, qs = q["up.kernel.int8_q"], q["up.kernel.int8_scale"]
                fn = lambda: upsample_norm_relu_pad_int8_cuda(  # noqa: E731
                    x, qk, qs, s, b, pad)
        rows.append(dict(kernel=kernel, shape=[n, h, h, c], pad=pad,
                         slope=slope, cout=cout, ms=median_ms(torch, fn),
                         device_us=device_us(torch, fn)))
        torch.cuda.synchronize()
    print(json.dumps(dict(label=args.label,
                          package=os.path.dirname(cyclegan_tpu_torch.__file__),
                          card=card, rows=rows)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
