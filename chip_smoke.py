#!/usr/bin/env python3
"""Start-up proof of the PyTorch/H100 port (cyclegan_tpu_torch) on one card.

  python3 chip_smoke.py

Phases, each with a deadline and one progress line:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    the CUDA kernels from cyclegan_tpu_torch/csrc (nvcc + ctypes)
  3. kernels  every kernel against its plain PyTorch version on the card at
              each shape of the 256^2 serving path (batch 1 and 4), with
              the kernel's, the plain version's and the nearest single
              PyTorch call's median times
  4. serve    the full-width 256^2 ResNet-9 generator through the port's
              InferenceEngine at batch buckets 1 and 4 (a ragged flush of
              3), launch counts per kernel, outputs checked against the
              same engine with the plain versions, images/s and peak
              memory; then the array-level translate with the cycle pass

Prints the kernels' JSON line, then, only if every phase passed, the last
line {"ok": true, "device": {...}}. Exits non-zero, with no result, when
no CUDA device is present or a phase fails or runs out of time.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback

# Seconds each phase may take; a phase past its deadline ends the run.
DEADLINES = {"device": 60, "build": 420, "kernels": 300, "serve": 360}
SEED = 0
TIMED_LAUNCHES = 30
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Max abs error of a kernel against its plain version on the same inputs.
# Normalised outputs of O(1): the kernel sums in another order (chunked
# Welford statistics; tiled conv FMAs), a few f32 ulps per site.
KERNEL_TOL = 1e-4
# The generator through the kernels against the same engine through the
# plain versions: tanh outputs after 23 kernel sites and 26 convs.
SERVE_TOL = 1e-3


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Run a phase under its deadline: past it, the whole run ends."""
    def expire():
        print(f"[chip_smoke] phase {name} ran past its deadline of "
              f"{DEADLINES[name]} s", flush=True)
        os._exit(3)

    timer = threading.Timer(DEADLINES[name], expire)
    timer.daemon = True
    t0 = time.perf_counter()
    log(f"phase {name}: start")
    timer.start()
    try:
        yield
    finally:
        timer.cancel()
    log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")


def median_ms(torch, fn, iters: int = TIMED_LAUNCHES) -> float:
    """Median device time of one call of ``fn``, by CUDA events around each
    call. A sleep kernel first backs up the stream so the events time the
    device work, not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_cases():
    """Each kernel's shapes on the 256^2 path at batch 1 and 4, with its
    calls per generator forward, its work in bytes and operations, and the
    call that the plain version, the kernel and the library run."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
        instance_norm_act_pad_cuda,
        instance_norm_act_pad_plain,
    )
    from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
        instance_norm_cuda,
        instance_norm_plain,
    )
    from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
        upsample_norm_relu_pad_cuda,
        upsample_norm_relu_pad_plain,
    )
    from cyclegan_tpu_torch.ops.padding import to_nchw

    # The nearest PyTorch calls, timed only here; they return NCHW.
    def lib_norm(x, s, b):
        return F.instance_norm(to_nchw(x), weight=s, bias=b, eps=1e-3)

    def lib_epilogue(x, s, b, pad, slope):
        y = lib_norm(x, s, b)
        y = F.leaky_relu(y, slope) if slope else F.relu(y)
        return F.pad(y, (pad,) * 4, mode="reflect") if pad else y

    def lib_upsample(x, k, s, b, pad):
        h, w = x.shape[1:3]
        # flax's unflipped HWIO kernel as torch's flipped [Cin, Cout, kh, kw].
        wt = k.permute(2, 3, 0, 1).flip(2, 3)
        y = F.conv_transpose2d(to_nchw(x), wt, stride=2)[:, :, :2 * h, :2 * w]
        y = F.relu(F.instance_norm(y, weight=s, bias=b, eps=1e-3))
        return F.pad(y, (pad,) * 4, mode="reflect") if pad else y

    cases = []
    for n in (1, 4):
        # (h, w, c, calls per forward): Conv_0's norm, the downsamples',
        # and the residual blocks' InstanceNorm_1 (9) sharing 64x64x256.
        for h, c, calls in ((256, 64, 1), (128, 128, 1), (64, 256, 10)):
            elems = n * h * h * c
            cases.append(dict(
                kernel="instance_norm", n=n, shape=[n, h, h, c],
                calls=calls if n == 1 else 0,
                bytes=4 * (2 * elems + 2 * c + 2 * n * c), ops=8 * elems,
                inputs=lambda g, n=n, h=h, c=c: g((n, h, h, c), (c,), (c,)),
                kernel_fn=instance_norm_cuda, plain_fn=instance_norm_plain,
                library_fn=lib_norm))
        # The residual blocks' InstanceNorm_0, and the discriminator form.
        for h, c, pad, slope, calls in ((64, 256, 1, 0.0, 9),
                                        (32, 512, 0, 0.2, 0)):
            elems = n * h * h * c
            out = n * (h + 2 * pad) ** 2 * c
            cases.append(dict(
                kernel="epilogue", n=n, shape=[n, h, h, c], pad=pad,
                slope=slope, calls=calls if n == 1 else 0,
                bytes=4 * (elems + out + 2 * c + 2 * n * c), ops=9 * elems,
                inputs=lambda g, n=n, h=h, c=c, pad=pad, slope=slope:
                    g((n, h, h, c), (c,), (c,)) + [pad, slope],
                kernel_fn=instance_norm_act_pad_cuda,
                plain_fn=instance_norm_act_pad_plain,
                library_fn=lib_epilogue))
        for h, cin, cout, pad in ((64, 256, 128, 0), (128, 128, 64, 3)):
            out = n * (2 * h + 2 * pad) ** 2 * cout
            cases.append(dict(
                kernel="upsample", n=n, shape=[n, h, h, cin], cout=cout,
                pad=pad, calls=1 if n == 1 else 0,
                bytes=4 * (n * h * h * cin + 9 * cin * cout + out + 2 * cout
                           + 2 * n * cout),
                ops=2 * 9 * n * h * h * cin * cout + 9 * n * 4 * h * h * cout,
                inputs=lambda g, n=n, h=h, cin=cin, cout=cout, pad=pad:
                    g((n, h, h, cin)) + g((3, 3, cin, cout), weight=True)
                    + g((cout,), (cout,)) + [pad],
                kernel_fn=upsample_norm_relu_pad_cuda,
                plain_fn=upsample_norm_relu_pad_plain,
                library_fn=lib_upsample))
    return cases


KERNELS = {
    "instance_norm": dict(
        source="cyclegan_tpu_torch/csrc/instance_norm.cu",
        replaces="cyclegan_tpu/ops/pallas/norm_kernel.py:94"),
    "epilogue": dict(
        source="cyclegan_tpu_torch/csrc/epilogue.cu",
        replaces="cyclegan_tpu/ops/pallas/epilogue_kernel.py:140"),
    "upsample": dict(
        source="cyclegan_tpu_torch/csrc/upsample.cu",
        replaces="cyclegan_tpu/ops/pallas/upsample_kernel.py:136"),
}
# Launches of each kernel in one generator forward at full width.
LAUNCHES_PER_FORWARD = {"instance_norm": 12, "epilogue": 9, "upsample": 2}
# Generator forwards in the main path's run: one flush at bucket 1, one
# ragged flush at bucket 4.
MAIN_PATH_FORWARDS = 2


def check_kernels(torch, device):
    import numpy as np

    from cyclegan_tpu_torch.ops.padding import to_nhwc

    rng = np.random.default_rng(SEED)

    def gen(*shapes, weight=False):
        """Conv-output-like activations (a mean away from zero), or conv
        weights at 1/sqrt(fan-in) around zero."""
        out = []
        for s in shapes:
            a = rng.standard_normal(s)
            a = a / np.sqrt(np.prod(s[:-1])) if weight else a * 2 + 0.5
            out.append(torch.from_numpy(a.astype(np.float32)).to(device))
        return out

    rows = []
    for case in kernel_cases():
        args = case["inputs"](gen)
        want = case["plain_fn"](*args)
        got = case["kernel_fn"](*args)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        lib_err = (to_nhwc(case["library_fn"](*args)) - want[0]).abs().max().item()
        b_ms, b_by = bound_ms(case["bytes"], case["ops"])
        row = dict(
            kernel=case["kernel"], shape=case["shape"],
            pad=case.get("pad"), slope=case.get("slope"),
            cout=case.get("cout"), calls_per_forward=case["calls"],
            max_abs_err=err, library_max_abs_err=lib_err,
            ms=median_ms(torch, lambda: case["kernel_fn"](*args)),
            plain_ms=median_ms(torch, lambda: case["plain_fn"](*args)),
            library_ms=median_ms(torch, lambda: case["library_fn"](*args)),
            bound_ms=b_ms, bound_by=b_by,
            bytes_ms=bound_ms(case["bytes"], 0)[0],
            ops_ms=bound_ms(0, case["ops"])[0])
        log(f"kernel {row['kernel']} {row['shape']} pad={row['pad']} "
            f"slope={row['slope']} cout={row['cout']}: err {err:.3g} "
            f"(library {lib_err:.3g}), {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        if not err <= KERNEL_TOL:
            raise AssertionError(f"{row['kernel']} {row['shape']}: max abs "
                                 f"error {err} > {KERNEL_TOL}")
        rows.append(row)
    return rows


@contextlib.contextmanager
def plain_versions():
    """Route the op dispatch to the plain versions, for the reference run
    of the same engine on the card (the port itself has no such switch)."""
    from cyclegan_tpu_torch.ops import norm, upsample
    from cyclegan_tpu_torch.ops.cuda import epilogue_kernel, norm_kernel
    from cyclegan_tpu_torch.ops.cuda import upsample_kernel

    saved = (norm.instance_norm_cuda, norm.instance_norm_act_pad_cuda,
             upsample.upsample_norm_relu_pad_cuda)
    norm.instance_norm_cuda = norm_kernel.instance_norm_plain
    norm.instance_norm_act_pad_cuda = epilogue_kernel.instance_norm_act_pad_plain
    upsample.upsample_norm_relu_pad_cuda = upsample_kernel.upsample_norm_relu_pad_plain
    try:
        yield
    finally:
        (norm.instance_norm_cuda, norm.instance_norm_act_pad_cuda,
         upsample.upsample_norm_relu_pad_cuda) = saved


# Kernel names of the port (csrc/*.cu), for the device-time breakdown.
PORT_KERNEL_NAMES = ("stats_partial_kernel", "stats_finalize_kernel",
                     "norm_act_pad_kernel", "phase_conv_kernel")


def device_breakdown(torch, run, flushes: int = 3) -> dict:
    """Device time per flush by kind of kernel, and the device's idle share
    of the window, from torch.profiler (CUPTI) over ``flushes`` flushes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:  # the profiler (CUPTI) refused: no breakdown
        return {"device_time": f"not measured ({e})"}
    try:
        start.record()
        for _ in range(flushes):
            run()
        end.record()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    window_ms = start.elapsed_time(end)
    kinds = {"port kernels": 0.0, "convolutions": 0.0, "other": 0.0}
    other = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:  # kernels and copies only
            continue
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        if any(k in name for k in PORT_KERNEL_NAMES):
            kinds["port kernels"] += ms
        elif any(k in name for k in ("conv", "xmma", "gemm", "cudnn")):
            kinds["convolutions"] += ms
        else:
            kinds["other"] += ms
            other[e.name[:60]] = other.get(e.name[:60], 0.0) + ms
    busy = sum(kinds.values())
    if busy == 0:
        return {"device_time": "not measured (no device events traced)"}
    top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
    return dict(window_ms_per_flush=window_ms / flushes,
                **{f"{k}_ms_per_flush": v / flushes for k, v in kinds.items()},
                idle_share=max(0.0, 1.0 - busy / window_ms),
                top_other={k: v / flushes for k, v in top})


def serve(torch, device, name_and_limit):
    import numpy as np

    from cyclegan_tpu_torch.config import GeneratorConfig, ModelConfig
    from cyclegan_tpu_torch.convert import (
        generator_state_from_flax,
        random_flax_params,
        signal_flax_params,
    )
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from cyclegan_tpu_torch.translate import translate_arrays

    config = GeneratorConfig()
    model_cfg = ModelConfig(generator=config, image_size=256)
    serve_cfg = ServeConfig(batch_buckets=(1, 4), sizes=(256,))
    g_state = generator_state_from_flax(random_flax_params(config, SEED))
    f_state = generator_state_from_flax(random_flax_params(config, SEED + 1))
    engine = InferenceEngine(model_cfg, g_state, serve_cfg=serve_cfg,
                             device=device)
    rng = np.random.default_rng(SEED)
    images = rng.uniform(-1, 1, (4, 256, 256, 3)).astype(np.float32)
    for flush in (images[:1], images[:3]):  # warm-up: cuDNN's first calls
        engine.run(flush)
    torch.cuda.synchronize()

    # The main path: one request at bucket 1, a ragged flush of 3 at 4.
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    (out1,), n1 = engine.run(images[:1])
    (out3,), n3 = engine.run(images[:3])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    log(f"main path launches {launches} over {MAIN_PATH_FORWARDS} forwards")
    want = {k: MAIN_PATH_FORWARDS * v for k, v in LAUNCHES_PER_FORWARD.items()}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if (n1, n3) != (1, 3) or tuple(out1.shape) != (1, 256, 256, 3) \
            or tuple(out3.shape) != (4, 256, 256, 3):
        raise AssertionError(f"n_valid {(n1, n3)}, shapes "
                             f"{tuple(out1.shape)} {tuple(out3.shape)}")
    for out in (out1, out3):
        if not (torch.isfinite(out).all() and out.abs().max() <= 1.0):
            raise AssertionError("output not finite or outside [-1, 1]")

    with plain_versions():
        (ref1,), _ = engine.run(images[:1])
        (ref3,), _ = engine.run(images[:3])
    err_init = max((out1 - ref1).abs().max().item(),
                   (out3[:3] - ref3[:3]).abs().max().item())
    scale_init = ref3[:3].abs().max().item()
    log(f"init-distribution weights: max abs err {err_init:.3g} vs plain "
        f"(outputs up to {scale_init:.3g})")
    if not err_init <= SERVE_TOL * max(scale_init, 1e-3):
        raise AssertionError(f"serve output differs from the plain path by "
                             f"{err_init} (outputs up to {scale_init})")

    signal = InferenceEngine(
        model_cfg, generator_state_from_flax(
            signal_flax_params(config, SEED + 2)),
        serve_cfg=serve_cfg, device=device)
    (sig,), _ = signal.run(images[:3])
    with plain_versions():
        (sig_ref,), _ = signal.run(images[:3])
    err_signal = (sig[:3] - sig_ref[:3]).abs().max().item()
    std_signal = sig_ref[:3].std().item()
    log(f"signal weights: max abs err {err_signal:.3g} vs plain (output "
        f"std {std_signal:.3g})")
    if not (err_signal <= SERVE_TOL and std_signal > 0.05):
        raise AssertionError(f"signal run: err {err_signal}, std {std_signal}")

    timings = {}
    for bucket in (1, 4):
        flush = images[:bucket]
        iters = 10
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.run(flush)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        timings[bucket] = dict(ms_per_flush=elapsed / iters * 1e3,
                               images_per_s=bucket * iters / elapsed)
    log(f"serve 256^2 f32 on {name_and_limit}: bucket 1 "
        f"{timings[1]['ms_per_flush']:.2f} ms/flush "
        f"({timings[1]['images_per_s']:.1f} images/s), bucket 4 "
        f"{timings[4]['ms_per_flush']:.2f} ms/flush "
        f"({timings[4]['images_per_s']:.1f} images/s), peak memory "
        f"{peak_bytes / 2**20:.1f} MiB")

    breakdown = {bucket: device_breakdown(
        torch, lambda flush=images[:bucket]: engine.run(flush))
        for bucket in (1, 4)}
    log(f"device time per flush on {name_and_limit} (profiled): "
        f"{json.dumps(breakdown)}")

    cycle = InferenceEngine(model_cfg, g_state, f_state,
                            serve_cfg=ServeConfig(batch_buckets=(1, 4),
                                                  sizes=(256,),
                                                  with_cycle=True),
                            device=device)
    reset_launches()
    fake, cycled = translate_arrays(cycle, images[:3])
    cycle_launches = dict(LAUNCHES)
    if fake.shape != (3, 256, 256, 3) or cycled.shape != fake.shape \
            or not (np.isfinite(fake).all() and np.isfinite(cycled).all()):
        raise AssertionError("translate with the cycle pass gave "
                             f"{fake.shape} {cycled.shape}")
    if cycle_launches != want:
        raise AssertionError(f"cycle pass launches {cycle_launches}, "
                             f"expected {want}")
    log(f"translate with cycle: {fake.shape[0]} images, launches "
        f"{cycle_launches}")
    return launches, dict(err_init=err_init, err_signal=err_signal,
                          peak_bytes=peak_bytes, timings=timings,
                          breakdown=breakdown)


def kernels_line(rows, launches):
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        path = [r for r in mine if r["calls_per_forward"]]

        def per_forward(key):
            return sum(r[key] * r["calls_per_forward"] for r in path)

        t_bytes, t_ops = per_forward("bytes_ms"), per_forward("ops_ms")
        out.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            launches_per_forward=launches[name] // MAIN_PATH_FORWARDS,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            tolerance=KERNEL_TOL,
            ms=per_forward("ms"), plain_ms=per_forward("plain_ms"),
            bound_ms=per_forward("bound_ms"),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=per_forward("library_ms"),
            per="sum over the kernel's calls in one batch-1 256^2 forward",
            shapes=[{k: v for k, v in r.items() if k != "kernel"}
                    for r in mine]))
    return json.dumps({"kernels": out})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; the port's kernels "
              "run only on the card", file=sys.stderr)
        return 2
    import cyclegan_tpu_torch  # noqa: F401  (fails outside the repo)
    from cyclegan_tpu_torch.models.generator import use_full_fp32
    from cyclegan_tpu_torch.ops.cuda import build

    use_full_fp32()
    device = torch.device("cuda", torch.cuda.current_device())
    with phase("device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        name_and_limit = smi.stdout.strip().splitlines()[0]
        print(name_and_limit, flush=True)
        log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)}, "
            f"{torch.cuda.device_count()} device(s)")
    with phase("build"):
        t0 = time.perf_counter()
        path = build.build()
        build.library()
        log(f"kernels built in {time.perf_counter() - t0:.1f} s: "
            f"{os.path.relpath(path)}")
    with phase("kernels"):
        rows = check_kernels(torch, device)
    with phase("serve"):
        launches, summary = serve(torch, device, name_and_limit)
    log(f"summary on {name_and_limit}: {json.dumps(summary)}")
    print(kernels_line(rows, launches), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
