#!/usr/bin/env python3
"""Start-up proof of the PyTorch/H100 port (cyclegan_tpu_torch) on one card.

  python3 chip_smoke.py

Phases, each with a deadline and one progress line:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    the CUDA kernels from cyclegan_tpu_torch/csrc (nvcc + ctypes),
              with ptxas's registers, shared memory, stack frame and spills
              for the forward norm kernel (K1, K3) and the apply pass of
              K5/K6's tail, the backward kernels (K2, K4) and the upsample
              kernels (K5, K6), which must neither spill nor use a stack
              frame
  3. kernels  every kernel against its plain PyTorch version on the card at
              each shape of the 256^2 serving path (batch 1 and 4; K6 at
              the int8_fused tier's), and of the 256^2 batch-1 train
              step, with the kernel's, the plain version's and the
              nearest PyTorch call's median times; for the forward norm
              kernels (K1, K3) their launch plan, device launches per call
              (1 at batch 1), mean and inv against float64 for kernel and
              plain, and their ms per serving forward and per train step
              (the discriminator's K3 shapes included); for the backward
              kernels their launch plan, the library call's dx against
              float64 autograd of the same calls on the CPU, and ms per
              train step beside the library's and the bound's; for the
              upsample kernels their plan, device launches per call, both
              bounds (f32 FMAs, split TF32 on the tensor cores), the
              pre-norm output's relative L2 distance from float64 for
              kernel and plain, and K5's ms per train step and per
              serving forward
  4. serve    the full-width 256^2 ResNet-9 generator through the port's
              InferenceEngine at batch buckets 1 and 4 (a ragged flush of
              3), launch counts per kernel, outputs checked against the
              same engine with the plain versions, images/s and peak
              memory; then the array-level translate with the cycle pass
  5. train    the full-width 256^2 CycleGAN (two ResNet-9 generators, two
              PatchGANs, four Adams) at batch 1 on SyntheticSource images:
              one step's losses and gradients on the kernels against the
              plain versions (init-distribution and signal weights), then
              10 steps on the kernels with their losses, ms per step,
              images/s, peak memory, launches per kernel, a profiled
              device-time breakdown and the upsample's composed backward
  6. epochs   the training CLI, python -m cyclegan_tpu_torch.main, in
              subprocesses at full width, 256^2, batch 1, on a folder of
              .npy images (6 train and 2 test a domain, 300^2, so the 286
              resize and the 256 crop both run, through the native
              preprocessing): run A, 3 epochs with a ring of 2; run B, 2
              epochs, then again to 3, which must resume from its epoch-1
              slot; run C, A again through the CLI's main in this process,
              the phase's main path, with each kernel's launches counted
              from 0 and held to the count of its train steps, test steps
              and cycle plots. The slot B resumed from reloads bitwise
              equal to the state it saved (the manifest's digest); B's
              resumed epoch's train and test means against A's, within five
              times the run-to-run gap between A and C; the loop's ms per
              step and images/s beside the train phase's bare step; the
              checkpoint's bytes and save seconds; then python -m
              cyclegan_tpu_torch.translate from A's ring on the test
              images, each PNG decoded with zlib and held against the
              generator's output through the engine (+-1 count)
  7. serve_int8  the same generator through the int8 and int8_fused tiers
              of one engine (weights quantized once at start-up) at
              buckets 1 and 4 (a ragged flush of 3): launches per kernel
              per tier, int8_fused through the kernels against itself
              through the plain versions and against the int8 tier, both
              quantized tiers against the base tier, ms per flush,
              images/s, peak memory and resident weight bytes per tier,
              and the int8 tier's per-flush widening
  8. server   that engine behind the port's PipelinedExecutor and HTTP
              server on 127.0.0.1: .npy uploads on base, int8 and
              int8_fused from a small thread pool, each PNG reply decoded
              with zlib and held against the engine's output, /healthz,
              /stats and /metrics, request latency p50 and p95

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
DEADLINES = {"device": 60, "build": 420, "kernels": 300, "serve": 360,
             "train": 600, "epochs": 300, "serve_int8": 300, "server": 300}
SEED = 0
TIMED_LAUNCHES = 30
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32
# FLOP/s outside the tensor cores and dense TF32 FLOP/s on them.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# Tensor-core passes of the upsample kernels' split-TF32 products: K5
# splits both operands (lo*hi, hi*lo, hi*hi); K6's int8 weights are exact
# in TF32, so lo_b = 0 (lo*q, hi*q).
UPSAMPLE_PASSES = {"upsample": 3, "upsample_int8": 2}
# An upsample kernel's pre-norm output, and a forward norm kernel's mean
# and inv, against float64 of the same function, by relative L2: at most
# this many times the plain f32 version's own distance.
CONV_OUT_F64_FACTOR = 2.0
# Max abs error of a kernel against its plain version on the same inputs.
# Normalised outputs of O(1): the kernel sums in another order (chunked
# Welford statistics; tiled conv FMAs), a few f32 ulps per site.
KERNEL_TOL = 1e-4
# A backward kernel's dscale and dbias against its plain version's: sums of
# up to 65,536 terms per (n, c) added in another order, held to this share
# of the sum of the terms' magnitudes (sum |g * xhat|, sum |g|).
REDUCTION_TOL = 1e-5
# The generator through the kernels against the same engine through the
# plain versions: tanh outputs after 23 kernel sites and 26 convs.
SERVE_TOL = 1e-3
# The int8_fused tier against the int8 tier on the card: the same quantized
# weights, but the upsample's per-channel scale applied after its sum (K6)
# rather than to the weights before it (K5), and sums in another order.
FUSED_VS_INT8_TOL = 1e-4
# Each quantized tier against the base tier, at init-distribution and at
# signal weights: the RMS of the difference over the RMS of the base
# output, a measure of weight-only int8 quality that does not depend on the
# output's scale (init weights give outputs of about 1e-4, signal weights
# of about 1). Its readings on the card are in PERF.md (Findings); a
# quantization that rounds down instead of to nearest reads past it
# (tests/test_torch_port_int8.py).
QUANT_REL_RMS_BUDGET = 0.1
# A PNG reply against to_uint8 of the engine's own output for the same
# image: the server batches requests into other buckets, whose kernels sum
# in another order, so a value may round to the neighbouring count.
PNG_TOL = 1
TIERS = ("base", "int8", "int8_fused")
# One train step through the kernels against the same step through the
# plain versions: the ten loss scalars, relative. Each gradient leaf is held
# against the same step through the plain versions in float64: its
# relative L2 error must stay within TRAIN_GRAD_RTOL plus twice the error
# of the plain versions' own f32 step on that leaf. (At full width, f32
# sums over 65,536 pixels per instance-norm site leave the plain f32 step
# itself up to ~5e-3 from float64 on the norm parameters' leaves, so a
# bare 1e-3 between two f32 paths measures rounding, not the kernels.)
TRAIN_SCALAR_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
TRAIN_STEPS = 10
# The epochs phase's folder: images a domain in each split, and their side.
EPOCHS_TRAIN_IMAGES = 6
EPOCHS_TEST_IMAGES = 2
EPOCHS_IMAGE_SIZE = 300
# The resumed epoch's means against the uninterrupted run's, relative: at
# most this many times the largest relative gap between two uninterrupted
# runs with the same arguments over the same epochs (cuDNN's weight-gradient
# algorithms need not be deterministic, and Adam carries a difference of one
# step into the next), and never below the floor. On the card that gap grew
# from ~1e-6 after one epoch to ~2e-2 after three (PERF.md), so it is
# taken at the resumed epoch, not at an earlier one.
RESUME_GAP_FACTOR = 5.0
RESUME_RTOL_FLOOR = 1e-6
# Processes this script starts, stopped when a phase runs out of time.
CHILDREN: list = []


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


@contextlib.contextmanager
def phase(name: str):
    """Run a phase under its deadline: past it, the whole run ends."""
    def expire():
        print(f"[chip_smoke] phase {name} ran past its deadline of "
              f"{DEADLINES[name]} s", flush=True)
        for child in CHILDREN:
            child.kill()
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
    """Each kernel's shapes on the 256^2 path, with its calls per serving
    forward (batch 1; the batch-4 shapes run at bucket 4) or per batch-1
    train step, its work in bytes and operations, and the calls that the
    kernel, the plain version and the library run."""
    import torch
    import torch.nn.functional as F

    from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
        instance_norm_act_pad_backward_cuda,
        instance_norm_act_pad_backward_plain,
        instance_norm_act_pad_cuda,
        instance_norm_act_pad_plain,
    )
    from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
        instance_norm_backward_cuda,
        instance_norm_backward_plain,
        instance_norm_cuda,
        instance_norm_plain,
    )
    from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
        upsample_norm_relu_pad_cuda,
        upsample_norm_relu_pad_int8_cuda,
        upsample_norm_relu_pad_int8_plain,
        upsample_norm_relu_pad_plain,
    )
    from cyclegan_tpu_torch.ops.padding import to_nchw
    from cyclegan_tpu_torch.models.quant import quantize_state_int8

    # The nearest PyTorch calls, timed only here. Each takes the case's
    # inputs and returns a call whose first (NCHW) output is compared with
    # the plain version's first output.
    def lib_norm(x, s, b):
        return lambda: F.instance_norm(to_nchw(x), weight=s, bias=b, eps=1e-3)

    def lib_epilogue(x, s, b, pad, slope):
        def run():
            y = F.instance_norm(to_nchw(x), weight=s, bias=b, eps=1e-3)
            y = F.leaky_relu(y, slope) if slope else F.relu(y)
            return F.pad(y, (pad,) * 4, mode="reflect") if pad else y
        return run

    def lib_upsample(x, k, s, b, pad):
        h, w = x.shape[1:3]
        # flax's unflipped HWIO kernel as torch's flipped [Cin, Cout, kh, kw].
        wt = k.permute(2, 3, 0, 1).flip(2, 3)

        def run():
            y = F.conv_transpose2d(to_nchw(x), wt, stride=2)[:, :, :2 * h, :2 * w]
            y = F.relu(F.instance_norm(y, weight=s, bias=b, eps=1e-3))
            return F.pad(y, (pad,) * 4, mode="reflect") if pad else y
        return run

    def lib_upsample_int8(x, q, kscale, s, b, pad):
        """lib_upsample over the dequantized kernel, the dequantization
        inside the timed call."""
        def run():
            return lib_upsample(x, q.to(torch.float32) * kscale, s, b, pad)()
        return run

    def int8_weights(gen, cin, cout):
        """An int8 [3, 3, cin, cout] kernel and its [1, 1, 1, cout] scale,
        quantized as the engine does."""
        (k,) = gen((3, 3, cin, cout), weight=True)
        q = quantize_state_int8({"up.kernel": k})
        return [q["up.kernel.int8_q"], q["up.kernel.int8_scale"]]

    def lib_backward(x, s, b, g, pad, slope):
        """The backward of F.instance_norm (> F.leaky_relu > F.pad(reflect)
        when slope or pad is given) through torch.autograd.grad, over a
        graph built once on NCHW-contiguous copies (on a channels_last
        input, F.instance_norm's backward gave a wrong dx on the CPU). The
        call's ``pre`` is the library's own normalised output, whose sign
        sets its activation mask."""
        leaves = [to_nchw(x).contiguous().requires_grad_(),
                  s.detach().requires_grad_(), b.detach().requires_grad_()]
        y = pre = F.instance_norm(leaves[0], weight=leaves[1], bias=leaves[2],
                                  eps=1e-3)
        if slope is not None:
            y = F.leaky_relu(y, slope) if slope else F.relu(y)
        if pad:
            y = F.pad(y, (pad,) * 4, mode="reflect")
        g_nchw = to_nchw(g).contiguous()

        def run():
            return torch.autograd.grad(y, leaves, g_nchw, retain_graph=True)[0]
        run.pre = pre.detach()
        return run

    def backward_inputs(gen, shape, pad, slope):
        """x, the parameters, the forward's statistics and a unit cotangent
        of the (padded) output; the epilogue's arguments when slope is
        given, the instance norm's otherwise."""
        n, h, w, c = shape
        x, s, b = gen(shape, (c,), (c,))
        g = gen((n, h + 2 * pad, w + 2 * pad, c), unit=True)[0]
        mean, inv = instance_norm_plain(x, s, b)[1:]
        if slope is None:
            return [x, s, mean, inv, g]
        return [x, s, b, mean, inv, g, pad, slope]

    def norm_case(n, h, c, calls, step_calls):
        elems = n * h * h * c
        return dict(
            kernel="instance_norm", n=n, shape=[n, h, h, c], calls=calls,
            step_calls=step_calls,
            bytes=4 * (2 * elems + 2 * c + 2 * n * c), ops=8 * elems,
            inputs=lambda g: g((n, h, h, c), (c,), (c,)),
            kernel_fn=instance_norm_cuda, plain_fn=instance_norm_plain,
            library=lib_norm)

    def epilogue_case(n, h, c, pad, slope, calls, step_calls):
        elems = n * h * h * c
        out = n * (h + 2 * pad) ** 2 * c
        return dict(
            kernel="epilogue", n=n, shape=[n, h, h, c], pad=pad, slope=slope,
            calls=calls, step_calls=step_calls,
            bytes=4 * (elems + out + 2 * c + 2 * n * c), ops=9 * elems,
            inputs=lambda g: g((n, h, h, c), (c,), (c,)) + [pad, slope],
            kernel_fn=instance_norm_act_pad_cuda,
            plain_fn=instance_norm_act_pad_plain, library=lib_epilogue)

    cases = []
    for n in (1, 4):
        one = n == 1
        # (h, c, calls per forward, per train step): Conv_0's norm, the
        # downsamples', and the residual blocks' InstanceNorm_1 (9) sharing
        # 64x64x256; a train step runs 6 generator applies.
        for h, c, calls, step_calls in ((256, 64, 1, 6), (128, 128, 1, 6),
                                        (64, 256, 10, 60)):
            cases.append(norm_case(n, h, c, calls * one, step_calls * one))
        # The residual blocks' InstanceNorm_0, and the discriminator form,
        # whose other two shapes run in training only (6 discriminator
        # applies a step).
        for h, c, pad, slope, calls, step_calls in (
                (64, 256, 1, 0.0, 9, 54), (32, 512, 0, 0.2, 0, 6)):
            cases.append(epilogue_case(n, h, c, pad, slope, calls * one,
                                       step_calls * one))
        if one:
            for h, c in ((64, 128), (32, 256)):
                cases.append(epilogue_case(1, h, c, 0, 0.2, 0, 6))
        for h, cin, cout, pad in ((64, 256, 128, 0), (128, 128, 64, 3)):
            out = n * (2 * h + 2 * pad) ** 2 * cout
            gemm_ops = 2 * 9 * n * h * h * cin * cout
            cases.append(dict(
                kernel="upsample", n=n, shape=[n, h, h, cin], cout=cout,
                pad=pad, calls=1 if n == 1 else 0, gemm_ops=gemm_ops,
                bytes=4 * (n * h * h * cin + 9 * cin * cout + out + 2 * cout
                           + 2 * n * cout),
                ops=2 * 9 * n * h * h * cin * cout + 9 * n * 4 * h * h * cout,
                inputs=lambda g, n=n, h=h, cin=cin, cout=cout, pad=pad:
                    g((n, h, h, cin)) + g((3, 3, cin, cout), weight=True)
                    + g((cout,), (cout,)) + [pad],
                kernel_fn=upsample_norm_relu_pad_cuda,
                plain_fn=upsample_norm_relu_pad_plain,
                library=lib_upsample))
            # K6 on the int8_fused tier: the same shapes, int8 weights.
            cases.append(dict(
                kernel="upsample_int8", n=n, shape=[n, h, h, cin], cout=cout,
                pad=pad, calls=1 if n == 1 else 0, gemm_ops=gemm_ops,
                bytes=4 * (n * h * h * cin + out + 3 * cout + 2 * n * cout)
                + 9 * cin * cout,
                ops=2 * 9 * n * h * h * cin * cout + 10 * n * 4 * h * h * cout,
                inputs=lambda g, n=n, h=h, cin=cin, cout=cout, pad=pad:
                    g((n, h, h, cin)) + int8_weights(g, cin, cout)
                    + g((cout,), (cout,)) + [pad],
                kernel_fn=upsample_norm_relu_pad_int8_cuda,
                plain_fn=upsample_norm_relu_pad_int8_plain,
                library=lib_upsample_int8))

    # The backward kernels at the batch-1 train step's shapes, with their
    # calls per step: 6 generator and 6 discriminator applies, each
    # backpropagated (train_launches_per_step).
    for h, c, calls in ((256, 64, 6), (128, 128, 6), (64, 256, 60)):
        elems = h * h * c
        cases.append(dict(
            kernel="instance_norm_backward", n=1, shape=[1, h, h, c],
            calls=calls, backward=True,
            # x and g read, dx written; scale, mean and inv read, the
            # dscale and dbias partials written.
            bytes=4 * (3 * elems + 5 * c), ops=11 * elems,
            inputs=lambda g, h=h, c=c: backward_inputs(g, (1, h, h, c), 0, None),
            kernel_fn=instance_norm_backward_cuda,
            plain_fn=instance_norm_backward_plain,
            library=lambda x, s, m, i, g: lib_backward(
                x, s, torch.zeros_like(s), g, 0, None)))
    # The residual blocks' epilogues, the upsamples' tails (an upsample's
    # backward is an epilogue backward over its transposed conv's output),
    # and the discriminators' three tails.
    for h, c, pad, slope, calls in ((64, 256, 1, 0.0, 54),
                                    (128, 128, 0, 0.0, 6),
                                    (256, 64, 3, 0.0, 6),
                                    (64, 128, 0, 0.2, 6),
                                    (32, 256, 0, 0.2, 6),
                                    (32, 512, 0, 0.2, 6)):
        elems = h * h * c
        padded = (h + 2 * pad) ** 2 * c
        cases.append(dict(
            kernel="epilogue_backward", n=1, shape=[1, h, h, c], pad=pad,
            slope=slope, calls=calls, backward=True,
            bytes=4 * (2 * elems + padded + 6 * c), ops=14 * elems,
            inputs=lambda g, h=h, c=c, pad=pad, slope=slope:
                backward_inputs(g, (1, h, h, c), pad, slope),
            kernel_fn=instance_norm_act_pad_backward_cuda,
            plain_fn=instance_norm_act_pad_backward_plain,
            library=lambda x, s, b, m, i, g, pad, slope: lib_backward(
                x, s, b, g, pad, slope)))

    return cases


KERNELS = {
    "instance_norm": dict(
        source="cyclegan_tpu_torch/csrc/instance_norm.cu",
        replaces="cyclegan_tpu/ops/pallas/norm_kernel.py:94"),
    "instance_norm_backward": dict(
        source="cyclegan_tpu_torch/csrc/norm_backward.cu",
        replaces="cyclegan_tpu/ops/pallas/norm_kernel.py:144"),
    "epilogue": dict(
        source="cyclegan_tpu_torch/csrc/instance_norm.cu",
        replaces="cyclegan_tpu/ops/pallas/epilogue_kernel.py:140"),
    "epilogue_backward": dict(
        source="cyclegan_tpu_torch/csrc/norm_backward.cu",
        replaces="cyclegan_tpu/ops/pallas/epilogue_kernel.py:171"),
    "upsample": dict(
        source="cyclegan_tpu_torch/csrc/upsample.cu",
        replaces="cyclegan_tpu/ops/pallas/upsample_kernel.py:136"),
    "upsample_int8": dict(
        source="cyclegan_tpu_torch/csrc/upsample.cu",
        replaces="cyclegan_tpu/ops/pallas/upsample_kernel.py:220"),
}
BACKWARD_KERNELS = ("instance_norm_backward", "epilogue_backward")
FORWARD_KERNELS = ("instance_norm", "epilogue")
# Launches of each kernel in one generator forward at full width, on the
# base and int8 tiers (K5 at the upsamples) and on the int8_fused tier (K6).
LAUNCHES_PER_FORWARD = {"instance_norm": 12, "instance_norm_backward": 0,
                        "epilogue": 9, "epilogue_backward": 0, "upsample": 2,
                        "upsample_int8": 0}
LAUNCHES_PER_FUSED_FORWARD = dict(LAUNCHES_PER_FORWARD, upsample=0,
                                  upsample_int8=2)
# Generator forwards in the main path's run: one flush at bucket 1, one
# ragged flush at bucket 4.
MAIN_PATH_FORWARDS = 2
# The phase whose main path a forward kernel's launches are read from,
# where it is not the serve phase: K6 runs on the int8_fused tier only.
FORWARD_PATHS = {"upsample_int8": "serve_int8 (int8_fused tier)"}


def backward_errors(case, args, got, want) -> dict:
    """A backward kernel's errors against its plain version: dx in abs,
    dscale and dbias relative to the sums of their terms' magnitudes
    (|g| folded onto the interior bounds the masked cotangent)."""
    from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import reflect_pad_transpose

    x, s = args[0], args[1]
    mean, inv, g = args[-3:] if case["kernel"] == "instance_norm_backward" \
        else args[3:6]
    g_abs = reflect_pad_transpose(g.abs(), case.get("pad") or 0)
    xhat = (x - mean[:, None, None, :]) * inv[:, None, None, :]
    sums = ((g_abs * xhat.abs()).sum(dim=(1, 2)), g_abs.sum(dim=(1, 2)))
    rel = max(((got[i] - want[i]).abs() / sums[i - 1]).max().item()
              for i in (1, 2))
    return dict(dx_max_abs_err=(got[0] - want[0]).abs().max().item(),
                reduction_rel_err=rel)


def mask_flips(case, args, library) -> dict:
    """Elements where the library's activation mask (the sign of its own
    normalised output) and the plain version's (pre rounded op by op)
    disagree, and the largest |scale * inv * folded g| among them: each
    such element moves the library's dx by about that much."""
    from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import reflect_pad_transpose
    from cyclegan_tpu_torch.ops.padding import to_nhwc

    x, s, b, mean, inv, g, pad, _ = args
    coef = s * inv[:, None, None, :]
    pre = (x - mean[:, None, None, :]) * inv[:, None, None, :] * s + b
    flips = (pre > 0) != (to_nhwc(library.pre) > 0)
    moved = (coef * reflect_pad_transpose(g, pad)).abs()[flips]
    return dict(count=int(flips.sum().item()),
                largest=moved.max().item() if moved.numel() else 0.0)


def kernel_ptxas(build, pattern: str, fields, expected: int) -> list:
    """ptxas's report (-Xptxas -v) for each instantiation of one kernel
    template, whose mangled name ``pattern`` matches with one group a
    template argument, each read by its function in ``fields`` (name,
    parse); raises unless there are ``expected`` of them, none with a stack
    frame or spills."""
    import re

    rows = []
    for name, report in build.ptxas_report().items():
        m = re.search(pattern, name)
        if m:
            rows.append(dict({key: parse(m.group(i + 1))
                              for i, (key, parse) in enumerate(fields)},
                             **report))
    if len(rows) != expected:
        raise AssertionError(f"ptxas reported {len(rows)} instantiations of "
                             f"{pattern}, expected {expected}")
    for row in rows:
        if (row.get("stack_bytes", 1) or row.get("spill_store_bytes", 1)
                or row.get("spill_load_bytes", 1)):
            raise AssertionError(f"a kernel uses a stack frame or spills: "
                                 f"{row}")
    return sorted(rows, key=lambda r: [r[key] for key, _ in fields])


# Each kernel template of the library: its mangled name with one group a
# template argument, how to read each, and how many instantiations it has.
PTXAS_KERNELS = {
    "norm_forward_kernel": (r"norm_forward_kernelILi(\d+)ELb([01])E",
                            (("vec", int), ("pad", int)), 4),
    "norm_act_pad_kernel": (r"norm_act_pad_kernelILi(\d+)EE",
                            (("vec", int),), 2),
    "norm_backward_kernel": (r"norm_backward_kernelILb([01])ELb([01])ELi(\d+)E",
                             (("fold", int), ("mask", int), ("vec", int)), 6),
    "upsample_mma_kernel": (r"upsample_mma_kernelI([fa])Lb([01])E",
                            (("weights", lambda t: "f32" if t == "f" else "int8"),
                             ("vec", lambda b: 4 if b == "1" else 1)), 4),
}


def backward_plan_of(case, args) -> dict:
    """The launch plan the backward wrapper takes for these inputs, and how
    many of its clusters the card holds at once."""
    import dataclasses

    from cyclegan_tpu_torch.ops.cuda import build
    from cyclegan_tpu_torch.ops.cuda.norm_kernel import launch_backward_plan

    k2 = case["kernel"] == "instance_norm_backward"
    x, g = args[0], args[-1] if k2 else args[5]
    plan = launch_backward_plan(x, g, x)
    active = build.library().cg_norm_backward_active_clusters(
        int(bool(case.get("pad"))), int(not k2), plan.vec, plan.cluster,
        plan.smem_bytes)
    return dict(dataclasses.asdict(plan), active_clusters=active)


def forward_plan_of(case, args) -> dict:
    """The launch plan the forward wrapper takes for these inputs."""
    import dataclasses

    from cyclegan_tpu_torch.ops.cuda.norm_kernel import launch_forward_plan

    x = args[0]
    n, h, w, c = x.shape
    pad = case.get("pad") or 0
    y = x.new_empty((n, h + 2 * pad, w + 2 * pad, c))
    return dataclasses.asdict(launch_forward_plan(x, y, pad))


def stats_vs_float64(case, args) -> dict:
    """Relative L2 distance of the kernel's and the plain f32 version's
    mean and inv from the plain version's in float64 on the same input."""
    got = case["kernel_fn"](*args)[1:]
    want = case["plain_fn"](*args)[1:]
    exact = case["plain_fn"](*[a.double() if hasattr(a, "double") else a
                               for a in args])[1:]

    def rel(t, e):
        return ((t.double() - e).norm() / e.norm()).item()
    return {name: dict(kernel=rel(g, e), plain=rel(w, e))
            for name, g, w, e in zip(("mean", "inv"), got, want, exact)}


def per_path(rows, names) -> dict:
    """For each forward kernel of ``names``, the sums over one batch-1
    serving forward's calls (``calls``) and one batch-1 train step's
    (``step_calls``) of calls x median time of the kernel, the library,
    the plain version and the bound, in ms; and the same over the
    kernels."""
    keys = ("ms", "library_ms", "plain_ms", "bound_ms")
    out = {}
    for name in names:
        mine = [r for r in rows if r["kernel"] == name]
        out[name] = {
            per: {k: sum(r[k] * r.get(count, 0) for r in mine) for k in keys}
            for per, count in (("per_forward", "calls"),
                               ("per_train_step", "step_calls"))}
    out["all"] = {per: {k: sum(out[n][per][k] for n in names) for k in keys}
                  for per in ("per_forward", "per_train_step")}
    return out


def backward_per_step(rows) -> dict:
    """For K2 and K4, the sum over one batch-1 train step's calls (calls x
    median time) of the kernel's, the library's, the plain version's and
    the bound's times, in ms."""
    out = {}
    for name in BACKWARD_KERNELS:
        path = [r for r in rows if r["kernel"] == name and r["calls"]]
        out[name] = {k: sum(r[k] * r["calls"] for r in path)
                     for k in ("ms", "library_ms", "plain_ms", "bound_ms")}
    out["both"] = {k: sum(out[n][k] for n in BACKWARD_KERNELS)
                   for k in out[BACKWARD_KERNELS[0]]}
    return out


def upsample_bounds(case) -> dict:
    """The two bounds of an upsample case, in ms: f32 FMAs for every
    operation, and the GEMM's products in split TF32 on the tensor cores
    (UPSAMPLE_PASSES passes) with the norm tail's operations in f32; each
    the larger of its operations time and the bytes time."""
    t_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
    tail_ops = case["ops"] - case["gemm_ops"]
    t_f32 = case["ops"] / F32_FLOP_PER_S * 1e3
    t_tf32 = max(case["gemm_ops"] * UPSAMPLE_PASSES[case["kernel"]]
                 / TF32_FLOP_PER_S, tail_ops / F32_FLOP_PER_S) * 1e3
    return dict(f32_fma_ms=max(t_bytes, t_f32),
                split_tf32_ms=max(t_bytes, t_tf32),
                bytes_ms=t_bytes, f32_ops_ms=t_f32, tf32_ops_ms=t_tf32)


def device_launches(torch, fn, tries: int = 6):
    """Kernels and other device operations one call of ``fn`` puts on the
    card, counted by torch.profiler (CUPTI).

    Each profiled window ends with a marker: a fill of an int16 tensor,
    which the port never launches. CUPTI at times hands back a window with
    no device events at all (seen on the card with torch 2.11), which
    would read as zero launches. A window whose marker is missing was
    dropped by the profiler, not skipped by ``fn``, so it is profiled
    again, up to ``tries`` times; if every window lost its marker, the
    count is "not measured". The marker is not counted."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marker = torch.empty(1, dtype=torch.int16, device="cuda")
    fn()
    marker.fill_(0)
    torch.cuda.synchronize()
    for _ in range(tries):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                marker.fill_(1)
                torch.cuda.synchronize()
        except RuntimeError as e:  # the profiler (CUPTI) refused
            return f"not measured ({e})"
        names, marked = [], False
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            if "FillFunctor<short>" in e.name:
                marked = True
                continue
            m = re.search(r"\w+_kernel(<[^>]*>)?", e.name)
            names.append(m.group(0) if m else e.name[:40])
        if marked:
            return dict(count=len(names), names=sorted(set(names)))
    return (f"not measured (the profiler dropped the marker launch in all "
            f"{tries} windows)")


def conv_out_vs_float64(case, args) -> dict:
    """Relative L2 distance of the kernel's and the plain version's
    pre-norm output from the same function in float64."""
    from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
        conv_transpose_zeroskip,
    )

    got = case["kernel_fn"](*args, keep_conv=True)[3]
    want = case["plain_fn"](*args, keep_conv=True)[3]
    x, weights = args[0].double(), args[1].double()
    exact = conv_transpose_zeroskip(x, weights)
    if case["kernel"] == "upsample_int8":
        exact = exact * args[2].double().reshape(-1)

    def rel(t):
        return ((t.double() - exact).norm() / exact.norm()).item()
    return dict(kernel=rel(got), plain=rel(want))


def upsample_per_path(rows) -> dict:
    """K5 and K6 summed over their batch-1 calls (calls x median): ms per
    serving forward (K6: per int8_fused forward) and, for K5, per batch-1
    train step (6 generator applies, each with both upsample blocks)."""
    out = {}
    for name in UPSAMPLE_PASSES:
        path = [r for r in rows if r["kernel"] == name and r["calls"]]
        forward = {k: sum(r[k] * r["calls"] for r in path)
                   for k in ("ms", "library_ms", "plain_ms", "bound_ms")}
        out[name] = dict(per_forward=forward)
        if name == "upsample":
            out[name]["per_train_step"] = {k: 6 * v for k, v in forward.items()}
    return out


def check_kernels(torch, device):
    import numpy as np

    from cyclegan_tpu_torch.ops.cuda.norm_kernel import _sm_count
    from cyclegan_tpu_torch.ops.cuda.upsample_kernel import upsample_plan
    from cyclegan_tpu_torch.ops.padding import to_nhwc

    rng = np.random.default_rng(SEED)

    def gen(*shapes, weight=False, unit=False):
        """Conv-output-like activations (a mean away from zero), conv
        weights at 1/sqrt(fan-in) around zero, or unit cotangents."""
        out = []
        for s in shapes:
            a = rng.standard_normal(s)
            if weight:
                a = a / np.sqrt(np.prod(s[:-1]))
            elif not unit:
                a = a * 2 + 0.5
            out.append(torch.from_numpy(a.astype(np.float32)).to(device))
        return out

    rows = []
    for case in kernel_cases():
        args = case["inputs"](gen)
        want = case["plain_fn"](*args)
        got = case["kernel_fn"](*args)
        torch.cuda.synchronize()
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        library = case["library"](*args)
        lib_err = (to_nhwc(library()) - want[0]).abs().max().item()
        b_ms, b_by = bound_ms(case["bytes"], case["ops"])
        bounds = upsample_bounds(case) if "gemm_ops" in case else None
        if bounds:
            b_ms = min(bounds["f32_fma_ms"], bounds["split_tf32_ms"])
            b_by = ("bytes" if bounds["bytes_ms"] >= min(
                bounds["f32_ops_ms"], bounds["tf32_ops_ms"]) else "operations")
        row = dict(
            kernel=case["kernel"], shape=case["shape"],
            pad=case.get("pad"), slope=case.get("slope"),
            cout=case.get("cout"), calls=case["calls"],
            step_calls=case.get("step_calls"),
            per="train step" if case.get("backward") else "forward",
            max_abs_err=err, library_max_abs_err=lib_err,
            ms=median_ms(torch, lambda: case["kernel_fn"](*args)),
            plain_ms=median_ms(torch, lambda: case["plain_fn"](*args)),
            library_ms=median_ms(torch, library),
            bound_ms=b_ms, bound_by=b_by,
            bytes_ms=bound_ms(case["bytes"], 0)[0],
            ops_ms=bound_ms(0, case["ops"])[0])
        if case.get("backward"):
            # The library's dx and the plain version's, both on the card,
            # against float64 autograd of the same library calls on the CPU.
            exact = to_nhwc(case["library"](*[
                a.cpu().double() if torch.is_tensor(a) else a
                for a in args])()).to(device)
            row.update(backward_errors(case, args, got, want),
                       plan=backward_plan_of(case, args),
                       library_vs_f64=(to_nhwc(library()).double()
                                       - exact).abs().max().item(),
                       plain_vs_f64=(want[0].double()
                                     - exact).abs().max().item())
            if case["kernel"] == "epilogue_backward":
                row["library_mask_flips"] = mask_flips(case, args, library)
            ok = (row["dx_max_abs_err"] <= KERNEL_TOL
                  and row["reduction_rel_err"] <= REDUCTION_TOL)
            shown = (f"dx err {row['dx_max_abs_err']:.3g}, dscale/dbias "
                     f"{row['reduction_rel_err']:.3g} of the sums; dx vs "
                     f"float64 of the library calls: library "
                     f"{row['library_vs_f64']:.3g}, plain "
                     f"{row['plain_vs_f64']:.3g}; library mask flips "
                     f"{row.get('library_mask_flips')}; plan {row['plan']}")
        elif case["kernel"] in FORWARD_KERNELS:
            row.update(plan=forward_plan_of(case, args),
                       launches_per_call=device_launches(
                           torch, lambda: case["kernel_fn"](*args)),
                       stats_rel_l2_vs_f64=stats_vs_float64(case, args))
            rel = row["stats_rel_l2_vs_f64"]
            launches = row["launches_per_call"]
            ok = (err <= KERNEL_TOL
                  and all(v["kernel"] <= CONV_OUT_F64_FACTOR * v["plain"]
                          for v in rel.values())
                  and (case["n"] > 1 or not isinstance(launches, dict)
                       or launches["count"] == 1))
            shown = (f"err {err:.3g}; mean and inv rel L2 vs float64: "
                     f"kernel {rel['mean']['kernel']:.3g} and "
                     f"{rel['inv']['kernel']:.3g}, plain "
                     f"{rel['mean']['plain']:.3g} and "
                     f"{rel['inv']['plain']:.3g}; device launches per call "
                     f"{launches}; plan {row['plan']}")
        elif bounds:
            n, h, w, cin = case["shape"]
            plan = upsample_plan(n, h, w, cin, case["cout"],
                                 _sm_count(device.index),
                                 case["kernel"] == "upsample_int8")
            route = ("split TF32" if bounds["split_tf32_ms"]
                     <= bounds["f32_fma_ms"] else "f32 FMA")
            row.update(bounds=bounds, bound_route=route,
                       plan=dict(patch=[plan.patch_rows, plan.patch_cols],
                                 tile=plan.tile, depth=plan.depth,
                                 stages=plan.stages, grid=list(plan.grid),
                                 smem_bytes=plan.smem_bytes,
                                 waves=plan.waves),
                       launches_per_call=device_launches(
                           torch, lambda: case["kernel_fn"](*args)),
                       conv_out_rel_l2_vs_f64=conv_out_vs_float64(case, args))
            rel = row["conv_out_rel_l2_vs_f64"]
            ok = (err <= KERNEL_TOL and rel["kernel"]
                  <= CONV_OUT_F64_FACTOR * rel["plain"])
            shown = (f"err {err:.3g}; bounds f32 FMA "
                     f"{bounds['f32_fma_ms']:.4f} ms, split TF32 "
                     f"({UPSAMPLE_PASSES[case['kernel']]} passes) "
                     f"{bounds['split_tf32_ms']:.4f} ms; conv_out rel L2 vs "
                     f"float64: kernel {rel['kernel']:.3g}, plain "
                     f"{rel['plain']:.3g}; device launches per call "
                     f"{row['launches_per_call']}; plan {row['plan']}")
        else:
            ok = err <= KERNEL_TOL
            shown = f"err {err:.3g}"
        log(f"kernel {row['kernel']} {row['shape']} pad={row['pad']} "
            f"slope={row['slope']} cout={row['cout']}: {shown} "
            f"(library {lib_err:.3g}), {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        if not ok:
            raise AssertionError(f"{row['kernel']} {row['shape']}: the kernel "
                                 f"disagrees with its plain version: {shown}")
        rows.append(row)
    return rows


@contextlib.contextmanager
def plain_versions():
    """Route the op dispatch to the plain versions, for the reference run
    of the same engine or train step on the card (the port itself has no
    such switch)."""
    from cyclegan_tpu_torch.ops import norm, upsample
    from cyclegan_tpu_torch.ops.cuda import epilogue_kernel, norm_kernel
    from cyclegan_tpu_torch.ops.cuda import upsample_kernel

    swaps = [
        (norm, "instance_norm_cuda", norm_kernel.instance_norm_plain),
        (norm, "instance_norm_backward_cuda",
         norm_kernel.instance_norm_backward_plain),
        (norm, "instance_norm_act_pad_cuda",
         epilogue_kernel.instance_norm_act_pad_plain),
        (norm, "instance_norm_act_pad_backward_cuda",
         epilogue_kernel.instance_norm_act_pad_backward_plain),
        (upsample, "upsample_norm_relu_pad_cuda",
         upsample_kernel.upsample_norm_relu_pad_plain),
        (upsample, "upsample_norm_relu_pad_int8_cuda",
         upsample_kernel.upsample_norm_relu_pad_int8_plain),
    ]
    saved = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), fn in zip(swaps, saved):
            setattr(module, name, fn)


# Kernel names of the port (csrc/*.cu), for the device-time breakdown.
PORT_KERNEL_NAMES = ("norm_forward_kernel", "norm_act_pad_kernel",
                     "upsample_mma_kernel", "norm_backward_kernel")


def device_breakdown(torch, run, runs: int = 3) -> dict:
    """Device time per run by kind of kernel, and the device's idle share
    of the window, from torch.profiler (CUPTI) over ``runs`` calls of
    ``run`` (a serving flush or a train step)."""
    import re

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
        for _ in range(runs):
            run()
        end.record()
        torch.cuda.synchronize()
    finally:
        prof.stop()
    window_ms = start.elapsed_time(end)
    kinds = {"port kernels": 0.0, "convolutions": 0.0, "other": 0.0}
    other, port = {}, {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:  # kernels and copies only
            continue
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        if any(k in name for k in PORT_KERNEL_NAMES):
            kinds["port kernels"] += ms
            # "void cg::(anonymous namespace)::norm_backward_kernel<false,
            # false, 4>(...)" -> "norm_backward_kernel<false, false, 4>"
            short = re.search(r"\w+_kernel(<[^>]*>)?", e.name).group(0)
            port[short] = port.get(short, 0.0) + ms
        # cuDNN's kernels; the port has no linear layers, so its FFT and
        # GEMV kernels come from cuDNN's FFT convolution algorithms too.
        elif any(k in name for k in ("conv", "xmma", "gemm", "cudnn",
                                      "cutlass", "wgrad", "dgrad", "fft",
                                      "gemv")):
            kinds["convolutions"] += ms
        else:
            kinds["other"] += ms
            other[e.name[:60]] = other.get(e.name[:60], 0.0) + ms
    busy = sum(kinds.values())
    if busy == 0:
        return {"device_time": "not measured (no device events traced)"}
    top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
    return dict(window_ms_per_run=window_ms / runs,
                **{f"{k}_ms_per_run": v / runs for k, v in kinds.items()},
                idle_share=max(0.0, 1.0 - busy / window_ms),
                port_kernels_ms_per_run={k: v / runs for k, v in port.items()},
                top_other={k: v / runs for k, v in top})


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


def quantized_tiers_vs(torch, engine, images, label):
    """Outputs of the three tiers at bucket 1 and a ragged flush of 3, and
    the int8_fused tier again through the plain versions; the errors the
    serve_int8 phase holds to its tolerances."""
    def run(tier):
        (o1,), _ = engine.run(images[:1], tier=tier)
        (o3,), _ = engine.run(images[:3], tier=tier)
        return torch.cat([o1, o3[:3]])

    outs = {tier: run(tier) for tier in TIERS}
    with plain_versions():
        plain_fused = run("int8_fused")

    def err(a, b):
        return (a - b).abs().max().item()

    def rel_rms(a, b):
        return ((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item()

    row = dict(fused_vs_plain=err(outs["int8_fused"], plain_fused),
               fused_vs_int8=err(outs["int8_fused"], outs["int8"]),
               int8_vs_base=err(outs["int8"], outs["base"]),
               fused_vs_base=err(outs["int8_fused"], outs["base"]),
               int8_vs_base_rel_rms=rel_rms(outs["int8"], outs["base"]),
               fused_vs_base_rel_rms=rel_rms(outs["int8_fused"], outs["base"]),
               output_abs_max=outs["base"].abs().max().item(),
               output_std=outs["base"].std().item())
    log(f"{label} weights: int8_fused kernels vs plain {row['fused_vs_plain']:.3g}, "
        f"int8_fused vs int8 {row['fused_vs_int8']:.3g}, int8 vs base "
        f"{row['int8_vs_base']:.3g}, int8_fused vs base "
        f"{row['fused_vs_base']:.3g} (relative RMS "
        f"{row['int8_vs_base_rel_rms']:.4g} / "
        f"{row['fused_vs_base_rel_rms']:.4g}; base outputs up to "
        f"{row['output_abs_max']:.3g}, std {row['output_std']:.3g})")
    return row


def serve_int8(torch, device, name_and_limit):
    import numpy as np

    from cyclegan_tpu_torch.config import GeneratorConfig, ModelConfig
    from cyclegan_tpu_torch.convert import (
        generator_state_from_flax,
        random_flax_params,
        signal_flax_params,
    )
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig

    config, size = GeneratorConfig(), 256
    model_cfg = ModelConfig(generator=config, image_size=size)
    serve_cfg = ServeConfig(batch_buckets=(1, 4), sizes=(size,),
                            int8_tier=True, infer_tier=True)
    engine = InferenceEngine(
        model_cfg, generator_state_from_flax(random_flax_params(config, SEED)),
        serve_cfg=serve_cfg, device=device)
    if engine.tiers != TIERS:
        raise AssertionError(f"tiers {engine.tiers}, expected {TIERS}")
    # The int8_fused tier's flush state holds the upsample kernels as int8
    # with their f32 scales, and nothing else of them.
    upsample = {k: v.dtype for k, v in engine.tier_state("int8_fused").items()
                if ".ConvTranspose_0." in k}
    if not upsample or upsample != {
            k: torch.int8 if k.endswith(".int8_q") else torch.float32
            for k in upsample if k.endswith((".int8_q", ".int8_scale"))}:
        raise AssertionError(f"int8_fused upsample leaves {upsample}")
    resident = {tier: engine.resident_weight_bytes(tier) for tier in TIERS}
    log(f"weights resident per tier (bytes): {resident}")
    rng = np.random.default_rng(SEED)
    images = rng.uniform(-1, 1, (4, size, size, 3)).astype(np.float32)
    for tier in TIERS:  # warm-up: cuDNN's first calls
        for flush in (images[:1], images[:3]):
            engine.run(flush, tier=tier)
    torch.cuda.synchronize()

    # The main paths, one per quantized tier: bucket 1, then a ragged
    # flush of 3 at bucket 4, the counts set to 0 just before.
    launches, peak_bytes = {}, {}
    want = {"int8": {k: MAIN_PATH_FORWARDS * v
                     for k, v in LAUNCHES_PER_FORWARD.items()},
            "int8_fused": {k: MAIN_PATH_FORWARDS * v
                           for k, v in LAUNCHES_PER_FUSED_FORWARD.items()}}
    for tier in ("int8_fused", "int8"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        (out1,), n1 = engine.run(images[:1], tier=tier)
        (out3,), n3 = engine.run(images[:3], tier=tier)
        torch.cuda.synchronize()
        launches[tier] = dict(LAUNCHES)
        peak_bytes[tier] = torch.cuda.max_memory_allocated()
        log(f"{tier} main path launches {launches[tier]} over "
            f"{MAIN_PATH_FORWARDS} forwards")
        if launches[tier] != want[tier]:
            raise AssertionError(f"{tier}: launches {launches[tier]}, "
                                 f"expected {want[tier]}")
        if (n1, n3) != (1, 3) or tuple(out1.shape) != (1, size, size, 3) \
                or tuple(out3.shape) != (4, size, size, 3):
            raise AssertionError(f"{tier}: n_valid {(n1, n3)}, shapes "
                                 f"{tuple(out1.shape)} {tuple(out3.shape)}")
        for out in (out1, out3):
            if not (torch.isfinite(out).all() and out.abs().max() <= 1.0):
                raise AssertionError(f"{tier}: output not finite or outside "
                                     "[-1, 1]")
    torch.cuda.reset_peak_memory_stats()
    engine.run(images[:1])
    engine.run(images[:3])
    torch.cuda.synchronize()
    peak_bytes["base"] = torch.cuda.max_memory_allocated()

    checks = {"init": quantized_tiers_vs(torch, engine, images, "init")}
    signal = InferenceEngine(
        model_cfg, generator_state_from_flax(
            signal_flax_params(config, SEED + 2)),
        serve_cfg=serve_cfg, device=device)
    checks["signal"] = quantized_tiers_vs(torch, signal, images, "signal")
    del signal
    for label, row in checks.items():
        if not (row["fused_vs_plain"] <= SERVE_TOL
                and row["fused_vs_int8"] <= FUSED_VS_INT8_TOL):
            raise AssertionError(f"{label} weights: int8_fused tier {row}")
        if not (row["int8_vs_base_rel_rms"] <= QUANT_REL_RMS_BUDGET
                and row["fused_vs_base_rel_rms"] <= QUANT_REL_RMS_BUDGET):
            raise AssertionError(
                f"{label} weights: quantized tiers {row} past the relative "
                f"RMS budget {QUANT_REL_RMS_BUDGET}")

    timings = {}
    for tier in TIERS:
        row = {}
        for bucket in (1, 4):
            flush = images[:bucket]
            iters = 10
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dispatch = []
            for _ in range(iters):
                t1 = time.perf_counter()
                engine.run(flush, tier=tier)
                dispatch.append(time.perf_counter() - t1)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            row[bucket] = dict(ms_per_flush=elapsed / iters * 1e3,
                               images_per_s=bucket * iters / elapsed,
                               dispatch_ms=statistics.median(dispatch) * 1e3)
        timings[tier] = row
        log(f"serve {tier} {size}^2 on {name_and_limit}: bucket 1 "
            f"{row[1]['ms_per_flush']:.2f} ms/flush (host dispatch "
            f"{row[1]['dispatch_ms']:.2f} ms), bucket 4 "
            f"{row[4]['images_per_s']:.1f} images/s, peak memory "
            f"{peak_bytes[tier] / 2**20:.1f} MiB, weights resident "
            f"{resident[tier] / 2**20:.2f} MiB")
    breakdown = {f"{tier}/{bucket}": device_breakdown(
        torch, lambda tier=tier, flush=images[:bucket]: engine.run(
            flush, tier=tier))
        for tier in ("int8", "int8_fused") for bucket in (1, 4)}
    log(f"device time per flush on {name_and_limit} (profiled): "
        f"{json.dumps(breakdown)}")
    # The int8 tier widens its ~24 quantized kernels on every flush.
    iters = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        engine.tier_state("int8")
    t_host = (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    t_all = (time.perf_counter() - t0) / iters
    widen = dict(leaves=sum(v.dim() > 1 for v in engine.tier_state("int8").values()),
                 host_ms=t_host * 1e3, synchronized_ms=t_all * 1e3,
                 device_ms=median_ms(torch, lambda: engine.tier_state("int8")))
    log(f"int8 tier per-flush widening on {name_and_limit}: "
        f"{json.dumps(widen)}")
    return engine, launches, dict(checks=checks, timings=timings,
                                  peak_bytes=peak_bytes,
                                  resident_weight_bytes=resident,
                                  widen=widen, breakdown=breakdown)


def decode_png(body: bytes):
    """An 8-bit RGB PNG whose rows all use filter 0 (what the port's server
    writes) as a uint8 [H, W, 3] array, with zlib alone."""
    import struct
    import zlib

    import numpy as np

    if body[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(body):
        length, kind = struct.unpack(">I4s", body[pos:pos + 8])
        data = body[pos + 8:pos + 8 + length]
        if zlib.crc32(kind + data) != struct.unpack(
                ">I", body[pos + 8 + length:pos + 12 + length])[0]:
            raise AssertionError(f"PNG chunk {kind} fails its CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
        pos += 12 + length
    w, h, depth, color = header[:4]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if depth != 8 or color != 2 or rows[:, 0].any():
        raise AssertionError(f"PNG header {header} or row filters unexpected")
    return rows[:, 1:].reshape(h, w, 3)


def server(torch, engine, name_and_limit):
    import io
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from cyclegan_tpu_torch.serve.engine import preprocess_request
    from cyclegan_tpu_torch.serve.executor import PipelinedExecutor
    from cyclegan_tpu_torch.serve.server import (
        _decode_upload,
        _encode_png,
        make_server,
    )
    from cyclegan_tpu_torch.utils.plotting import to_uint8

    size = engine.sizes[-1]
    executor = PipelinedExecutor(engine, max_wait_ms=5.0)
    httpd, _ = make_server(executor, "127.0.0.1", 0)
    host, port = httpd.server_address[:2]
    base = f"http://{host}:{port}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        rng = np.random.default_rng(SEED + 3)
        # 8 uploads a tier, uint8 as a decoder would give them; one of
        # each tier's is not size^2 and is resized by the executor.
        plan = [(tier, rng.integers(0, 256, (size, size, 3) if i else
                                    (size - 16, size + 44, 3)).astype(np.uint8))
                for tier in TIERS for i in range(8)]

        def post(item):
            tier, img = item
            buf = io.BytesIO()
            np.save(buf, img)
            req = urllib.request.Request(f"{base}/translate?tier={tier}",
                                         data=buf.getvalue(), method="POST")
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=120) as r:
                body, status = r.read(), r.status
                ctype = r.headers["Content-Type"]
            return status, ctype, body, time.perf_counter() - t0

        # Unloaded: one request at a time, 3 a tier after one to warm up.
        alone = {tier: statistics.median(
            [post(item)[3] for item in [(tier, plan[1][1])] * 4][1:]) * 1e3
            for tier in TIERS}
        with ThreadPoolExecutor(max_workers=4) as pool:
            replies = list(pool.map(post, plan))
        worst = 0
        for (tier, img), (status, ctype, body, _) in zip(plan, replies):
            if status != 200 or ctype != "image/png":
                raise AssertionError(f"{tier}: reply {status} {ctype}")
            x = preprocess_request(img, size)[None]
            (want,), _ = engine.run(x, tier=tier)
            want = to_uint8(want[0].cpu().numpy())
            got = decode_png(body)
            worst = max(worst, int(np.abs(got.astype(int) - want).max()))
        if worst > PNG_TOL:
            raise AssertionError(f"a PNG reply differs from the engine's "
                                 f"output by {worst} counts")
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            if r.status != 200:
                raise AssertionError(f"/healthz {r.status}")
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        total = len(plan) + 4 * len(TIERS)
        if (stats["n_requests"] != total or stats["n_errors"]
                or stats["tiers"] != list(TIERS)
                or stats["n_images_done"] != total):
            raise AssertionError(f"/stats {stats}")
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        if f"cyclegan_serve_requests_total {total}" not in metrics:
            raise AssertionError(f"/metrics lacks the request count:\n{metrics}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        summary = executor.close()
    # The host stages of one 256^2 request, alone on the host's clock.
    buf = io.BytesIO()
    np.save(buf, plan[1][1])
    upload = buf.getvalue()
    fake = np.tanh(rng.standard_normal((size, size, 3))).astype(np.float32)
    stages = {}
    for name, fn in (("decode_preprocess_ms", lambda: preprocess_request(
                          _decode_upload(upload), size)),
                     ("encode_png_ms", lambda: _encode_png(fake))):
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        stages[name] = statistics.median(times)
    lat = sorted(r[3] for r in replies)
    row = dict(requests=len(plan), worst_png_counts=worst,
               unloaded_ms=alone, host_stages=stages,
               latency_p50_ms=lat[len(lat) // 2] * 1e3,
               latency_p95_ms=lat[min(len(lat) - 1,
                                      round(0.95 * (len(lat) - 1)))] * 1e3,
               n_flushes=summary["n_flushes"],
               max_queue_depth=summary["max_queue_depth"])
    log(f"server on {name_and_limit}: {len(plan)} .npy uploads over "
        f"{TIERS} from 4 client threads, all 200, PNGs within {worst} count "
        f"of the engine; request latency p50 {row['latency_p50_ms']:.1f} ms, "
        f"p95 {row['latency_p95_ms']:.1f} ms; {summary['n_flushes']} flushes; "
        f"one request alone {json.dumps(alone)} ms; host stages of one "
        f"request {json.dumps(stages)}")
    return row


def train_launches_per_step(config) -> dict:
    """Launches of each kernel in one combined train step, from its
    structure: each generator runs 3 times (the fake, the cycle, the
    identity) and each discriminator 3 times (the adversarial site with
    its weights detached, the real image, the detached fake), and every
    one of these 12 applies is backpropagated. A generator apply has
    1 + down + residual instance-norm sites (K1 forward, K2 backward),
    residual epilogue sites (K3, K4) and up upsample sites (K5, whose
    backward is a K4 over its transposed conv's output); a discriminator
    apply has one epilogue site (K3, K4) per downsampling block."""
    g, d = config.model.generator, config.model.discriminator
    norm_sites = 1 + g.num_downsampling_blocks + g.num_residual_blocks
    return {
        "instance_norm": 6 * norm_sites,
        "instance_norm_backward": 6 * norm_sites,
        "epilogue": 6 * (g.num_residual_blocks + d.num_downsampling),
        "epilogue_backward": 6 * (g.num_residual_blocks
                                  + g.num_upsample_blocks + d.num_downsampling),
        "upsample": 6 * g.num_upsample_blocks,
        "upsample_int8": 0,
    }


def signal_state(config, seed, device):
    """A train state whose four networks hold signal weights (convert.py):
    at the init distribution the discriminators output about 0 whatever
    they see, so only such weights exercise the adversarial gradient."""
    from cyclegan_tpu_torch.convert import (
        discriminator_state_from_flax,
        generator_state_from_flax,
        signal_discriminator_flax_params,
        signal_flax_params,
    )
    from cyclegan_tpu_torch.train.state import create_state

    state = create_state(config, seed, device)
    g, d = config.model.generator, config.model.discriminator
    for i, net in enumerate(state.networks):
        net.load_state_dict(
            generator_state_from_flax(signal_flax_params(g, seed + i)) if i < 2
            else discriminator_state_from_flax(
                signal_discriminator_flax_params(d, seed + i)))
    return state


def compare_train_step(torch, grad_fn, state, x, y, w, label, per_step):
    """One step's ten losses and four gradient trees on the kernels against
    the same step through the plain versions, in f32 and in float64, from
    the same state."""
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches

    def rel(a, b):
        return ((a.double() - b.double()).norm() / b.double().norm()).item()

    reset_launches()
    grads, metrics = grad_fn(state, x, y, w)
    torch.cuda.synchronize()
    if dict(LAUNCHES) != per_step:
        raise AssertionError(f"{label}: launches {dict(LAUNCHES)}, expected "
                             f"{per_step}")
    with plain_versions():
        plain_grads, plain = grad_fn(state, x, y, w)
        for net in state.networks:
            net.double()
        exact_grads, _ = grad_fn(state, x.double(), y.double(), w.double())
        for net in state.networks:
            net.float()
    scalar_err = max(abs(metrics[k].item() - plain[k].item())
                     / max(abs(plain[k].item()), 1e-12) for k in plain)
    worst = dict(kernels_vs_plain=0.0, kernels_vs_f64=0.0, plain_vs_f64=0.0,
                 share_of_tolerance=0.0, leaf=None)
    for net, ours, theirs, exact in zip(("G", "F", "D_X", "D_Y"), grads,
                                        plain_grads, exact_grads):
        for key, value in exact.items():
            errs = dict(kernels_vs_plain=rel(ours[key], theirs[key]),
                        kernels_vs_f64=rel(ours[key], value),
                        plain_vs_f64=rel(theirs[key], value))
            share = errs["kernels_vs_f64"] / (
                TRAIN_GRAD_RTOL + 2 * errs["plain_vs_f64"])
            for k, v in errs.items():
                worst[k] = max(worst[k], v)
            if not share <= worst["share_of_tolerance"]:
                worst.update(share_of_tolerance=share, leaf=f"{net} {key}")
    log(f"train step, {label} weights: losses kernels vs plain rel err "
        f"{scalar_err:.3g} (loss_G/loss {plain['loss_G/loss'].item():.4f}); "
        f"gradient leaves, max rel L2 err: kernels vs plain "
        f"{worst['kernels_vs_plain']:.3g}, kernels vs f64 "
        f"{worst['kernels_vs_f64']:.3g}, plain f32 vs f64 "
        f"{worst['plain_vs_f64']:.3g}; worst leaf {worst['leaf']} at "
        f"{worst['share_of_tolerance']:.3g} of its tolerance")
    if not (scalar_err <= TRAIN_SCALAR_RTOL
            and worst["share_of_tolerance"] <= 1.0):
        raise AssertionError(f"{label}: train step differs from the plain "
                             f"path: losses {scalar_err}, gradients {worst}")
    return dict(losses_rel_err=scalar_err, grads=worst)


def ops_by_device_time(torch, run, top: int = 6) -> list:
    """The ops (with their input shapes) that take the most device time in
    one call of ``run``, from torch.profiler with shapes recorded."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            run()
            torch.cuda.synchronize()
    except RuntimeError as e:  # the profiler (CUPTI) refused
        return [f"not measured ({e})"]
    rows = []
    for avg in prof.key_averages(group_by_input_shape=True):
        if not avg.key.startswith("aten::"):
            continue
        device_us = getattr(avg, "device_time_total", None)
        if device_us is None:
            device_us = avg.cuda_time_total
        rows.append(dict(op=avg.key, shapes=str(avg.input_shapes)[:120],
                         calls=avg.count, device_ms=device_us / 1e3))
    # Exclude wrappers whose device time is their callee's.
    rows = [r for r in rows if r["op"] not in (
        "aten::convolution", "aten::_convolution", "aten::conv2d")]
    return sorted(rows, key=lambda r: -r["device_ms"])[:top]


def residual_conv_ms(torch, device) -> dict:
    """Device time of the residual blocks' 3x3 256 -> 256 VALID conv at
    256^2 (its [1, 256, 66, 66] padded input) forward, and of its backward
    split into the input gradient (dgrad) and the weight gradient (wgrad),
    in the port's channels_last layout with TF32 off."""
    import torch.nn.functional as F

    gen = torch.Generator().manual_seed(SEED)

    def t(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device).contiguous(
            memory_format=torch.channels_last)

    x, g = t(1, 256, 66, 66), t(1, 256, 64, 64)
    w = t(256, 256, 3, 3, scale=1 / 48)
    args = ([1, 1], [0, 0], [1, 1], False, [0, 0], 1)

    def backward(mask):
        return lambda: torch.ops.aten.convolution_backward(g, x, w, None, *args,
                                                           mask)
    return dict(forward_ms=median_ms(torch, lambda: F.conv2d(x, w)),
                dgrad_ms=median_ms(torch, backward([True, False, False])),
                wgrad_ms=median_ms(torch, backward([False, True, False])))


def upsample_backward_ms(torch, device) -> dict:
    """Device time of the upsample block's composed backward (K4 over the
    kept transposed-conv output, then the transposed conv's VJP through
    cuDNN) per call at its two batch-1 shapes, whole and in its parts."""
    import numpy as np

    from cyclegan_tpu_torch.ops.norm import instance_norm_act_pad_backward
    from cyclegan_tpu_torch.ops.upsample import (
        conv_transpose_vjp,
        upsample_norm_relu_pad,
    )

    rng = np.random.default_rng(SEED)
    out = {}
    for h, cin, cout, pad in ((64, 256, 128, 0), (128, 128, 64, 3)):
        def t(*shape, scale=1.0, shift=0.0):
            a = rng.standard_normal(shape) * scale + shift
            return torch.from_numpy(a.astype(np.float32)).to(device)

        x = t(1, h, h, cin).requires_grad_()
        k = t(3, 3, cin, cout, scale=1 / np.sqrt(4 * cin)).requires_grad_()
        s, b = t(cout, shift=1.0).requires_grad_(), t(cout).requires_grad_()
        y = upsample_norm_relu_pad(x, k, s, b, pad)
        g = t(*y.shape)
        node = y.grad_fn
        x_, k_, s_, b_, mean, inv, conv = node.saved_tensors
        dconv = instance_norm_act_pad_backward(conv, s_, b_, mean, inv, g,
                                               pad)[0]
        out[f"[1,{h},{h},{cin}]x{cout} pad {pad}"] = dict(
            whole_ms=median_ms(torch, lambda: torch.autograd.grad(
                y, (x, k, s, b), g, retain_graph=True)),
            epilogue_backward_ms=median_ms(
                torch, lambda: instance_norm_act_pad_backward(
                    conv, s_, b_, mean, inv, g, pad)),
            conv_transpose_vjp_ms=median_ms(
                torch, lambda: conv_transpose_vjp(x_, k_, dconv)))
    return out


def train(torch, device, name_and_limit):
    import numpy as np

    from cyclegan_tpu_torch.config import Config
    from cyclegan_tpu_torch.data.augment import normalize_image
    from cyclegan_tpu_torch.data.sources import SyntheticSource
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.train.steps import (
        METRIC_KEYS,
        make_grad_fn,
        make_train_step,
    )

    config = Config()  # full width, 256^2, f32, batch 1
    batch = config.train.batch_size
    source = SyntheticSource(image_size=config.model.image_size)

    def images(split, index):
        return torch.from_numpy(normalize_image(
            source.load(split, index))[None]).to(device)

    per_step = train_launches_per_step(config)
    w = torch.ones(batch, device=device)
    x, y = images("trainA", 0), images("trainB", 0)
    grad_fn = make_grad_fn(config, batch)
    checks = {}
    for label, state in (("init", create_state(config, SEED, device)),
                         ("signal", signal_state(config, SEED + 10, device))):
        if label == "init":  # warm-up: cuDNN's first calls
            grad_fn(state, x, y, w)
            torch.cuda.synchronize()
        checks[label] = compare_train_step(torch, grad_fn, state, x, y, w,
                                           label, per_step)
        del state

    # The main path: TRAIN_STEPS steps on the kernels from the init weights.
    state = create_state(config, SEED, device)
    train_step = make_train_step(config, batch)
    data = [(images("trainA", i), images("trainB", i))
            for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, losses = [], []
    for x, y in data:
        t0 = time.perf_counter()
        state, metrics = train_step(state, x, y, w)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append({k: metrics[k].item() for k in METRIC_KEYS})
    launches = dict(LAUNCHES)
    peak_bytes = torch.cuda.max_memory_allocated()
    for i, row in enumerate(losses):
        log(f"step {i + 1}: " + ", ".join(f"{k} {v:.5f}" for k, v in row.items()))
    if not all(np.isfinite(v) for row in losses for v in row.values()):
        raise AssertionError("a train step gave a non-finite loss")
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if launches != want or state.step != TRAIN_STEPS:
        raise AssertionError(f"train launches {launches}, expected {want}; "
                             f"step {state.step}")
    median = statistics.median(step_ms[2:])
    log(f"train 256^2 f32 batch {batch} on {name_and_limit}: "
        f"{median:.2f} ms per step (median of the last {TRAIN_STEPS - 2}; "
        f"all: {', '.join(f'{t:.2f}' for t in step_ms)}), "
        f"{batch * 1e3 / median:.2f} images/s, peak memory "
        f"{peak_bytes / 2**20:.1f} MiB, launches per step "
        f"{ {k: v // TRAIN_STEPS for k, v in launches.items()} }")

    breakdown = device_breakdown(
        torch, lambda: train_step(state, x, y, w), runs=3)
    log(f"device time per train step on {name_and_limit} (profiled): "
        f"{json.dumps(breakdown)}")
    top_ops = ops_by_device_time(torch, lambda: train_step(state, x, y, w))
    log(f"ops by device time in one train step on {name_and_limit} "
        f"(profiled): {json.dumps(top_ops)}")
    conv = residual_conv_ms(torch, device)
    log(f"residual 3x3 256->256 conv on {name_and_limit}: {json.dumps(conv)}")
    upsample_bwd = upsample_backward_ms(torch, device)
    log(f"upsample composed backward per call on {name_and_limit}: "
        f"{json.dumps(upsample_bwd)}")
    return launches, dict(checks=checks, ms_per_step=median,
                          step_ms=step_ms,
                          images_per_s=batch * 1e3 / median,
                          peak_bytes=peak_bytes, losses=losses,
                          breakdown=breakdown, top_ops=top_ops,
                          residual_conv=conv,
                          upsample_backward=upsample_bwd)


def run_module(module: str, args: list, timeout: float) -> str:
    """``python -m module args`` from the repo's root in a child process;
    its standard output. Raises with the output's tail when it fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    child = subprocess.Popen([sys.executable, "-m", module, *args], cwd=root,
                             env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    CHILDREN.append(child)
    try:
        out, _ = child.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        out, _ = child.communicate()
        raise AssertionError(f"{module} {' '.join(args)} ran past {timeout} "
                             f"s:\n{out[-4000:]}")
    finally:
        CHILDREN.remove(child)
    if child.returncode != 0:
        raise AssertionError(f"{module} {' '.join(args)} exited "
                             f"{child.returncode}:\n{out[-4000:]}")
    return out


def epoch_means(out_dir: str) -> dict:
    """epoch -> {"train/<tag>": mean, "test/<tag>": mean} from a run's event
    files, the loss and error means only."""
    from cyclegan_tpu_torch.utils.summary import read_scalars

    means: dict = {}
    for split, logdir in (("train", out_dir),
                          ("test", os.path.join(out_dir, "test"))):
        for tag, rows in read_scalars(logdir).items():
            if tag.startswith(("loss_", "error/")):
                for step, value in rows:
                    means.setdefault(step, {})[f"{split}/{tag}"] = value
    return means


def relative_gap(a: dict, b: dict) -> float:
    if set(a) != set(b) or not a:
        raise AssertionError(f"epoch means with other keys: {sorted(a)} vs "
                             f"{sorted(b)}")
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in a)


def write_npy_folder(root: str) -> None:
    """A FolderSource tree of .npy images from SyntheticSource."""
    import numpy as np

    from cyclegan_tpu_torch.data.sources import SPLITS, SyntheticSource

    source = SyntheticSource(EPOCHS_TRAIN_IMAGES, EPOCHS_TEST_IMAGES,
                             image_size=EPOCHS_IMAGE_SIZE)
    for split in SPLITS:
        os.makedirs(os.path.join(root, split))
        for i in range(source.split_size(split)):
            np.save(os.path.join(root, split, f"{i:03d}.npy"),
                    source.load(split, i))


def cli_launches(config, epochs, train_steps, test_steps, plot_pairs,
                 checkpoint_epochs) -> dict:
    """Launches of each kernel in a run of the training CLI at batch 1:
    each train step's (``train_launches_per_step``), each test step's
    (G and F each run three times, the cycle and the identity, and each
    discriminator twice, without gradients) and each cycle plot's (four
    generator forwards a pair, at each checkpoint epoch)."""
    per_step = train_launches_per_step(config)
    d_epilogue = config.model.discriminator.num_downsampling
    out = {}
    for name, per_forward in LAUNCHES_PER_FORWARD.items():
        test = 6 * per_forward + (4 * d_epilogue if name == "epilogue" else 0)
        out[name] = (epochs * (train_steps * per_step[name]
                               + test_steps * test)
                     + checkpoint_epochs * plot_pairs * 4 * per_forward)
    return out


def epochs(torch, device, name_and_limit, train_summary):
    import io
    import re
    import shutil
    import tempfile

    import numpy as np

    from cyclegan_tpu_torch import main as train_main
    from cyclegan_tpu_torch.config import Config
    from cyclegan_tpu_torch.convert import generator_state_from_flax
    from cyclegan_tpu_torch.data.augment import preprocess_test
    from cyclegan_tpu_torch.data.sources import load_image_file
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.translate import load_checkpoint, translate_arrays
    from cyclegan_tpu_torch.utils.checkpoint import Checkpointer, state_digest
    from cyclegan_tpu_torch.utils.plotting import to_uint8

    tmp = tempfile.mkdtemp(prefix="chip_smoke_epochs_")
    try:
        data_dir = os.path.join(tmp, "data")
        write_npy_folder(data_dir)
        runs = {name: os.path.join(tmp, name) for name in "ABC"}

        def train(name, n_epochs, in_process=False):
            """A run of the CLI: in a child process, or (run C) through its
            ``main`` in this one, where the kernels' counts can be read."""
            args = ["--output_dir", runs[name], "--epochs", str(n_epochs),
                    "--ckpt_keep", "2", "--data_source", "folder",
                    "--data_dir", data_dir, "--verbose", "0", "--seed",
                    str(SEED)]
            t0 = time.perf_counter()
            if in_process:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    train_main.main(args)
                torch.cuda.synchronize()
                out = buf.getvalue()
            else:
                out = run_module("cyclegan_tpu_torch.main", args,
                                 timeout=DEADLINES["epochs"])
            log(f"run {name} to {n_epochs} epochs"
                f"{' in this process' if in_process else ''}: "
                f"{time.perf_counter() - t0:.1f} s")
            if "preprocessing native" not in out:
                raise AssertionError(f"run {name} did not preprocess natively:"
                                     f"\n{out[-2000:]}")
            return out

        def ring(name):
            return [os.path.basename(p) for _, p in
                    Checkpointer(runs[name], keep=2).slots()]

        out_a = train("A", 3)
        out_b = train("B", 2)
        # The slot B resumes from, reloaded on the card, against the digest
        # of the state B held when it saved it.
        ckpt_b = Checkpointer(runs["B"], keep=2)
        _, slot_b = ckpt_b.slots()[0]
        manifest = ckpt_b.read_manifest(slot_b)
        config = Config(model=Config.model_from_meta(ckpt_b.read_meta()))
        reloaded = ckpt_b.load_slot(create_state(config, SEED + 1, device),
                                    slot_b)
        if state_digest(reloaded) != manifest["state_sha256"]:
            raise AssertionError(f"{slot_b} reloads other than it was saved")
        del reloaded
        out_b2 = train("B", 3)
        if f"Resumed from {slot_b} at epoch 2" not in out_b2:
            raise AssertionError(f"run B did not resume from {slot_b}:\n"
                                 f"{out_b2[-2000:]}")
        # Run C, A's arguments again, is the main path of this phase: the
        # training CLI through the kernels, counted from 0.
        torch.cuda.synchronize()
        reset_launches()
        train("C", 3, in_process=True)
        launches = dict(LAUNCHES)
        want_launches = cli_launches(
            Config(), epochs=3, train_steps=EPOCHS_TRAIN_IMAGES,
            test_steps=EPOCHS_TEST_IMAGES,
            plot_pairs=min(EPOCHS_TEST_IMAGES, Config().train.plot_samples),
            checkpoint_epochs=2)
        log(f"run C's launches {launches}")
        if launches != want_launches:
            raise AssertionError(f"run C launched {launches}, expected "
                                 f"{want_launches}")
        rings = {name: ring(name) for name in "ABC"}
        want = {"A": ["checkpoint-e00002", "checkpoint-e00000"],
                "B": ["checkpoint-e00002", "checkpoint-e00001"],
                "C": ["checkpoint-e00002", "checkpoint-e00000"]}
        if rings != want:
            raise AssertionError(f"rings {rings}, expected {want}")
        shutil.rmtree(os.path.join(runs["C"], "checkpoints"))

        means = {name: epoch_means(runs[name]) for name in "ABC"}
        for name in "ABC":
            if sorted(means[name]) != [0, 1, 2] or not all(
                    np.isfinite(v) for row in means[name].values()
                    for v in row.values()):
                raise AssertionError(f"run {name} epoch means {means[name]}")
        gap_ac = {e: relative_gap(means["C"][e], means["A"][e])
                  for e in range(3)}
        gap_ab = {e: relative_gap(means["B"][e], means["A"][e])
                  for e in range(3)}
        tolerance = max(RESUME_GAP_FACTOR * max(gap_ac.values()),
                        RESUME_RTOL_FLOOR)
        log(f"epoch means, largest relative gap per epoch: A vs C (two "
            f"uninterrupted runs) {json.dumps(gap_ac)}; A vs B (B resumed "
            f"at epoch index 2) {json.dumps(gap_ab)}; tolerance {tolerance:.3g}")
        if not gap_ab[2] <= tolerance:
            raise AssertionError(f"the resumed epoch's means differ from the "
                                 f"uninterrupted run's by {gap_ab[2]:.3g} "
                                 f"(tolerance {tolerance:.3g})")

        from cyclegan_tpu_torch.utils.summary import read_scalars

        ips = dict(read_scalars(runs["A"])["perf/train_images_per_sec"])
        batch = 1
        loop_ms = {e: 2e3 * batch / ips[e] for e in sorted(ips)}
        saves = [dict(bytes=int(m.group(1)), seconds=float(m.group(2)))
                 for m in re.finditer(r"saved checkpoint to \S+ \((\d+) bytes "
                                      r"in ([\d.]+) s\)", out_a)]
        log(f"training loop 256^2 f32 batch 1 on {name_and_limit}: ms per "
            f"step by epoch (run A) {json.dumps(loop_ms)}, train images/s "
            f"{json.dumps(ips)}; the train phase's bare step "
            f"{train_summary['ms_per_step']:.2f} ms; checkpoint saves "
            f"{json.dumps(saves)}")
        if len(saves) != 2:
            raise AssertionError(f"run A saved {saves}")

        # translate from A's ring, against the generator through the engine.
        test_dir = os.path.join(data_dir, "testA")
        out_dir = os.path.join(tmp, "translated")
        run_module("cyclegan_tpu_torch.translate", [
            "--output_dir", runs["A"], "--input", test_dir, "--output",
            out_dir, "--panels"], timeout=DEADLINES["epochs"])
        names = sorted(os.listdir(test_dir))
        stems = [os.path.splitext(n)[0] for n in names]
        pngs = sorted(os.listdir(out_dir))
        if pngs != sorted([f"{s}.png" for s in stems]
                          + [f"{s}_panel.png" for s in stems]):
            raise AssertionError(f"translate wrote {pngs} for {names}")
        g, f, model_cfg = load_checkpoint(runs["A"])
        engine = InferenceEngine(
            model_cfg, generator_state_from_flax(g),
            generator_state_from_flax(f),
            serve_cfg=ServeConfig(batch_buckets=(1, 8),
                                  sizes=(model_cfg.image_size,),
                                  with_cycle=True), device=device)
        images = np.stack([preprocess_test(load_image_file(
            os.path.join(test_dir, n)), model_cfg.image_size) for n in names])
        fake, cycled = translate_arrays(engine, images)
        worst = 0
        for i, stem in enumerate(stems):
            for suffix, want_img in (
                    ("", to_uint8(fake[i])),
                    ("_panel", to_uint8(np.concatenate(
                        [images[i], fake[i], cycled[i]], axis=1)))):
                with open(os.path.join(out_dir, f"{stem}{suffix}.png"),
                          "rb") as fh:
                    got = decode_png(fh.read())
                worst = max(worst, int(np.abs(got.astype(int)
                                              - want_img).max()))
        log(f"translate from run A's checkpoint: {len(pngs)} PNGs, max "
            f"{worst} count(s) from the engine's output")
        if worst > PNG_TOL:
            raise AssertionError(f"translate PNGs differ by {worst} counts")
        return dict(launches=launches, gap_ac=gap_ac, gap_ab=gap_ab,
                    tolerance=tolerance,
                    loop_ms_per_step=loop_ms, train_images_per_s=ips,
                    bare_step_ms=train_summary["ms_per_step"],
                    checkpoint_saves=saves, translate_max_count_err=worst)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kernels_line(rows, launches, train_launches):
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        path = [r for r in mine if r["calls"]]
        backward = name in BACKWARD_KERNELS

        def per_call(key):
            return sum(r[key] * r["calls"] for r in path)

        t_bytes, t_ops = per_call("bytes_ms"), per_call("ops_ms")
        entry = dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=train_launches[name] if backward else launches[name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            ms=per_call("ms"), plain_ms=per_call("plain_ms"),
            bound_ms=per_call("bound_ms"),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=per_call("library_ms"))
        if backward:
            entry.update(
                launches_per_step=train_launches[name] // TRAIN_STEPS,
                tolerance={"dx_abs": KERNEL_TOL,
                           "dscale_dbias_share_of_sum_abs": REDUCTION_TOL},
                dx_max_abs_err=max(r["dx_max_abs_err"] for r in mine),
                reduction_rel_err=max(r["reduction_rel_err"] for r in mine),
                per="sum over the kernel's calls in one batch-1 256^2 train "
                    "step; launches over the train phase's "
                    f"{TRAIN_STEPS} steps")
        else:
            entry.update(
                launches_per_forward=launches[name] // MAIN_PATH_FORWARDS,
                train_launches=train_launches[name], tolerance=KERNEL_TOL,
                per="sum over the kernel's calls in one batch-1 256^2 "
                    "forward; launches over the "
                    f"{FORWARD_PATHS.get(name, 'serve')} phase's "
                    f"{MAIN_PATH_FORWARDS} forwards")
            if name in FORWARD_KERNELS:
                entry.update(
                    per_train_step=per_path(rows, (name,))[name][
                        "per_train_step"],
                    launches_per_call=[
                        r["launches_per_call"]["count"]
                        if isinstance(r["launches_per_call"], dict)
                        else r["launches_per_call"] for r in mine])
            if name in UPSAMPLE_PASSES:
                entry.update(
                    bound_route=f"split TF32, {UPSAMPLE_PASSES[name]} passes "
                                "on the tensor cores",
                    f32_fma_bound_ms=sum(r["bounds"]["f32_fma_ms"] * r["calls"]
                                         for r in path))
        entry["shapes"] = [{k: v for k, v in r.items() if k != "kernel"}
                           for r in mine]
        out.append(entry)
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
        for kernel, (pattern, fields, expected) in PTXAS_KERNELS.items():
            for row in kernel_ptxas(build, pattern, fields, expected):
                args = ", ".join(f"{key}={row[key]}" for key, _ in fields)
                log(f"ptxas {kernel}<{args}>: {row.get('registers')} "
                    f"registers, {row.get('smem_bytes')} bytes static smem, "
                    f"{row['stack_bytes']} bytes stack frame, "
                    f"{row['spill_store_bytes']}/{row['spill_load_bytes']} "
                    "bytes spill stores/loads")
    with phase("kernels"):
        rows = check_kernels(torch, device)
        log(f"forward norm kernels (K1, K3) per batch-1 256^2 serving "
            f"forward and train step on {name_and_limit} (ms, calls x "
            f"median): {json.dumps(per_path(rows, FORWARD_KERNELS))}")
        per_step = backward_per_step(rows)
        log(f"backward kernels per batch-1 256^2 train step on "
            f"{name_and_limit} (ms, calls x median): {json.dumps(per_step)}")
        log(f"upsample kernels per batch-1 256^2 serving forward and train "
            f"step on {name_and_limit} (ms, calls x median): "
            f"{json.dumps(upsample_per_path(rows))}")
    with phase("serve"):
        launches, summary = serve(torch, device, name_and_limit)
    log(f"serve summary on {name_and_limit}: {json.dumps(summary)}")
    with phase("train"):
        train_launches, train_summary = train(torch, device, name_and_limit)
    log(f"train summary on {name_and_limit}: {json.dumps(train_summary)}")
    with phase("epochs"):
        epochs_summary = epochs(torch, device, name_and_limit, train_summary)
    log(f"epochs summary on {name_and_limit}: {json.dumps(epochs_summary)}")
    with phase("serve_int8"):
        engine, int8_launches, int8_summary = serve_int8(
            torch, device, name_and_limit)
    log(f"serve_int8 summary on {name_and_limit}: {json.dumps(int8_summary)}")
    with phase("server"):
        server_summary = server(torch, engine, name_and_limit)
    log(f"server summary on {name_and_limit}: {json.dumps(server_summary)}")
    launches["upsample_int8"] = int8_launches["int8_fused"]["upsample_int8"]
    print(kernels_line(rows, launches, train_launches), flush=True)
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
