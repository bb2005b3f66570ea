#!/usr/bin/env python3
"""Start-up proof of the PyTorch/H100 port (cyclegan_tpu_torch) on one card.

  python3 chip_smoke.py

Phases, each with a deadline and one progress line:
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    the CUDA kernels from cyclegan_tpu_torch/csrc (nvcc + ctypes),
              with ptxas's registers, shared memory, stack frame and spills
              for the forward norm kernel (K1, K3) and the apply pass of
              K5/K6's tail, the backward kernels (K2, K4) and the upsample
              kernels (K5, K6), f32 and bf16 forms, which must neither
              spill nor use a stack frame
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
              bounds (f32 FMAs, split TF32 or bf16 on the tensor cores), the
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
              plain versions in f32 and float64 (init-distribution and
              signal weights) on 3 draws of the images, each gradient leaf
              held with the largest plain f32 distance over the draws as
              what f32 reaches, then
              10 steps on the kernels with their losses, ms per step,
              images/s, peak memory, launches per kernel, a profiled
              device-time breakdown and the upsample's composed backward
  6. train_options  the train step's options at full width, 256^2, batch 1,
              on the kernels: the FusedProp grad fn at the init and signal
              states against the same fn through the plain versions in f32
              and float64 on 3 draws (the train phase's rule) and, on the
              first, against the combined
              grad fn, with its launches per step (K3 66, K4 84); an
              accumulated step over 2 microbatches and one batch-2 step on
              3 draws of the images, each against float64 (the train
              phase's rule, with the largest plain f32 distance over the
              draws as what f32 reaches) and against each other, the first
              draw's two microbatch steps alone and their sum against the
              accumulated step, with the peak memory of each; then 20
              rounds of one step each of combined and fusedprop with the
              health metrics off and on, in turns, ms per step, launches
              per step and peak memory, health/nonfinite 0 on clean data;
              the health metrics' work and FusedProp's input-side pull,
              each run alone: busy device time (profiled, the pull's K4
              calls apart), window a call and host enqueue time; and a
              batch multiplied by NaN that must give
              health/nonfinite > 0 and a HealthFault from
              HealthMonitor(on_nan="halt")
  7. epochs   the training CLI, python -m cyclegan_tpu_torch.main, in
              subprocesses at full width, 256^2, batch 1, on a folder of
              .npy images (6 train and 2 test a domain, 300^2, so the 286
              resize and the 256 crop both run, through the native
              preprocessing): run A, 3 epochs with a ring of 2, and run B,
              2 epochs, then again to 3, which must resume from its
              epoch-1 slot, both under torch's deterministic algorithms
              (set in the child); run C, A's arguments again in the default
              mode through the CLI's main in this process, the phase's main
              path, with each kernel's launches counted from 0 and held to
              the count of its train steps, test steps and cycle plots. The
              slot B resumed from reloads bitwise equal to the state it
              saved (the manifest's digest); B's train and test means, the
              resumed epoch's included, bitwise A's; C's gap from A
              reported; the loop's ms per step and images/s, C's beside
              the train phase's bare step and A's beside them; the
              checkpoint's bytes and the worker's write seconds, and the
              loop's wait at each checkpoint epoch with the epoch services
              in A and C; run C's default telemetry stream
              (telemetry.jsonl): the manifest first naming the card, a
              step record a dispatch and an epoch_steps a pass with the
              loop's counts, a memory watermark (0 < peak <= limit), a
              goodput rollup an epoch summing to its elapse, end last,
              completed; then python -m
              cyclegan_tpu_torch.translate from A's ring on the test
              images, each PNG decoded with zlib and held against the
              generator's output through the engine (+-1 count); run D
              trains one epoch from A's ring with --init_from A --transfer
              encoder_freeze --grad_impl fusedprop --grad_accum 2 on a
              --domain that a --domain_registry JSON maps onto the same
              folder: its slot's 32 frozen generator tensors must be A's
              bitwise and every other generator tensor must differ, its
              event file must hold health/gnorm_enc_frozen 0, its meta.json
              the domain and the transfer, and its output the health line
  8. serve_int8  the same generator through the int8 and int8_fused tiers
              of one engine (weights quantized once at start-up) at
              buckets 1 and 4 (a ragged flush of 3): launches per kernel
              per tier, int8_fused through the kernels against itself
              through the plain versions and against the int8 tier, both
              quantized tiers against the base tier, ms per flush,
              images/s, peak memory and resident weight bytes per tier,
              and the int8 tier's per-flush widening
  9. server   that engine behind the port's PipelinedExecutor and HTTP
              server on 127.0.0.1, with a telemetry stream and the request
              tracer (--obs_jsonl, --trace_sample): .npy uploads on base,
              int8 and int8_fused from a small thread pool in bursts at
              trace sample 1.0 and 0 in turns, each PNG reply decoded with
              zlib and held against the engine's output, each reply's
              X-Trace-Id, exactly one kept trace for each traced request
              with the executor's hops in order inside its interval and
              none for an untraced one, /healthz, /stats and /metrics (the
              hop histograms), request latency p50 and p95 at both samples
 10. bf16     bfloat16 compute at full width: the bf16 forms of K1-K5
              against their bf16 plain versions on the same bf16 inputs at
              every path shape (statistics and dscale/dbias at the f32
              tolerances, bf16 outputs within 2 bf16 ulps, K5's conv output
              before its rounding against float64, mask flips, device
              launches, times beside the bounds at 2 bytes an element and
              the dense BF16 peak); the bf16 engine at buckets 1 and 4
              (its main path counted from 0) against itself through the
              plain versions and against the f32 engine within the JAX
              package's pins, ms per flush, images/s, peak memory; the bf16
              train step against float64 on 3 draws, then 10 steps with ms
              per step, images/s, peak memory and launches beside the f32
              step's; --bf16 through the training CLI for one epoch and
              translate from its ring, in bf16 by default
 11. driver   the driver around the loop: (a) in a child under torch's
              deterministic algorithms (this script with --graph-check),
              2 dispatches of 4 steps as one captured CUDA graph against
              8 eager steps from one state, full width, 256^2, batch 1,
              health on, f32 and bf16: weights, Adam moments and counts,
              step and every metric bitwise equal; (b) in that child, per
              dtype, the wrappers' counts at the capture (they count in
              Python, so never at a replay) and one replay's device
              launches (CUPTI, in a process where the profiler has not run
              before) by kernel instantiation, each 4 times a step's, and
              no wrapper call during a replay; (c) ms per step and images/s
              at K = 1 and K = 4 over dispatch groups in turns, the
              device's idle share and peak memory, f32 and bf16; (d) the
              CLI on the epochs phase's folder: --steps_per_dispatch 4
              (one graphed dispatch and 2 single steps an epoch) with
              epoch means bitwise a K = 1 run's, a run with
              --preempt_deadline_s sent SIGTERM after its first epoch line
              (exit 0, a mid_epoch slot, its stream's emergency_save
              event and end "preempted") whose resumed run's final epoch
              means are bitwise the uninterrupted run's (all under
              deterministic algorithms), and --trace 2 at K = 4 whose
              trace names K1-K5 and whose stream holds one "multi" step
              record for each graphed dispatch
 12. obs      the deferred fetch's window: the train loop at bf16, K = 4,
              full width, on batches already in host memory, for 24
              dispatches, so that the window (32 pinned batches) fills and
              at least 12 backpressure fetches follow; after each, the
              newest dispatch's event must still be pending for at least
              half of them (the fetch waits for its own dispatch alone);
              the same count at f32 and bf16 K = 1 (44 dispatches, no
              gate) with the step records' breakdown of a step; then the
              training CLI's loop ms per step with its stream on and with
              --no_obs, one epoch each, in turns
 13. layouts  the JAX package's other layouts, every phase above running the
              kernel layout (norms pallas, pads epilogue, upsample
              zeroskip_fused): at full width, 256^2, f32, batch 1, each
              layout of LAYOUT_MATRIX (the JAX default auto/pad/dense, which
              launches no kernel; xla/fused/zeroskip; pallas/pad/dense;
              pallas/fused/zeroskip_fused; auto/epilogue/dense; pad_mode
              zero; the perturb trunk; remat; scan_blocks): a forward's and a
              step's launches against models/layout.py's count, the step
              held against float64 by the train phase's rule on one draw, 3
              timed steps with their peak memory, and under remat 3
              dispatches of a 2-step CUDA graph; the kernel layout at 512^2
              with and without remat (the same checks, remat's peak lower);
              the perturb tier through the engine at buckets 1 and 4 against
              the plain versions; the CLI one epoch at the JAX defaults, with
              --trunk_impl perturb and with --scan_blocks, at once, and
              translate from each ring; then every f32 kernel against its
              plain version at the shapes only these layouts give (the
              discriminator's K1/K2, the tail's K3 pad 3 after a dense
              upsample, each kernel at 512^2)

Prints the kernels' JSON line, then, only if every phase passed, the last
line {"ok": true, "device": {...}}. Exits non-zero, with no result, when
no CUDA device is present or a phase fails or runs out of time.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback

# Seconds each phase may take; a phase past its deadline ends the run.
DEADLINES = {"device": 60, "build": 420, "kernels": 300, "serve": 360,
             "train": 600, "train_options": 300, "epochs": 300,
             "serve_int8": 300, "server": 300, "bf16": 600, "driver": 300,
             "obs": 240, "layouts": 600}
SEED = 0
TIMED_LAUNCHES = 30
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s, f32
# FLOP/s outside the tensor cores and dense TF32 FLOP/s on them.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
# Dense BF16 FLOP/s on the tensor cores (the same data sheet): the bound of
# the bf16 upsample kernel's products, one pass each.
BF16_FLOP_PER_S = 989e12
# Tensor-core passes of the upsample kernels' products and their rate: K5
# splits both operands (lo*hi, hi*lo, hi*hi); K6's int8 weights are exact
# in TF32, so lo_b = 0 (lo*q, hi*q); K5 in bf16 takes one bf16 pass.
UPSAMPLE_PASSES = {"upsample": 3, "upsample_int8": 2, "upsample_bf16": 1}
UPSAMPLE_RATE = {"upsample": TF32_FLOP_PER_S, "upsample_int8": TF32_FLOP_PER_S,
                 "upsample_bf16": BF16_FLOP_PER_S}
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
# The bf16 engine against the f32 engine on the same weights (max and mean
# |output difference|): the JAX package's own pins of its bf16 serving path
# (tests/test_serve.py); the bf16 engine through the kernels against the
# same engine through the plain versions is held to the same max, and to a
# mean no larger than the plain bf16 path's own from f32.
BF16_SERVE_MAX = 0.1
BF16_SERVE_MEAN = 0.02
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
# A goodput rollup's phases against its epoch's elapse: the ledger rounds
# each of its seven phases to 1e-6 s (obs/goodput.py).
GOODPUT_SUM_TOL = 7 * 0.5e-6
# The fields of a step record that split its wall (obs/stepclock.py).
STEP_PARTS = ("wall_s", "data_wait_s", "dispatch_s", "fetch_block_s",
              "host_work_s", "submit_ready_s")
# The server phase's bursts run at these request-trace samples, in turns
# (TRACE_ROUNDS rounds of four bursts); a traced request's spans are the
# executor's hops, in this order.
TRACE_ROUNDS = 8
TRACE_SAMPLES = (1.0, 0.0, 0.0, 1.0) * TRACE_ROUNDS
SERVE_HOPS = ("admit", "queue", "stack", "submit", "device", "resolve")
# One train step through the kernels against the same step through the
# plain versions: the ten loss scalars, relative. Each gradient leaf is held
# against the same step through the plain versions in float64: its
# relative L2 error must stay within TRAIN_GRAD_RTOL plus twice what f32
# reaches on that leaf, the largest distance of the plain versions' own
# f32 step from float64 over REACH_DRAWS draws of the images. (At full
# width, f32 sums over 65,536 pixels per instance-norm site leave the plain
# f32 step itself up to ~5e-3 from float64 on the norm parameters' leaves,
# so a bare 1e-3 between two f32 paths measures rounding, not the kernels;
# and these leaves amplify an ulp-level change of the forward a
# thousandfold, so one plain run is one sample of a wide spread: a batch-1
# step read 2.35 of a one-run rule, PERF.md, Findings.)
TRAIN_SCALAR_RTOL = 1e-4
TRAIN_GRAD_RTOL = 1e-3
REACH_DRAWS = 3
# Draws of the images alone do not sample that spread: on the card the
# kernels' step read 1.38 of the rule on one draw in three while the plain
# step's three draws all lay low on that leaf (PERF.md, Findings). So each
# draw's plain step also runs REACH_PERTURBATIONS times on its images moved
# by one f32 ulp, each element up or down at random (a change of the
# forward's rounding, not of the data), and what f32 reaches on a leaf is
# the largest distance from float64 over the draws and their moved runs.
REACH_PERTURBATIONS = 3
# The bf16 train step, held the same way against the float64 step: each
# gradient leaf within BF16_RTOL plus twice the largest distance of the
# plain bf16 step from float64 over the draws, and each loss within
# BF16_RTOL of its float64 value plus twice the plain bf16 step's largest
# distance. Two bf16 ulps relative (2^-7): the bf16 counterpart of the f32
# rule's 1e-3, a few f32 ulps of the norms' sums.
BF16_RTOL = 2 ** -7
TRAIN_STEPS = 10
# The train_options phase: rounds of the four timed variants (combined and
# FusedProp, health off and on, in turns); draws of the two images of the
# accumulation check, over which the plain f32 runs' largest distance from
# float64 on a leaf is taken as what f32 reaches there; and the leaves whose
# readings it logs by draw (the one that read 1.18 of a one-run rule).
OPTIONS_ROUNDS = 20
ACCUM_WATCHED_LEAVES = (("G", "InstanceNorm_0.bias"),)
# The epochs phase's folder: images a domain in each split, and their side.
EPOCHS_TRAIN_IMAGES = 6
EPOCHS_TEST_IMAGES = 2
EPOCHS_IMAGE_SIZE = 300
# The epochs phase runs A and B under torch's deterministic algorithms:
# without them two runs of one seed drift apart on the card (~1e-6 after one
# epoch to ~2e-2 after three, PERF.md), so the resumed run B is held to A
# bitwise under them. The child's program: it turns them on, then runs
# the module named by argv[1] as __main__ with argv[2:] as its arguments.
DETERMINISTIC_RUN = ("import runpy, sys, torch; "
                     "torch.use_deterministic_algorithms(True); "
                     "sys.argv = sys.argv[1:]; "
                     "runpy.run_module(sys.argv[0], run_name='__main__', "
                     "alter_sys=True)")
# Processes this script starts, stopped when a phase runs out of time.
CHILDREN: list = []
# The layout in which every norm, epilogue and upsample site is a kernel
# (cyclegan_tpu_torch/config.py KERNEL_LAYOUT), which every phase but
# layouts runs, and its CLI flags. The JAX package's default layout, the
# config's and the CLI's default, launches none of the kernels.
KERNEL_LAYOUT = {"instance_norm_impl": "pallas", "pad_impl": "epilogue",
                 "upsample_impl": "zeroskip_fused"}
KERNEL_FLAGS = ["--norm_impl", "pallas", "--pad_impl", "epilogue",
                "--upsample_impl", "zeroskip_fused"]


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


def kernel_cases(bf16: bool = False, layouts: bool = False):
    """Each kernel's shapes on the 256^2 path, with its calls per serving
    forward (batch 1; the batch-4 shapes run at bucket 4) or per batch-1
    train step, its work in bytes and operations, and the calls that the
    kernel, the plain version and the library run. With ``bf16`` the bf16
    forms of K1-K5 (named with ``_bf16``) on the same shapes: activations,
    cotangents and the upsample kernel in bf16 (2 bytes an element), norm
    parameters and statistics f32; K6 has no bf16 form. With ``layouts``
    instead the f32 shapes that only the other layouts and 512^2 give
    (``layout_shapes``), each with no calls on the 256^2 kernel-layout
    path."""
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

    esize = 2 if bf16 else 4
    suffix = "_bf16" if bf16 else ""

    def act(*tensors):
        """Activations (and the upsample kernel) in the case's type."""
        return [t.to(torch.bfloat16) if bf16 else t for t in tensors]

    # The nearest PyTorch calls, timed only here. Each takes the case's
    # inputs and returns a call whose first (NCHW) output is compared with
    # the plain version's first output. In bf16 they take the norm
    # parameters in bf16 too.
    def lib_norm(x, s, b):
        s, b = s.to(x.dtype), b.to(x.dtype)
        return lambda: F.instance_norm(to_nchw(x), weight=s, bias=b, eps=1e-3)

    def lib_epilogue(x, s, b, pad, slope):
        s, b = s.to(x.dtype), b.to(x.dtype)

        def run():
            y = F.instance_norm(to_nchw(x), weight=s, bias=b, eps=1e-3)
            y = F.leaky_relu(y, slope) if slope else F.relu(y)
            return F.pad(y, (pad,) * 4, mode="reflect") if pad else y
        return run

    def lib_upsample(x, k, s, b, pad):
        h, w = x.shape[1:3]
        # flax's unflipped HWIO kernel as torch's flipped [Cin, Cout, kh, kw].
        wt = k.permute(2, 3, 0, 1).flip(2, 3)
        s, b = s.to(x.dtype), b.to(x.dtype)

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
                  s.detach().to(x.dtype).requires_grad_(),
                  b.detach().to(x.dtype).requires_grad_()]
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
        x, g = act(x, g)
        mean, inv = instance_norm_plain(x, s, b)[1:]
        if slope is None:
            return [x, s, mean, inv, g]
        return [x, s, b, mean, inv, g, pad, slope]

    def norm_case(n, h, c, calls, step_calls):
        elems = n * h * h * c
        return dict(
            kernel="instance_norm" + suffix, n=n, shape=[n, h, h, c],
            calls=calls, step_calls=step_calls,
            bytes=esize * 2 * elems + 4 * (2 * c + 2 * n * c), ops=8 * elems,
            inputs=lambda g: act(*g((n, h, h, c))) + g((c,), (c,)),
            kernel_fn=instance_norm_cuda, plain_fn=instance_norm_plain,
            library=lib_norm)

    def epilogue_case(n, h, c, pad, slope, calls, step_calls):
        elems = n * h * h * c
        out = n * (h + 2 * pad) ** 2 * c
        return dict(
            kernel="epilogue" + suffix, n=n, shape=[n, h, h, c], pad=pad,
            slope=slope, calls=calls, step_calls=step_calls,
            bytes=esize * (elems + out) + 4 * (2 * c + 2 * n * c),
            ops=9 * elems,
            inputs=lambda g: act(*g((n, h, h, c))) + g((c,), (c,))
            + [pad, slope],
            kernel_fn=instance_norm_act_pad_cuda,
            plain_fn=instance_norm_act_pad_plain, library=lib_epilogue)

    def upsample_case(n, h, cin, cout, pad, calls):
        out = n * (2 * h + 2 * pad) ** 2 * cout
        return dict(
            kernel="upsample" + suffix, n=n, shape=[n, h, h, cin],
            cout=cout, pad=pad, calls=calls,
            gemm_ops=2 * 9 * n * h * h * cin * cout,
            bytes=esize * (n * h * h * cin + 9 * cin * cout + out)
            + 4 * (2 * cout + 2 * n * cout),
            ops=2 * 9 * n * h * h * cin * cout + 9 * n * 4 * h * h * cout,
            inputs=lambda g: act(*g((n, h, h, cin)),
                                 *g((3, 3, cin, cout), weight=True))
            + g((cout,), (cout,)) + [pad],
            kernel_fn=upsample_norm_relu_pad_cuda,
            plain_fn=upsample_norm_relu_pad_plain, library=lib_upsample)

    def norm_backward_case(h, c, calls):
        elems = h * h * c
        return dict(
            kernel="instance_norm_backward" + suffix, n=1, shape=[1, h, h, c],
            calls=calls, backward=True,
            # x and g read, dx written; scale, mean and inv read, the
            # dscale and dbias partials written.
            bytes=esize * 3 * elems + 4 * 5 * c, ops=11 * elems,
            inputs=lambda g: backward_inputs(g, (1, h, h, c), 0, None),
            kernel_fn=instance_norm_backward_cuda,
            plain_fn=instance_norm_backward_plain,
            library=lambda x, s, m, i, g: lib_backward(
                x, s, torch.zeros_like(s), g, 0, None))

    def epilogue_backward_case(h, c, pad, slope, calls):
        elems = h * h * c
        padded = (h + 2 * pad) ** 2 * c
        return dict(
            kernel="epilogue_backward" + suffix, n=1, shape=[1, h, h, c],
            pad=pad, slope=slope, calls=calls, backward=True,
            bytes=esize * (2 * elems + padded) + 4 * 6 * c, ops=14 * elems,
            inputs=lambda g: backward_inputs(g, (1, h, h, c), pad, slope),
            kernel_fn=instance_norm_act_pad_backward_cuda,
            plain_fn=instance_norm_act_pad_backward_plain,
            library=lambda x, s, b, m, i, g, pad, slope: lib_backward(
                x, s, b, g, pad, slope))

    if layouts:
        shapes = layout_shapes()
        return ([norm_case(1, h, c, 0, 0) for h, c in shapes["norm"]]
                + [epilogue_case(1, h, c, pad, slope, 0, 0)
                   for h, c, pad, slope in shapes["epilogue"]]
                + [upsample_case(1, h, cin, cout, pad, 0)
                   for h, cin, cout, pad in shapes["upsample"]]
                + [norm_backward_case(h, c, 0) for h, c in shapes["norm"]]
                + [epilogue_backward_case(h, c, pad, slope, 0)
                   for h, c, pad, slope in shapes["epilogue_backward"]])

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
            cases.append(upsample_case(n, h, cin, cout, pad,
                                       1 if n == 1 else 0))
            if bf16:
                continue
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
        cases.append(norm_backward_case(h, c, calls))
    # The residual blocks' epilogues, the upsamples' tails (an upsample's
    # backward is an epilogue backward over its transposed conv's output),
    # and the discriminators' three tails.
    for h, c, pad, slope, calls in ((64, 256, 1, 0.0, 54),
                                    (128, 128, 0, 0.0, 6),
                                    (256, 64, 3, 0.0, 6),
                                    (64, 128, 0, 0.2, 6),
                                    (32, 256, 0, 0.2, 6),
                                    (32, 512, 0, 0.2, 6)):
        cases.append(epilogue_backward_case(h, c, pad, slope, calls))

    return cases


def layout_shapes() -> dict:
    """The f32 kernel shapes, batch 1, that only the other layouts and
    512^2 give: K1/K2 at the discriminator's norms (pad_impl other than
    epilogue), K3/K4 at the tail's pad 3 after a dense or zero-skip
    upsample, and every kernel at each shape of the 512^2 step in the
    kernel layout (the trunk at 128^2, the discriminator at 128^2 and
    64^2, the upsamples from 128^2 and 256^2)."""
    disc = ((64, 128), (32, 256), (32, 512))
    big_norm = ((512, 64), (256, 128), (128, 256))
    big_disc = ((128, 128), (64, 256), (64, 512))
    return dict(
        norm=disc + big_norm,
        epilogue=((256, 64, 3, 0.0), (128, 256, 1, 0.0), (512, 64, 3, 0.0))
        + tuple((h, c, 0, 0.2) for h, c in big_disc),
        upsample=((128, 256, 128, 0), (256, 128, 64, 3)),
        epilogue_backward=((128, 256, 1, 0.0), (256, 128, 0, 0.0),
                           (512, 64, 3, 0.0))
        + tuple((h, c, 0, 0.2) for h, c in big_disc))


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
# The bf16 forms of K1-K5: the same sources, the same TPU kernels (which
# are dtype-generic), their own launch counts.
BF16 = "_bf16"
KERNELS.update({name + BF16: KERNELS[name] for name in (
    "instance_norm", "instance_norm_backward", "epilogue",
    "epilogue_backward", "upsample")})
BACKWARD_KERNELS = ("instance_norm_backward", "epilogue_backward")
FORWARD_KERNELS = ("instance_norm", "epilogue")


def base_name(name: str) -> str:
    """A kernel's name without the bf16 form's suffix."""
    return name[:-len(BF16)] if name.endswith(BF16) else name


def all_launches(**counts) -> dict:
    """A launch count of every kernel (``LAUNCHES``'s keys): ``counts``,
    the others 0."""
    out = dict.fromkeys(KERNELS, 0)
    out.update(counts)
    return out


def in_bf16(counts: dict) -> dict:
    """The same launches made by the bf16 forms."""
    return all_launches(**{k + BF16: v for k, v in counts.items() if v})


# Launches of each kernel in one generator forward at full width, on the
# base and int8 tiers (K5 at the upsamples) and on the int8_fused tier (K6).
LAUNCHES_PER_FORWARD = all_launches(instance_norm=12, epilogue=9, upsample=2)
LAUNCHES_PER_FUSED_FORWARD = all_launches(instance_norm=12, epilogue=9,
                                          upsample_int8=2)
# Generator forwards in the main path's run: one flush at bucket 1, one
# ragged flush at bucket 4.
MAIN_PATH_FORWARDS = 2
# The phase whose main path a forward kernel's launches are read from,
# where it is not the serve phase: K6 runs on the int8_fused tier only, the
# bf16 forms in the bf16 phase's serving run.
FORWARD_PATHS = {"upsample_int8": "serve_int8 (int8_fused tier)",
                 **{name + BF16: "bf16 (bf16 engine)"
                    for name in ("instance_norm", "epilogue", "upsample")}}


def bf16_excess(got, want) -> float:
    """The largest |got - want| over its tolerance, bf16 tensors of one
    shape: 2 bf16 ulps of the larger magnitude, never less than
    KERNEL_TOL (near zero the rounding of a cancelling f32 sum exceeds a
    bf16 ulp of the result). At most 1 where the outputs agree."""
    import torch

    a, b = got.float(), want.float()
    m = torch.maximum(a.abs(), b.abs())
    _, e = torch.frexp(m)
    tol = torch.clamp(torch.ldexp(torch.full_like(m, 2.0), e - 8),
                      min=KERNEL_TOL)
    return ((a - b).abs() / tol).max().item()


def output_error(got, want) -> tuple[float, int]:
    """(excess, differing): for a bf16 output bf16_excess, else the max
    abs error over KERNEL_TOL; and the count of elements that differ."""
    import torch

    if got.dtype == torch.bfloat16:
        excess = bf16_excess(got, want)
    else:
        excess = (got - want).abs().max().item() / KERNEL_TOL
    return excess, int((got != want).sum().item())


def backward_errors(case, args, got, want) -> dict:
    """A backward kernel's errors against its plain version: dx in abs
    (bf16: over its tolerance, bf16_excess), dscale and dbias relative to
    the sums of their terms' magnitudes (|g| folded onto the interior
    bounds the masked cotangent)."""
    from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import reflect_pad_transpose

    x, s = args[0], args[1]
    k2 = base_name(case["kernel"]) == "instance_norm_backward"
    mean, inv, g = args[-3:] if k2 else args[3:6]
    g_abs = reflect_pad_transpose(g.float().abs(), case.get("pad") or 0)
    xhat = (x.float() - mean[:, None, None, :]) * inv[:, None, None, :]
    sums = ((g_abs * xhat.abs()).sum(dim=(1, 2)), g_abs.sum(dim=(1, 2)))
    rel = max(((got[i] - want[i]).abs() / sums[i - 1]).max().item()
              for i in (1, 2))
    excess, differing = output_error(got[0], want[0])
    return dict(dx_max_abs_err=(got[0].float() - want[0].float()).abs()
                .max().item(), dx_excess=excess, dx_differing=differing,
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
    pre = (x.float() - mean[:, None, None, :]) * inv[:, None, None, :] * s + b
    flips = (pre > 0) != (to_nhwc(library.pre) > 0)
    moved = (coef * reflect_pad_transpose(g.float(), pad)).abs()[flips]
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
# template argument, how to read each, and how many instantiations it has
# (f32 and bf16 forms).
ELEMENT_TYPE = r"(f|13__nv_bfloat16)"


def element_type(mangled: str) -> str:
    return "f32" if mangled == "f" else "bf16"


PTXAS_KERNELS = {
    "norm_forward_kernel": (r"norm_forward_kernelI" + ELEMENT_TYPE
                            + r"Li(\d+)ELb([01])E",
                            (("type", element_type), ("vec", int),
                             ("pad", int)), 6),
    "norm_act_pad_kernel": (r"norm_act_pad_kernelI" + ELEMENT_TYPE
                            + r"Li(\d+)EE",
                            (("type", element_type), ("vec", int)), 3),
    "norm_backward_kernel": (r"norm_backward_kernelI" + ELEMENT_TYPE
                             + r"Lb([01])ELb([01])ELi(\d+)E",
                             (("type", element_type), ("fold", int),
                              ("mask", int), ("vec", int)), 9),
    "upsample_mma_kernel": (r"upsample_mma_kernelI(ff|fa|13__nv_bfloat16S2_)"
                            r"Lb([01])E",
                            (("weights", lambda t: {"ff": "f32", "fa": "int8"}
                              .get(t, "bf16")),
                             ("vec", lambda b: 4 if b == "1" else 1)), 5),
}


def backward_plan_of(case, args) -> dict:
    """The launch plan the backward wrapper takes for these inputs, and how
    many of its clusters the card holds at once."""
    import dataclasses

    from cyclegan_tpu_torch.ops.cuda import build
    from cyclegan_tpu_torch.ops.cuda.norm_kernel import launch_backward_plan

    k2 = base_name(case["kernel"]) == "instance_norm_backward"
    x, g = args[0], args[-1] if k2 else args[5]
    plan = launch_backward_plan(x, g, x)
    active = build.library().cg_norm_backward_active_clusters(
        int(bool(case.get("pad"))), int(not k2), plan.vec, plan.cluster,
        plan.smem_bytes, plan.esize)
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


def backward_per_step(rows, suffix: str = "") -> dict:
    """For K2 and K4 (``suffix`` "_bf16": their bf16 forms), the sum over
    one batch-1 train step's calls (calls x median time) of the kernel's,
    the library's, the plain version's and the bound's times, in ms."""
    names = [name + suffix for name in BACKWARD_KERNELS]
    out = {}
    for name in names:
        path = [r for r in rows if r["kernel"] == name and r["calls"]]
        out[name] = {k: sum(r[k] * r["calls"] for r in path)
                     for k in ("ms", "library_ms", "plain_ms", "bound_ms")}
    out["both"] = {k: sum(out[n][k] for n in names) for k in out[names[0]]}
    return out


# The route of each upsample kernel's products on the tensor cores.
UPSAMPLE_ROUTE = {"upsample": "split TF32, 3 passes",
                  "upsample_int8": "split TF32, 2 passes",
                  "upsample_bf16": "bf16, 1 pass"}


def upsample_bounds(case) -> dict:
    """The two bounds of an upsample case, in ms: f32 FMAs for every
    operation, and the GEMM's products on the tensor cores (UPSAMPLE_PASSES
    passes at UPSAMPLE_RATE: split TF32, or bf16) with the norm tail's
    operations in f32; each the larger of its operations time and the
    bytes time."""
    t_bytes = case["bytes"] / HBM_BYTES_PER_S * 1e3
    tail_ops = case["ops"] - case["gemm_ops"]
    t_f32 = case["ops"] / F32_FLOP_PER_S * 1e3
    t_tc = max(case["gemm_ops"] * UPSAMPLE_PASSES[case["kernel"]]
               / UPSAMPLE_RATE[case["kernel"]], tail_ops / F32_FLOP_PER_S) * 1e3
    return dict(f32_fma_ms=max(t_bytes, t_f32),
                tensor_core_ms=max(t_bytes, t_tc),
                bytes_ms=t_bytes, f32_ops_ms=t_f32, tensor_core_ops_ms=t_tc)


# The port's kernels, as the profiler names them: demangled, or (some
# records come back so) mangled, whose template arguments are read here.
PORT_KERNELS_MANGLED = re.compile(
    r"(norm_forward_kernel|norm_backward_kernel|norm_act_pad_kernel|"
    r"upsample_mma_kernel)I((?:f|a|13__nv_bfloat16|S\d*_|L[ib]\d+E)+)E")
MANGLED_ARGS = {"f": "float", "a": "signed char",
                "13__nv_bfloat16": "__nv_bfloat16"}


def kernel_name(name: str) -> str:
    """A device operation's short name: a kernel's name with its template
    arguments, as demangled (``norm_forward_kernel<float, 4, false>``),
    also where the profiler gave the record its mangled name."""
    m = PORT_KERNELS_MANGLED.search(name)
    if m:
        args = []
        for t in re.findall(r"f|a|13__nv_bfloat16|S\d*_|L[ib]\d+E",
                            m.group(2)):
            if t.startswith("S"):  # a repeated type: the element type
                args.append(args[0])
            elif t.startswith("Lb"):
                args.append("true" if t[2:-1] == "1" else "false")
            elif t.startswith("Li"):
                args.append(t[2:-1])
            else:
                args.append(MANGLED_ARGS[t])
        return f"{m.group(1)}<{', '.join(args)}>"
    m = re.search(r"\w+_kernel(<[^>]*>)?", name)
    return m.group(0) if m else name[:40]


# The markers that close the calls of one profiled window, in order: fills
# of 1-element tensors of types the port never fills, each matched in its
# demangled and its mangled form.
MARKERS = (("int16", re.compile(r"FillFunctor(<short>|IsE)")),
           ("complex64", re.compile(
               r"FillFunctor(<c10::complex<float>\s*>|IN3c107complexIfEE)")),
           ("complex128", re.compile(
               r"FillFunctor(<c10::complex<double>\s*>|IN3c107complexIdEE)")))


def marker_of(name: str):
    """The index in MARKERS of the marker a device record is, or None."""
    for i, (_, pattern) in enumerate(MARKERS):
        if pattern.search(name):
            return i
    return None


def calls_read(names: list[str]) -> list[list[str]]:
    """The short names of each call's device records in one profiled
    window, given its records' names in time order: one list for each
    call whose marker and the marker before it (or the window's start)
    both came back. Records after the last marker are the tail."""
    calls, current, last = [], [], -1
    for name in names:
        i = marker_of(name)
        if i is None:
            current.append(kernel_name(name))
            continue
        if i == last + 1:
            calls.append(current)
        current, last = [], i
    return calls


def device_launches(torch, fn, tries: int = 12, windows: int = 3):
    """Kernels and other device operations one call of ``fn`` puts on the
    card, counted by torch.profiler (CUPTI).

    CUPTI at times hands back a window with no device events at all, or
    with some records of a window lost (both seen on the card with torch
    2.11, most often late in a long run), which would read as too few
    launches. So each profiled window holds one call of ``fn`` for each
    marker of MARKERS, every call closed by its marker (a fill of a type
    the port never fills) and a synchronize, and ends with a tail of
    other fills that absorbs a loss at its end. A call is read only where
    its marker and the marker before it (or the window's start) both came
    back: with a marker of its own type for each call, a lost marker can
    never merge two calls into one. The count is the largest over the
    first ``windows`` calls read, from up to ``tries`` windows: a lost
    record can only lower a call's count, and a ``fn`` that launches
    nothing counts 0 in every call. If no call could be read, the count
    is "not measured". Markers and the tail are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    markers = [torch.empty(1, dtype=getattr(torch, dtype), device="cuda")
               for dtype, _ in MARKERS]
    tail = torch.empty(1, dtype=torch.float32, device="cuda")

    def run():
        for marker in markers:
            fn()
            marker.fill_(1)
            torch.cuda.synchronize()
        for _ in range(4):
            tail.fill_(1)
        torch.cuda.synchronize()

    run()
    counted = []
    for _ in range(tries):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
        except RuntimeError as e:  # the profiler (CUPTI) refused
            return f"not measured ({e})"
        records = sorted((e for e in prof.events()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        counted += calls_read([e.name for e in records])
        if len(counted) >= windows:
            break
    if not counted:
        return (f"not measured (the profiler lost every call's markers in "
                f"all {tries} windows)")
    counted = counted[:windows]
    names = max(counted, key=len)
    seen = sorted({n for window in counted for n in window})
    return dict(count=len(names), names=sorted(set(names)),
                counts={n: names.count(n) for n in sorted(set(names))},
                max_counts={n: max(w.count(n) for w in counted)
                            for n in seen},
                window_counts=[len(n) for n in counted])


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
    """K5 and K6 (or K5's bf16 form) summed over their batch-1 calls (calls
    x median): ms per serving forward (K6: per int8_fused forward) and, for
    K5, per batch-1 train step (6 generator applies, each with both
    upsample blocks)."""
    out = {}
    for name in {r["kernel"] for r in rows} & set(UPSAMPLE_PASSES):
        path = [r for r in rows if r["kernel"] == name and r["calls"]]
        forward = {k: sum(r[k] * r["calls"] for r in path)
                   for k in ("ms", "library_ms", "plain_ms", "bound_ms")}
        out[name] = dict(per_forward=forward)
        if name != "upsample_int8":
            out[name]["per_train_step"] = {k: 6 * v for k, v in forward.items()}
    return out


def upsample_bf16_errors(case, args) -> dict:
    """K5 in bf16 against its plain version: its tail (y, mean, inv)
    against the plain tail over the kernel's own bf16 conv output (a one-ulp
    difference of the conv output moves a normalised value by more than its
    own ulp), its conv output before the bf16 rounding and the plain f32
    sums' against float64 (relative L2), and the elements of its conv
    output and of y that differ from the plain version's."""
    from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
        instance_norm_act_pad_plain,
    )
    from cyclegan_tpu_torch.ops.cuda.upsample_kernel import (
        conv_transpose_zeroskip,
    )

    x, k, s, b, pad = args
    y, mean, inv, conv, conv_f32 = case["kernel_fn"](*args, keep_conv_f32=True)
    tail = instance_norm_act_pad_plain(conv, s, b, pad)
    want = case["plain_fn"](*args, keep_conv=True)
    unrounded = conv_transpose_zeroskip(x.float(), k.float())
    exact = conv_transpose_zeroskip(x.double(), k.double())

    def rel(t):
        return ((t.double() - exact).norm() / exact.norm()).item()
    return dict(
        y_excess=bf16_excess(y, tail[0]),
        stats_err=max((mean - tail[1]).abs().max().item(),
                      (inv - tail[2]).abs().max().item()),
        conv_f32_rel_l2_vs_f64=dict(kernel=rel(conv_f32), plain=rel(unrounded)),
        conv_differing=int((conv != want[3]).sum().item()),
        y_differing=int((y != want[0]).sum().item()), elements=y.numel())


def check_kernels(torch, device, bf16: bool = False, layouts: bool = False):
    """Every kernel (``bf16``: every bf16 form; ``layouts``: the f32 forms
    at the other layouts' and 512^2's shapes) against its plain version on
    the same inputs at each shape of the path, with its times and bounds;
    raises where one disagrees."""
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
    for case in kernel_cases(bf16, layouts):
        name = base_name(case["kernel"])
        args = case["inputs"](gen)
        want = case["plain_fn"](*args)
        got = case["kernel_fn"](*args)
        torch.cuda.synchronize()
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        # Over its tolerance: KERNEL_TOL, or bf16_excess for bf16 outputs.
        excess = max(output_error(g, w)[0] for g, w in zip(got, want))
        library = case["library"](*args)
        lib_err = (to_nhwc(library()).float() - want[0].float()).abs().max().item()
        b_ms, b_by = bound_ms(case["bytes"], case["ops"])
        bounds = upsample_bounds(case) if "gemm_ops" in case else None
        if bounds:
            b_ms = min(bounds["f32_fma_ms"], bounds["tensor_core_ms"])
            b_by = ("bytes" if bounds["bytes_ms"] >= min(
                bounds["f32_ops_ms"], bounds["tensor_core_ops_ms"])
                else "operations")
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
        if bf16 and not case.get("backward"):
            row["y_differing"] = int((got[0] != want[0]).sum().item())
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
            if name == "epilogue_backward":
                row["library_mask_flips"] = mask_flips(case, args, library)
            ok = (row["dx_excess"] <= 1.0
                  and row["reduction_rel_err"] <= REDUCTION_TOL)
            shown = (f"dx err {row['dx_max_abs_err']:.3g} ({row['dx_excess']:.3g} "
                     f"of its tolerance, {row['dx_differing']} elements "
                     f"differ), dscale/dbias "
                     f"{row['reduction_rel_err']:.3g} of the sums; dx vs "
                     f"float64 of the library calls: library "
                     f"{row['library_vs_f64']:.3g}, plain "
                     f"{row['plain_vs_f64']:.3g}; library mask flips "
                     f"{row.get('library_mask_flips')}; plan {row['plan']}")
        elif name in FORWARD_KERNELS:
            row.update(plan=forward_plan_of(case, args),
                       launches_per_call=device_launches(
                           torch, lambda: case["kernel_fn"](*args)),
                       stats_rel_l2_vs_f64=stats_vs_float64(case, args))
            rel = row["stats_rel_l2_vs_f64"]
            launches = row["launches_per_call"]
            ok = (excess <= 1.0
                  and all(v["kernel"] <= CONV_OUT_F64_FACTOR * v["plain"]
                          for v in rel.values())
                  and (case["n"] > 1 or not isinstance(launches, dict)
                       or launches["count"] == 1))
            shown = (f"err {err:.3g} ({excess:.3g} of its tolerance"
                     + (f", {row['y_differing']} elements of y differ"
                        if bf16 else "")
                     + f"); mean and inv rel L2 vs float64: "
                     f"kernel {rel['mean']['kernel']:.3g} and "
                     f"{rel['inv']['kernel']:.3g}, plain "
                     f"{rel['mean']['plain']:.3g} and "
                     f"{rel['inv']['plain']:.3g}; device launches per call "
                     f"{launches}; plan {row['plan']}")
        elif bounds:
            n, h, w, cin = case["shape"]
            plan = upsample_plan(n, h, w, cin, case["cout"],
                                 _sm_count(device.index),
                                 name == "upsample_int8", 2 if bf16 else 4)
            route = (UPSAMPLE_ROUTE[case["kernel"]]
                     if bounds["tensor_core_ms"] <= bounds["f32_fma_ms"]
                     else "f32 FMA")
            row.update(bounds=bounds, bound_route=route,
                       plan=dict(patch=[plan.patch_rows, plan.patch_cols],
                                 tile=plan.tile, depth=plan.depth,
                                 stages=plan.stages, grid=list(plan.grid),
                                 smem_bytes=plan.smem_bytes,
                                 waves=plan.waves),
                       launches_per_call=device_launches(
                           torch, lambda: case["kernel_fn"](*args)))
            if bf16:
                row.update(upsample_bf16_errors(case, args))
                rel = row["conv_f32_rel_l2_vs_f64"]
                ok = (row["y_excess"] <= 1.0
                      and row["stats_err"] <= KERNEL_TOL
                      and rel["kernel"] <= CONV_OUT_F64_FACTOR * rel["plain"])
                shown = (f"y against the plain tail over its own conv "
                         f"output {row['y_excess']:.3g} of its tolerance, "
                         f"mean and inv err {row['stats_err']:.3g}; "
                         f"against the plain version {row['y_differing']} of "
                         f"{row['elements']} elements of y and "
                         f"{row['conv_differing']} of the conv output differ; "
                         f"conv output before rounding rel L2 vs float64: "
                         f"kernel {rel['kernel']:.3g}, plain f32 sums "
                         f"{rel['plain']:.3g}")
            else:
                row["conv_out_rel_l2_vs_f64"] = conv_out_vs_float64(case, args)
                rel = row["conv_out_rel_l2_vs_f64"]
                ok = (err <= KERNEL_TOL and rel["kernel"]
                      <= CONV_OUT_F64_FACTOR * rel["plain"])
                shown = (f"err {err:.3g}; conv_out rel L2 vs float64: kernel "
                         f"{rel['kernel']:.3g}, plain {rel['plain']:.3g}")
            shown += (f"; bounds f32 FMA {bounds['f32_fma_ms']:.4f} ms, "
                      f"{UPSAMPLE_ROUTE[case['kernel']]} on the tensor cores "
                      f"{bounds['tensor_core_ms']:.4f} ms; device launches "
                      f"per call {row['launches_per_call']}; plan "
                      f"{row['plan']}")
        else:
            ok = excess <= 1.0
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
    other, port, spans, annotations = {}, {}, [], 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:  # kernels and copies only
            continue
        # A span on the card's timeline that torch draws for a host
        # annotation (``Optimizer.step#CapturableAdam.step``) covers the
        # kernels it launched; it is not work of its own.
        if getattr(e, "is_user_annotation", False):
            annotations += 1
            continue
        spans.append((e.time_range.start, e.time_range.end))
        ms = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        if any(k in name for k in PORT_KERNEL_NAMES):
            kinds["port kernels"] += ms
            # "void cg::(anonymous namespace)::norm_backward_kernel<false,
            # false, 4>(...)" -> "norm_backward_kernel<false, false, 4>"
            short = kernel_name(e.name)
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
    # Busy: the union of the kernels' and copies' intervals, so that work
    # that overlaps on two streams counts once. Not clamped: a busy time
    # over the window (a clock skew, a span counted that is not work)
    # shows as a negative idle share.
    busy_us, reach = 0.0, None
    for begin, finish in sorted(spans):
        if reach is None or begin > reach:
            busy_us += finish - begin
            reach = finish
        elif finish > reach:
            busy_us += finish - reach
            reach = finish
    if busy_us == 0:
        return {"device_time": "not measured (no device events traced)"}
    top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
    return dict(window_ms_per_run=window_ms / runs,
                **{f"{k}_ms_per_run": v / runs for k, v in kinds.items()},
                busy_ms_per_run=busy_us / 1e3 / runs,
                annotation_spans_left_out=annotations,
                idle_share=1.0 - busy_us / 1e3 / window_ms,
                port_kernels_ms_per_run={k: v / runs for k, v in port.items()},
                top_other={k: v / runs for k, v in top})


def flush_timings(torch, engine, images, iters: int = 10) -> dict:
    """ms per flush and images/s of ``engine`` at buckets 1 and 4, on the
    host's clock over ``iters`` flushes each, the card synchronised."""
    timings = {}
    for bucket in (1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.run(images[:bucket])
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        timings[bucket] = dict(ms_per_flush=elapsed / iters * 1e3,
                               images_per_s=bucket * iters / elapsed)
    return timings


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
    model_cfg = ModelConfig(generator=config, image_size=256, **KERNEL_LAYOUT)
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

    timings = flush_timings(torch, engine, images)
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
    model_cfg = ModelConfig(generator=config, image_size=size,
                            **KERNEL_LAYOUT)
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


def read_stream(path: str) -> list:
    """The events of a telemetry stream (JSONL), in order."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def check_request_trace(event: dict) -> None:
    """A kept request trace: the executor's hops in order, each inside
    the request's interval and starting where the one before ended."""
    names = [s["name"] for s in event["spans"]]
    if names != list(SERVE_HOPS):
        raise AssertionError(f"trace {event['trace_id']} hops {names}")
    t0, t1 = event["t_start"], event["t_end"]
    last = t0
    for span in event["spans"]:
        if not (t0 <= span["t0"] <= span["t1"] <= t1 and span["t0"] >= last):
            raise AssertionError(f"trace {event['trace_id']}: span {span} "
                                 f"outside [{t0}, {t1}] or before {last}")
        last = span["t1"]


def server(torch, engine, name_and_limit):
    import io
    import shutil
    import tempfile
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from cyclegan_tpu_torch.obs import MetricsLogger, Tracer
    from cyclegan_tpu_torch.serve.engine import preprocess_request
    from cyclegan_tpu_torch.serve.executor import PipelinedExecutor
    from cyclegan_tpu_torch.serve.server import (
        _decode_upload,
        _encode_png,
        make_server,
    )
    from cyclegan_tpu_torch.utils.plotting import to_uint8

    size = engine.sizes[-1]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_server_")
    # The server as --obs_jsonl and --trace_sample 1.0 build it.
    stream = os.path.join(tmp, "serve.jsonl")
    logger = MetricsLogger(stream)
    tracer = Tracer(logger, sample=1.0)
    executor = PipelinedExecutor(engine, max_wait_ms=5.0, logger=logger)
    httpd, _ = make_server(executor, "127.0.0.1", 0, tracer=tracer)
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
                ctype, trace_id = r.headers["Content-Type"], r.headers[
                    "X-Trace-Id"]
            return status, ctype, body, time.perf_counter() - t0, trace_id

        # Unloaded: one request at a time, 3 a tier after one to warm up.
        lone = {tier: [post(item) for item in [(tier, plan[1][1])] * 4]
                for tier in TIERS}
        alone = {tier: statistics.median(r[3] for r in replies[1:]) * 1e3
                 for tier, replies in lone.items()}
        # The burst from 4 client threads at trace sample 1.0 and 0, in
        # turns.
        bursts = {1.0: [], 0.0: []}
        rounds = [{1.0: [], 0.0: []} for _ in range(TRACE_ROUNDS)]
        for i, sample in enumerate(TRACE_SAMPLES):
            tracer.sample = sample
            with ThreadPoolExecutor(max_workers=4) as pool:
                replies = list(pool.map(post, plan))
            bursts[sample] += replies
            rounds[i * TRACE_ROUNDS // len(TRACE_SAMPLES)][sample] += replies
        wants = []
        for tier, img in plan:
            x = preprocess_request(img, size)[None]
            (want,), _ = engine.run(x, tier=tier)
            wants.append(to_uint8(want[0].cpu().numpy()))
        worst = 0
        for replies in bursts.values():
            for i, (status, ctype, body, _, _) in enumerate(replies):
                if status != 200 or ctype != "image/png":
                    raise AssertionError(f"{plan[i % len(plan)][0]}: reply "
                                         f"{status} {ctype}")
                got = decode_png(body)
                worst = max(worst, int(np.abs(
                    got.astype(int) - wants[i % len(plan)]).max()))
        if worst > PNG_TOL:
            raise AssertionError(f"a PNG reply differs from the engine's "
                                 f"output by {worst} counts")
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            if r.status != 200:
                raise AssertionError(f"/healthz {r.status}")
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        total = len(TRACE_SAMPLES) * len(plan) + 4 * len(TIERS)
        if (stats["n_requests"] != total or stats["n_errors"]
                or stats["tiers"] != list(TIERS)
                or stats["n_images_done"] != total):
            raise AssertionError(f"/stats {stats}")
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        if f"cyclegan_serve_requests_total {total}" not in metrics:
            raise AssertionError(f"/metrics lacks the request count:\n{metrics}")
        if ('cyclegan_trace_hop_seconds_bucket{hop="device",le="+Inf"}'
                not in metrics):
            raise AssertionError(f"/metrics lacks the hop histograms:\n"
                                 f"{metrics[-3000:]}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        summary = executor.close()
        logger.event("end", status="completed")
        logger.close()
    # Every reply carries its trace id; a traced request has exactly one
    # kept trace with the executor's hops, an untraced one none.
    events = read_stream(stream)
    shutil.rmtree(tmp, ignore_errors=True)
    kept: dict = {}
    for e in events:
        if e["event"] == "trace":
            kept.setdefault(e["trace_id"], []).append(e)
    traced = [r for replies in lone.values() for r in replies] + bursts[1.0]
    for status, _, _, _, trace_id in traced + bursts[0.0]:
        if not re.fullmatch(r"[0-9a-f]{16}", trace_id or ""):
            raise AssertionError(f"a reply's X-Trace-Id is {trace_id!r}")
    for *_, trace_id in traced:
        if len(kept.get(trace_id, [])) != 1:
            raise AssertionError(f"trace {trace_id}: {kept.get(trace_id)}")
        check_request_trace(kept[trace_id][0])
    untraced = [r[4] for r in bursts[0.0] if r[4] in kept]
    if untraced or len(kept) != len(traced):
        raise AssertionError(f"{len(kept)} kept traces for {len(traced)} "
                             f"traced requests; untraced ones kept "
                             f"{untraced}")
    kinds = [e["event"] for e in events]
    if kinds.count("serve_flush") != summary["n_flushes"] or kinds[-2:] != [
            "serve_summary", "end"]:
        raise AssertionError(f"the server's stream: {kinds[-5:]}, "
                             f"{kinds.count('serve_flush')} flushes of "
                             f"{summary['n_flushes']}")
    hop_ms = {}
    for *_, trace_id in bursts[1.0]:
        for span in kept[trace_id][0]["spans"]:
            hop_ms.setdefault(span["name"], []).append(
                (span["t1"] - span["t0"]) * 1e3)
    hop_ms = {k: statistics.median(v) for k, v in hop_ms.items()}
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

    def quantiles(replies):
        lat = sorted(r[3] for r in replies)
        return (lat[len(lat) // 2] * 1e3,
                lat[min(len(lat) - 1, round(0.95 * (len(lat) - 1)))] * 1e3)

    p50, p95 = quantiles(bursts[0.0])
    traced_p50, traced_p95 = quantiles(bursts[1.0])
    # Each round's p50/p95 at sample 0 and 1.0: how far the pooled
    # readings would move with a round more or less.
    by_round = {str(sample): [quantiles(r[sample]) for r in rounds]
                for sample in (0.0, 1.0)}
    # The median over rounds of sample 1.0's p50 and p95 over sample 0's.
    round_ratios = [statistics.median(
        traced[i] / plain[i]
        for traced, plain in zip(by_round["1.0"], by_round["0.0"]))
        for i in (0, 1)]
    row = dict(requests=total, worst_png_counts=worst,
               unloaded_ms=alone, host_stages=stages,
               latency_p50_ms=p50, latency_p95_ms=p95,
               traced_latency_p50_ms=traced_p50,
               traced_latency_p95_ms=traced_p95,
               latency_p50_p95_ms_by_round=by_round,
               traced_over_plain_p50_p95_median_of_rounds=round_ratios,
               kept_traces=len(kept), traced_hop_median_ms=hop_ms,
               n_flushes=summary["n_flushes"],
               max_queue_depth=summary["max_queue_depth"])
    log(f"server on {name_and_limit}: {len(TRACE_SAMPLES)} bursts of "
        f"{len(plan)} .npy uploads over {TIERS} from 4 client threads at "
        f"trace sample {TRACE_SAMPLES} in turns, all 200 with an "
        f"X-Trace-Id, PNGs within {worst} count of the engine; request "
        f"latency at sample 0 p50 {p50:.1f} ms, p95 {p95:.1f} ms; at sample "
        f"1.0 p50 {traced_p50:.1f} ms, p95 {traced_p95:.1f} ms; (p50, p95) "
        f"ms by round of four bursts {json.dumps(by_round)}, the median "
        f"over rounds of sample 1.0's over sample 0's {round_ratios}; "
        f"{len(kept)} "
        f"kept traces, one for each traced request, hops {SERVE_HOPS} in "
        f"order (median ms at sample 1.0 {json.dumps(hop_ms)}); "
        f"{summary['n_flushes']} flushes; one request alone "
        f"{json.dumps(alone)} ms; host stages of one request "
        f"{json.dumps(stages)}")
    return row


def train_launches_per_step(config) -> dict:
    """Launches of each kernel in one train step (one grad fn call), from
    its structure: each generator runs 3 times (the fake, the cycle, the
    identity), every run backpropagated once. With grad_impl "combined"
    each discriminator runs 3 times (the adversarial site with its weights
    detached, the real image, the detached fake), each backpropagated
    once; with "fusedprop" twice (the fake, the real image), the fake's
    graph backpropagated twice (input side, then weights): 4 forwards and
    6 backwards of a discriminator in both cases but the forward count. A
    generator apply has 1 + down + residual instance-norm sites (K1
    forward, K2 backward), residual epilogue sites (K3, K4) and up
    upsample sites (K5, whose backward is a K4 over its transposed conv's
    output); a discriminator apply has one epilogue site (K3, K4) per
    downsampling block. Under bf16 compute the bf16 forms make them."""
    g, d = config.model.generator, config.model.discriminator
    norm_sites = 1 + g.num_downsampling_blocks + g.num_residual_blocks
    d_forwards = 4 if config.train.grad_impl == "fusedprop" else 6
    counts = dict(
        instance_norm=6 * norm_sites,
        instance_norm_backward=6 * norm_sites,
        epilogue=6 * g.num_residual_blocks + d_forwards * d.num_downsampling,
        epilogue_backward=6 * (g.num_residual_blocks + g.num_upsample_blocks
                               + d.num_downsampling),
        upsample=6 * g.num_upsample_blocks)
    if config.model.compute_dtype == "bfloat16":
        return in_bf16(counts)
    return all_launches(**counts)


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
    m = config.model
    trunk = dict(trunk_impl=m.trunk_impl, scan_blocks=m.scan_blocks)
    for i, net in enumerate(state.networks):
        net.load_state_dict(
            generator_state_from_flax(signal_flax_params(
                m.generator, seed + i, **trunk)) if i < 2
            else discriminator_state_from_flax(
                signal_discriminator_flax_params(m.discriminator, seed + i)))
    return state


@contextlib.contextmanager
def float64_reference(state):
    """The state's four networks in float64 and without a compute dtype
    (their bf16 casts off), restored on leaving: the reference a train
    step is held against."""
    cast = [m for net in state.networks for m in net.modules()
            if getattr(m, "dtype", None) is not None]
    dtypes = [m.dtype for m in cast]
    for m in cast:
        m.dtype = None
    for net in state.networks:
        net.double()
    try:
        yield
    finally:
        for net in state.networks:
            net.float()
        for m, dtype in zip(cast, dtypes):
            m.dtype = dtype


def one_ulp_moved(torch, t, seed):
    """``t`` with each element moved by one f32 ulp, up or down at random
    (seeded)."""
    gen = torch.Generator(device=t.device).manual_seed(SEED + seed)
    up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
    return torch.where(up, torch.nextafter(t, torch.full_like(t, float("inf"))),
                       torch.nextafter(t, torch.full_like(t, float("-inf"))))


def compare_train_step(torch, grad_fn, state, x, y, w, label, per_step,
                       kept=None, check=True, plain_floor=None, bf16=False):
    """One step's ten losses and four gradient trees on the kernels against
    the same step through the plain versions, in the step's compute dtype
    and in float64, from the same state; the plain step's distance from
    float64 is the largest of its run on these images and its runs on
    them moved by one ulp (REACH_PERTURBATIONS). ``kept``, a dict, receives the
    kernels' gradients, the losses, each leaf's errors and its tolerance,
    for ``hold_grads`` and ``check_train_step``. ``check=False`` measures
    without holding; ``plain_floor`` and ``bf16`` (the step computes in
    bf16) are passed on to ``check_train_step``."""
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
        with float64_reference(state):
            exact_grads, exact = grad_fn(state, x.double(), y.double(),
                                         w.double())
        # The plain step's distance from float64 on the images moved by one
        # ulp, REACH_PERTURBATIONS times: the spread of f32 rounding.
        spread = {}
        for r in range(REACH_PERTURBATIONS):
            moved_grads, moved = grad_fn(state, one_ulp_moved(torch, x, r),
                                         one_ulp_moved(torch, y, r), w)
            for k, v in exact.items():
                spread[k] = max(spread.get(k, 0.0),
                                abs(moved[k].item() - v.item()))
            for net, theirs, exact_net in zip(("G", "F", "D_X", "D_Y"),
                                              moved_grads, exact_grads):
                for key, value in exact_net.items():
                    spread[net, key] = max(spread.get((net, key), 0.0),
                                           rel(theirs[key], value))
            del moved_grads
    scalar_err = max(abs(metrics[k].item() - plain[k].item())
                     / max(abs(plain[k].item()), 1e-12) for k in plain)
    losses = {k: dict(kernels_vs_f64=abs(metrics[k].item() - v.item()),
                      plain_vs_f64=max(abs(plain[k].item() - v.item()),
                                       spread.get(k, 0.0)),
                      f64=v.item()) for k, v in exact.items()}
    errors = {}
    for net, ours, theirs, exact_net in zip(("G", "F", "D_X", "D_Y"), grads,
                                            plain_grads, exact_grads):
        for key, value in exact_net.items():
            errors[net, key] = dict(
                kernels_vs_plain=rel(ours[key], theirs[key]),
                kernels_vs_f64=rel(ours[key], value),
                plain_vs_f64=max(rel(theirs[key], value),
                                 spread.get((net, key), 0.0)))
    result = dict(scalar_err=scalar_err, errors=errors, losses=losses,
                  loss_g=plain["loss_G/loss"].item())
    summary, leaf_tol = check_train_step(result, label, plain_floor, check,
                                         bf16)
    if kept is not None:
        kept.update(result, grads=grads, metrics=metrics, leaf_tol=leaf_tol)
    return summary


def check_train_step(result, label, plain_floor=None, check=True,
                     bf16=False):
    """Hold ``compare_train_step``'s errors: the losses within
    TRAIN_SCALAR_RTOL of the plain path's, and each gradient leaf's
    distance from float64 within TRAIN_GRAD_RTOL plus twice the plain f32
    step's own distance on that leaf; a bf16 step (``bf16``) each loss's
    and leaf's distance from float64 within BF16_RTOL (relative) plus
    twice the plain bf16 step's. ``plain_floor`` (leaf,
    or loss key, -> distance) is the largest plain distance of the same
    computation over several draws of its inputs; the larger of it and
    this run's is taken as what the plain step reaches. Returns (summary,
    leaf -> tolerance)."""
    plain_floor = plain_floor or {}
    grad_rtol = BF16_RTOL if bf16 else TRAIN_GRAD_RTOL
    worst = dict(kernels_vs_plain=0.0, kernels_vs_f64=0.0, plain_vs_f64=0.0,
                 share_of_tolerance=0.0, leaf=None)
    leaf_tol = {}
    for leaf, errs in result["errors"].items():
        leaf_tol[leaf] = grad_rtol + 2 * max(
            errs["plain_vs_f64"], plain_floor.get(leaf, 0.0))
        share = errs["kernels_vs_f64"] / leaf_tol[leaf]
        for k, v in errs.items():
            worst[k] = max(worst[k], v)
        if not share <= worst["share_of_tolerance"]:
            worst.update(share_of_tolerance=share, leaf=" ".join(leaf))
    scalar_err = result["scalar_err"]
    if bf16:
        # Each loss's distance from float64 over its tolerance.
        scalar_err = max(
            v["kernels_vs_f64"] / (BF16_RTOL * abs(v["f64"]) + 2 * max(
                v["plain_vs_f64"], plain_floor.get(k, 0.0)))
            for k, v in result["losses"].items())
    log(f"train step, {label} weights: losses kernels vs "
        + (f"float64 at {scalar_err:.3g} of their tolerance" if bf16 else
           f"plain rel err {scalar_err:.3g}")
        + f" (loss_G/loss {result['loss_g']:.4f}); "
        f"gradient leaves, max rel L2 err: kernels vs plain "
        f"{worst['kernels_vs_plain']:.3g}, kernels vs f64 "
        f"{worst['kernels_vs_f64']:.3g}, plain {'bf16' if bf16 else 'f32'} "
        f"vs f64 {worst['plain_vs_f64']:.3g}; worst leaf {worst['leaf']} at "
        f"{worst['share_of_tolerance']:.3g} of its tolerance"
        + (" (plain reach: the largest over the draws and their one-ulp "
           "moves)" if plain_floor else " (plain reach: the largest over "
           "the images and their one-ulp moves)")
        + ("" if check else " (not held here)"))
    if check and not ((scalar_err <= 1.0 if bf16
                       else scalar_err <= TRAIN_SCALAR_RTOL)
                      and worst["share_of_tolerance"] <= 1.0):
        raise AssertionError(f"{label}: train step differs from the plain "
                             f"path: losses {scalar_err}, gradients {worst}")
    return dict(losses_rel_err=scalar_err, grads=worst), leaf_tol


def hold_over_draws(torch, grad_fn, state, draws, w, label, per_step,
                    bf16=False):
    """``compare_train_step`` over each draw of the images (x, y) in
    ``draws``, measured first, then each held with what the plain step
    reaches on a leaf (and a loss) taken as its largest distance from
    float64 over the draws. Returns (summaries, kept) by draw."""
    kept = []
    for i, (x, y) in enumerate(draws):
        kept.append({})
        compare_train_step(torch, grad_fn, state, x, y, w,
                           f"{label}, draw {i}", per_step, kept[-1],
                           check=False, bf16=bf16)
    reach = {leaf: max(k["errors"][leaf]["plain_vs_f64"] for k in kept)
             for leaf in kept[0]["errors"]}
    reach.update({key: max(k["losses"][key]["plain_vs_f64"] for k in kept)
                  for key in kept[0]["losses"]})
    summaries = []
    for i, k in enumerate(kept):
        summary, k["leaf_tol"] = check_train_step(k, f"{label}, draw {i}",
                                                  reach, bf16=bf16)
        summaries.append(summary)
    return summaries, kept


def hold_grads(torch, ours, theirs, leaf_tol, label):
    """Two f32 gradient sets of the same step on the kernels (another
    engine, or microbatches against one batch), leaf by leaf by relative L2
    within the tolerance ``compare_train_step`` gave each leaf: 1e-3 plus
    twice the plain f32 step's own distance from float64."""
    worst = dict(rel_err=0.0, share_of_tolerance=0.0, leaf=None)
    for net, a, b in zip(("G", "F", "D_X", "D_Y"), ours, theirs):
        for key in b:
            err = ((a[key].double() - b[key].double()).norm()
                   / b[key].double().norm()).item()
            share = err / leaf_tol[net, key]
            worst["rel_err"] = max(worst["rel_err"], err)
            if not share <= worst["share_of_tolerance"]:
                worst.update(share_of_tolerance=share, leaf=f"{net} {key}")
    log(f"{label}: gradient leaves, max rel L2 err {worst['rel_err']:.3g}; "
        f"worst leaf {worst['leaf']} at {worst['share_of_tolerance']:.3g} of "
        f"its tolerance")
    if not worst["share_of_tolerance"] <= 1.0:
        raise AssertionError(f"{label}: gradients differ: {worst}")
    return worst


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


def timed_steps(torch, train_step, state, data, w):
    """The main path of a train phase: a step on each (x, y) of ``data``,
    the launch counts and the peak memory from 0 just before. Returns
    (state, ms of each step on the host's clock, each step's ten losses,
    launches, peak bytes)."""
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.train.steps import METRIC_KEYS

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
    return (state, step_ms, losses, dict(LAUNCHES),
            torch.cuda.max_memory_allocated())


def train(torch, device, name_and_limit):
    import numpy as np

    from cyclegan_tpu_torch.config import Config, ModelConfig
    from cyclegan_tpu_torch.data.augment import normalize_image
    from cyclegan_tpu_torch.data.sources import SyntheticSource
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.train.steps import make_grad_fn, make_train_step

    # Full width, 256^2, f32, batch 1, in the kernel layout.
    config = Config(model=ModelConfig(**KERNEL_LAYOUT))
    batch = config.train.batch_size
    source = SyntheticSource(image_size=config.model.image_size)

    def images(split, index):
        return torch.from_numpy(normalize_image(
            source.load(split, index))[None]).to(device)

    per_step = train_launches_per_step(config)
    w = torch.ones(batch, device=device)
    draws = [(images("trainA", i), images("trainB", i))
             for i in range(REACH_DRAWS)]
    grad_fn = make_grad_fn(config, batch)
    checks = {}
    for label, state in (("init", create_state(config, SEED, device)),
                         ("signal", signal_state(config, SEED + 10, device))):
        if label == "init":  # warm-up: cuDNN's first calls
            grad_fn(state, *draws[0], w)
            torch.cuda.synchronize()
        checks[label] = hold_over_draws(torch, grad_fn, state, draws, w,
                                        label, per_step)[0]
        del state

    # The main path: TRAIN_STEPS steps on the kernels from the init weights.
    state = create_state(config, SEED, device)
    train_step = make_train_step(config, batch)
    data = [(images("trainA", i), images("trainB", i))
            for i in range(TRAIN_STEPS)]
    state, step_ms, losses, launches, peak_bytes = timed_steps(
        torch, train_step, state, data, w)
    x, y = data[-1]
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


def train_options(torch, device, name_and_limit):
    """The train step's options at full width, 256^2, on the kernels (the
    phase's main path: 10 fusedprop steps, counted from 0)."""
    import numpy as np

    from cyclegan_tpu_torch.config import (
        Config,
        ModelConfig,
        ObsConfig,
        TrainConfig,
    )
    from cyclegan_tpu_torch.data.augment import normalize_image
    from cyclegan_tpu_torch.data.sources import SyntheticSource
    from cyclegan_tpu_torch.obs.health import HealthFault, HealthMonitor
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.train.steps import (
        make_accum_grad_fn,
        make_accum_train_step,
        make_grad_fn,
        make_train_step,
    )

    def configured(grad_impl="combined", batch=1, accum=1, health=False):
        return Config(model=ModelConfig(**KERNEL_LAYOUT),
                      train=TrainConfig(batch_size=batch, grad_impl=grad_impl,
                                        grad_accum=accum),
                      obs=ObsConfig(health=health))

    combined, fused = configured(), configured("fusedprop")
    per_step = train_launches_per_step(combined)
    per_fused = train_launches_per_step(fused)
    source = SyntheticSource(image_size=combined.model.image_size)

    def images(split, indices):
        return torch.from_numpy(np.stack([normalize_image(source.load(
            split, i)) for i in indices])).to(device)

    x, y = images("trainA", [0]), images("trainB", [0])
    w = torch.ones(1, device=device)
    checks = {}
    # FusedProp: against its own plain and float64 runs over REACH_DRAWS
    # draws of the images (the train phase's rule), and against the
    # combined grad fn on the kernels on the first draw, at the init and
    # signal weights.
    draws = [(images("trainA", [i]), images("trainB", [i]))
             for i in range(REACH_DRAWS)]
    for label in ("init", "signal"):
        state = (create_state(combined, SEED, device) if label == "init"
                 else signal_state(combined, SEED + 10, device))
        if label == "init":  # warm-up: the fused graph's first calls
            make_grad_fn(fused, 1)(state, x, y, w)
            torch.cuda.synchronize()
        checks[f"fusedprop, {label}"], runs_ = hold_over_draws(
            torch, make_grad_fn(fused, 1), state, draws, w,
            f"fusedprop, {label}", per_fused)
        kept = runs_[0]
        combined_grads, combined_metrics = make_grad_fn(combined, 1)(
            state, x, y, w)
        losses = max(abs(kept["metrics"][k].item() - v.item())
                     / max(abs(v.item()), 1e-12)
                     for k, v in combined_metrics.items())
        if not losses <= TRAIN_SCALAR_RTOL:
            raise AssertionError(f"fusedprop's losses differ from combined's "
                                 f"by {losses}")
        checks[f"fusedprop vs combined, {label}"] = dict(
            losses_rel_err=losses, grads=hold_grads(
                torch, kept["grads"], combined_grads, kept["leaf_tol"],
                f"fusedprop vs combined on the kernels, {label} weights"))
        del state, kept, runs_, combined_grads

    # Accumulation: two microbatches of 1 against one batch of 2, each
    # against float64, over REACH_DRAWS draws of the two images; then the
    # first draw's two microbatch steps alone, and one whole step of each
    # for its peak memory.
    accum, batch2 = configured(accum=2), configured(batch=2)
    state = signal_state(combined, SEED + 10, device)
    w2 = torch.ones(2, device=device)
    computations = {
        "accumulated 2 x 1": (make_accum_grad_fn(accum, 2, 2),
                              {k: 2 * v for k, v in per_step.items()}),
        "one batch of 2": (make_grad_fn(batch2, 2), per_step)}
    # What f32 reaches on a leaf of one computation: the largest distance
    # from float64 of its plain f32 runs over the draws.
    draws = [(images("trainA", [1 + 2 * d, 2 + 2 * d]),
              images("trainB", [1 + 2 * d, 2 + 2 * d]))
             for d in range(REACH_DRAWS)]
    kept, readings = {}, {}
    for label, (fn, launches) in computations.items():
        summaries, kept[label] = hold_over_draws(
            torch, fn, state, draws, w2, f"{label}, signal", launches)
        for draw, summary in enumerate(summaries):
            checks[f"{label}, draw {draw}"] = summary
        readings[label] = [
            {leaf: dict(kernels_vs_f64=k["errors"][leaf]["kernels_vs_f64"],
                        plain_vs_f64=k["errors"][leaf]["plain_vs_f64"],
                        share_of_tolerance=k["errors"][leaf]["kernels_vs_f64"]
                        / k["leaf_tol"][leaf])
             for leaf in ACCUM_WATCHED_LEAVES} for k in kept[label]]
    for draw in range(REACH_DRAWS):
        checks[f"accumulated vs one batch, draw {draw}"] = hold_grads(
            torch, kept["accumulated 2 x 1"][draw]["grads"],
            kept["one batch of 2"][draw]["grads"],
            kept["one batch of 2"][draw]["leaf_tol"],
            f"accumulated 2 x 1 vs one batch of 2, draw {draw}")
    # The first draw's microbatches as two batch-1 steps: their errors, and
    # their sum against the accumulated step (the accumulation's own adds).
    micro = []
    x2, y2 = draws[0]
    for i in range(2):
        micro.append({})
        compare_train_step(torch, make_grad_fn(accum, 2), state,
                           x2[i:i + 1], y2[i:i + 1], w2[i:i + 1],
                           f"microbatch {i} of draw 0, signal", per_step,
                           micro[-1], check=False)
    summed = tuple(dict(zip(a, torch._foreach_add(list(a.values()),
                                                  [b[n] for n in a])))
                   for a, b in zip(micro[0]["grads"], micro[1]["grads"]))
    sum_gap = max(
        ((a[n].double() - b[n].double()).norm() / b[n].double().norm()).item()
        for a, b in zip(kept["accumulated 2 x 1"][0]["grads"], summed)
        for n in b)
    readings["microbatches of draw 0"] = [
        {leaf: {k: m["errors"][leaf][k] for k in ("kernels_vs_f64",
                                                  "plain_vs_f64")}
         for leaf in ACCUM_WATCHED_LEAVES} for m in micro]
    readings = {k: [{" ".join(leaf): e for leaf, e in r.items()} for r in v]
                for k, v in readings.items()}
    log(f"accumulation, relative L2 from float64 at the watched leaves by "
        f"draw: {json.dumps(readings)}; accumulated 2 x 1 vs the sum of its "
        f"two batch-1 steps on the kernels: max rel L2 {sum_gap:.3g}")
    checks["accumulation readings"] = readings
    checks["accumulated vs its microbatch sum"] = sum_gap
    del kept, micro, summed
    peak = {}
    for label, step in (("accumulated 2 x 1", make_accum_train_step(accum, 2,
                                                                    2)),
                        ("one batch of 2", make_train_step(batch2, 2))):
        step(state, x2, y2, w2)  # warm-up at this batch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step(state, x2, y2, w2)
        torch.cuda.synchronize()
        peak[label] = torch.cuda.max_memory_allocated()
    log(f"peak memory of one step on {name_and_limit}: "
        + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in peak.items()))
    del state

    # OPTIONS_ROUNDS rounds of one step each of combined and fusedprop,
    # health off and on, in turns from one state, so that a drift of the
    # card's pace reaches all four alike. The phase's main path, counted
    # from 0.
    state = create_state(combined, SEED, device)
    data = [(images("trainA", [i]), images("trainB", [i]))
            for i in range(OPTIONS_ROUNDS)]
    variants = {}
    for grad_impl in ("combined", "fusedprop"):
        for health in (False, True):
            label = f"{grad_impl}, health {'on' if health else 'off'}"
            variants[label] = dict(
                step=make_train_step(configured(grad_impl, health=health), 1),
                per_step=per_fused if grad_impl == "fusedprop" else per_step,
                health=health, step_ms=[], rows=[], peak=0,
                launches={k: 0 for k in per_step})
    for v in variants.values():  # warm-up
        state, _ = v["step"](state, x, y, w)
    torch.cuda.synchronize()
    reset_launches()
    for xi, yi in data:
        for v in variants.values():
            before = dict(LAUNCHES)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = v["step"](state, xi, yi, w)
            torch.cuda.synchronize()
            v["step_ms"].append((time.perf_counter() - t0) * 1e3)
            v["peak"] = max(v["peak"], torch.cuda.max_memory_allocated())
            v["rows"].append(metrics)
            for k in v["launches"]:
                v["launches"][k] += LAUNCHES[k] - before[k]
    main_launches = dict(LAUNCHES)
    runs = {}
    for label, v in variants.items():
        want = {k: OPTIONS_ROUNDS * n for k, n in v["per_step"].items()}
        if v["launches"] != want:
            raise AssertionError(f"{label}: launches {v['launches']}, "
                                 f"expected {want}")
        rows = [{k: t.item() for k, t in m.items()} for m in v["rows"]]
        if not all(np.isfinite(t) for m in rows for t in m.values()):
            raise AssertionError(f"{label}: a non-finite metric")
        nonfinite = (max(m["health/nonfinite"] for m in rows)
                     if v["health"] else None)
        if v["health"] and nonfinite != 0:
            raise AssertionError(f"{label}: health/nonfinite {nonfinite} "
                                 "on clean data")
        median = statistics.median(v["step_ms"][2:])
        runs[label] = dict(
            ms_per_step=median, step_ms=v["step_ms"], peak_bytes=v["peak"],
            launches_per_step={k: n // OPTIONS_ROUNDS
                               for k, n in v["launches"].items()},
            launches=v["launches"], nonfinite_max=nonfinite,
            health_last={k: t for k, t in rows[-1].items()
                         if k.startswith("health/")} or None)
        log(f"train 256^2 f32 batch 1, {label}, on {name_and_limit}: "
            f"{median:.2f} ms per step (median of the last "
            f"{OPTIONS_ROUNDS - 2} of {OPTIONS_ROUNDS}, the four variants in "
            f"turns; all: {', '.join(f'{t:.2f}' for t in v['step_ms'])}), "
            f"peak memory {v['peak'] / 2**20:.1f} MiB, launches per step "
            f"{runs[label]['launches_per_step']}")
    del variants
    device_costs = options_device_costs(torch, state, x, y, w, configured,
                                        name_and_limit)

    # A batch multiplied by NaN: the step's count sees it, and the monitor
    # halts on that row.
    nan = float("nan")
    state, metrics = make_train_step(configured(health=True), 1)(
        state, x * nan, y * nan, w)
    row = {k: v.item() for k, v in metrics.items()}
    if not row["health/nonfinite"] > 0:
        raise AssertionError(f"a NaN batch gave health/nonfinite "
                             f"{row['health/nonfinite']}")
    try:
        HealthMonitor(on_nan="halt").observe(row)
    except HealthFault as fault:
        halted = f"{fault.kind}: {fault}"
    else:
        raise AssertionError("HealthMonitor(on_nan='halt') did not halt on "
                             "the NaN batch's row")
    log(f"NaN batch: health/nonfinite {row['health/nonfinite']:.0f}; the "
        f"monitor halted ({halted})")
    del state
    return (runs["fusedprop, health off"]["launches"],
            dict(checks=checks, peak_bytes=peak, runs=runs,
                 device_costs=device_costs,
                 main_path_launches=main_launches,
                 nan_nonfinite=row["health/nonfinite"]))


def options_device_costs(torch, state, x, y, w, configured, name_and_limit
                         ) -> dict:
    """Two parts of a step, each run alone on this step's tensors: the
    health metrics' work (the copy of the old weights and
    ``finalize_health_metrics``; the D moments in the grad fn are a few
    reductions over 900 outputs and are left out), and FusedProp's
    input-side pull (the adversarial cotangents at the two fakes through
    the discriminators' retained graphs), whose K4 calls also reduce
    dscale and dbias that nobody reads: their device time bounds what
    skipping that reduction could save. For each: its busy device time
    from the profiler, the window a call takes back to back (the host's
    pace where that is the larger), and the host's time to enqueue one call
    onto an idle card."""
    from cyclegan_tpu_torch import losses
    from cyclegan_tpu_torch.obs import health
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.train.steps import make_grad_fn

    grads, metrics = make_grad_fn(configured(health=True), 1)(state, x, y, w)

    def finalize():
        old = health.copy_params(state.networks)
        return health.finalize_health_metrics(
            metrics, grads, old, health.param_dicts(state.networks))

    g, f, dx, dy = state.networks
    with torch.no_grad():
        leaves = (g(x).requires_grad_(), f(y).requires_grad_())
    adversarial = (losses.generator_loss(dy(leaves[0]), w, 1.0)
                   + losses.generator_loss(dx(leaves[1]), w, 1.0))

    def pull():
        return torch.autograd.grad(adversarial, leaves, retain_graph=True)

    out = {}
    for label, fn in (("health metrics", finalize), ("input-side pull", pull)):
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        b = device_breakdown(torch, fn, runs=5)
        if "window_ms_per_run" not in b:
            raise AssertionError(f"{label}: no device time: {b}")
        busy = sum(b[f"{k}_ms_per_run"]
                   for k in ("port kernels", "convolutions", "other"))
        out[label] = dict(device_busy_ms=busy,
                          window_ms=b["window_ms_per_run"],
                          host_enqueue_ms=statistics.median(enqueue),
                          port_kernels_ms=b["port kernels_ms_per_run"],
                          top_other=b["top_other"])
    del grads, metrics
    reset_launches()
    pull()
    k4_calls = LAUNCHES["epilogue_backward"]
    out["input-side pull"]["k4_calls"] = k4_calls
    log(f"each part alone on {name_and_limit}, device busy (profiled) / "
        f"window a call back to back / host enqueue of a call, ms: "
        + "; ".join(f"{k} {v['device_busy_ms']:.4f} / {v['window_ms']:.4f} "
                    f"/ {v['host_enqueue_ms']:.4f}" for k, v in out.items())
        + f"; the pull's {k4_calls} K4 calls "
        f"{out['input-side pull']['port_kernels_ms']:.4f} ms of device time")
    if k4_calls != 2 * configured().model.discriminator.num_downsampling:
        raise AssertionError(f"the input-side pull launched K4 {k4_calls} "
                             f"times")
    return out


def run_module(module: str, args: list, timeout: float,
               deterministic: bool = False) -> str:
    """``python -m module args`` from the repo's root in a child process;
    its standard output. Raises with the output's tail when it fails.
    ``deterministic`` runs the module under torch's deterministic
    algorithms, turned on in the child before the module starts."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    command = [sys.executable, "-m", module, *args]
    if deterministic:
        # cuBLAS needs a fixed workspace for them, read at its start.
        env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        command = [sys.executable, "-c", DETERMINISTIC_RUN, module, *args]
    child = subprocess.Popen(command, cwd=root,
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
    generator forwards a pair, at each checkpoint epoch). Under bf16
    compute the bf16 forms make them."""
    import dataclasses

    bf16 = config.model.compute_dtype == "bfloat16"
    per_step = train_launches_per_step(config.replace(
        model=dataclasses.replace(config.model, compute_dtype="float32")))
    d_epilogue = config.model.discriminator.num_downsampling
    out = {}
    for name, per_forward in LAUNCHES_PER_FORWARD.items():
        test = 6 * per_forward + (4 * d_epilogue if name == "epilogue" else 0)
        out[name] = (epochs * (train_steps * per_step[name]
                               + test_steps * test)
                     + checkpoint_epochs * plot_pairs * 4 * per_forward)
    return in_bf16(out) if bf16 else out


def check_cli_stream(torch, path: str, epochs: int, train_dispatches: int,
                     test_dispatches: int) -> dict:
    """The training CLI's default telemetry stream of a run on the card:
    the manifest first, naming the card; one step record a dispatch and
    one epoch_steps a pass, with the loop's counts; a memory watermark
    with the allocator's counters; one goodput rollup an epoch whose
    phases sum to its elapse (the ledger rounds each of its seven phases
    to 1e-6 s); end last, completed. Returns the epochs' goodput phases
    and the train passes' step breakdown."""
    events = read_stream(path)
    kinds = [e["event"] for e in events]
    first, last = events[0], events[-1]
    mesh = first.get("mesh", {})
    if (first["event"] != "manifest" or mesh.get("platform") != "gpu"
            or mesh.get("device_kind") != torch.cuda.get_device_name(0)):
        raise AssertionError(f"{path}: first event {first['event']}, mesh "
                             f"{mesh}")
    if (last["event"], last.get("status")) != ("end", "completed"):
        raise AssertionError(f"{path}: last event {last}")
    for split, n in (("train", train_dispatches), ("test", test_dispatches)):
        steps = [e for e in events if e["event"] == "step"
                 and e["split"] == split]
        passes = [e for e in events if e["event"] == "epoch_steps"
                  and e["split"] == split]
        if (len(steps) != epochs * n or len(passes) != epochs
                or any(p["n_dispatches"] != n or p["n_steps"] != n
                       for p in passes)
                or sorted({e["dispatch"] for e in steps}) != list(range(n))):
            raise AssertionError(f"{path}: {len(steps)} {split} step records "
                                 f"and passes {passes}, expected {epochs} x "
                                 f"{n}")
    memory = [e for e in events if e["event"] == "memory"]
    for e in memory:
        rows = e["devices"]
        if not (e["available"] and rows and all(
                0 < r["peak_bytes_in_use"] <= r["bytes_limit"]
                for r in rows)):
            raise AssertionError(f"{path}: memory event {e}")
    goodput = [e for e in events if e["event"] == "goodput"]
    epoch_events = [e for e in events if e["event"] == "epoch"]
    if (len(memory) != epochs or len(goodput) != epochs
            or len(epoch_events) != epochs):
        raise AssertionError(f"{path}: {len(memory)} memory, {len(goodput)} "
                             f"goodput, {len(epoch_events)} epoch events")
    for e, ep in zip(goodput, epoch_events):
        total = sum(e["phases_s"].values())
        if (e["elapse_s"] != ep["elapse_s"]
                or abs(total - e["elapse_s"]) > GOODPUT_SUM_TOL):
            raise AssertionError(f"{path}: goodput phases sum to {total} "
                                 f"against the epoch's {ep['elapse_s']} s: "
                                 f"{e}")
    train = [e for e in events if e["event"] == "step"
             and e["split"] == "train"]
    breakdown = {key: statistics.mean(e[key] for e in train)
                 for key in STEP_PARTS}
    return dict(events=len(kinds), phases_s=[e["phases_s"] for e in goodput],
                peak_mib=[r["peak_bytes_in_use"] / 2**20 for e in memory
                          for r in e["devices"]],
                train_step_mean_s=breakdown)


def epochs(torch, device, name_and_limit, train_summary):
    import io
    import re
    import shutil
    import tempfile

    import numpy as np

    from cyclegan_tpu_torch import main as train_main
    from cyclegan_tpu_torch.config import Config, ModelConfig
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
            """A run of the CLI: in a child process under torch's
            deterministic algorithms (A and B), or (run C) through its
            ``main`` in this one, in the default mode, where the kernels'
            counts can be read."""
            args = ["--output_dir", runs[name], "--epochs", str(n_epochs),
                    "--ckpt_keep", "2", "--data_source", "folder",
                    "--data_dir", data_dir, "--verbose", "0", "--seed",
                    str(SEED), *KERNEL_FLAGS]
            t0 = time.perf_counter()
            if in_process:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    train_main.main(args)
                torch.cuda.synchronize()
                out = buf.getvalue()
            else:
                out = run_module("cyclegan_tpu_torch.main", args,
                                 timeout=DEADLINES["epochs"],
                                 deterministic=True)
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
        out_c = train("C", 3, in_process=True)
        launches = dict(LAUNCHES)
        want_launches = cli_launches(
            Config(model=ModelConfig(**KERNEL_LAYOUT)), epochs=3,
            train_steps=EPOCHS_TRAIN_IMAGES,
            test_steps=EPOCHS_TEST_IMAGES,
            plot_pairs=min(EPOCHS_TEST_IMAGES, Config().train.plot_samples),
            checkpoint_epochs=2)
        log(f"run C's launches {launches}")
        if launches != want_launches:
            raise AssertionError(f"run C launched {launches}, expected "
                                 f"{want_launches}")
        # Run C's default telemetry stream.
        stream_c = check_cli_stream(
            torch, os.path.join(runs["C"], "telemetry.jsonl"), epochs=3,
            train_dispatches=EPOCHS_TRAIN_IMAGES,
            test_dispatches=EPOCHS_TEST_IMAGES)
        log(f"run C's telemetry stream on {name_and_limit}: "
            f"{json.dumps(stream_c)}")
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
        log(f"epoch means, largest relative gap per epoch: A vs B (both "
            f"under deterministic algorithms, B resumed at epoch index 2) "
            f"{json.dumps(gap_ab)}, bitwise equal: {means['B'] == means['A']}"
            f"; A vs C (C in the default mode, in this process) "
            f"{json.dumps(gap_ac)}")
        if means["B"] != means["A"]:
            raise AssertionError(f"the resumed run's epoch means are not "
                                 f"bitwise the uninterrupted run's: largest "
                                 f"relative gap by epoch {gap_ab}")

        from cyclegan_tpu_torch.utils.summary import read_scalars

        # ms per step: the loop counts a step's two images (X and Y).
        ips = {name: dict(read_scalars(runs[name])[
            "perf/train_images_per_sec"]) for name in "CA"}
        loop_ms = {name: {e: 2e3 / v[e] for e in sorted(v)}
                   for name, v in ips.items()}
        saves = [dict(bytes=int(m.group(1)), seconds=float(m.group(2)))
                 for m in re.finditer(r"saved checkpoint to \S+ \((\d+) bytes "
                                      r"in ([\d.]+) s\)", out_a)]
        log(f"training loop 256^2 f32 batch 1 on {name_and_limit}: ms per "
            f"step by epoch, run C (default mode) {json.dumps(loop_ms['C'])}"
            f", run A (deterministic algorithms) {json.dumps(loop_ms['A'])}"
            f"; train images/s {json.dumps(ips)}; the train phase's bare "
            f"step (default mode) {train_summary['ms_per_step']:.2f} ms; "
            f"checkpoint saves {json.dumps(saves)}")
        if len(saves) != 2:
            raise AssertionError(f"run A saved {saves}")
        # The loop's wait at a checkpoint epoch with the epoch services:
        # A (deterministic algorithms, in a child) and C (default mode, in
        # this process) each had the card and the host to themselves.
        waits = {name: [float(m) for m in re.findall(
            r"the loop waited ([\d.]+) s", out)]
            for name, out in (("A", out_a), ("C", out_c))}
        writes_c = [float(m) for m in re.findall(
            r"saved checkpoint to \S+ \(\d+ bytes in ([\d.]+) s\)", out_c)]
        log(f"checkpoint epochs 0 and 2 with the epoch services on "
            f"{name_and_limit}, each run alone on the card: the loop waited "
            f"(host copies and cycle plots) run A {waits['A']} s, run C "
            f"{waits['C']} s; the worker's writes A "
            f"{[w['seconds'] for w in saves]} s, C {writes_c} s")
        if len(waits["A"]) != 2 or len(waits["C"]) != 2:
            raise AssertionError(f"checkpoint waits {waits}")

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
        transfer_run = run_d(torch, tmp, data_dir, runs["A"], name_and_limit)
        return dict(launches=launches, gap_ac=gap_ac, gap_ab=gap_ab,
                    stream_c=stream_c,
                    loop_ms_per_step=loop_ms, train_images_per_s=ips,
                    bare_step_ms=train_summary["ms_per_step"],
                    checkpoint_saves=saves, translate_max_count_err=worst,
                    transfer_run=transfer_run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_d(torch, tmp, data_dir, parent, name_and_limit):
    """Run D of the epochs phase: one epoch of the CLI from run A's ring
    with the train step's options (encoder-freeze transfer, FusedProp,
    2 accumulated microbatches, the health metrics) on a domain that a
    registry file maps onto the phase's folder."""
    from cyclegan_tpu_torch.config import Config
    from cyclegan_tpu_torch.domains.transfer import is_frozen
    from cyclegan_tpu_torch.utils.checkpoint import Checkpointer
    from cyclegan_tpu_torch.utils.summary import read_scalars

    out_dir = os.path.join(tmp, "D")
    registry = os.path.join(tmp, "domains.json")
    with open(registry, "w") as f:
        json.dump({"domains": [{"key": "npy_pair", "source": "folder",
                                "data_dir": data_dir}]}, f)
    t0 = time.perf_counter()
    out = run_module("cyclegan_tpu_torch.main", [
        "--output_dir", out_dir, "--epochs", "1", "--ckpt_keep", "2",
        "--domain", "npy_pair", "--domain_registry", registry,
        "--init_from", parent, "--transfer", "encoder_freeze",
        "--grad_impl", "fusedprop", "--grad_accum", "2", "--verbose", "0",
        "--seed", str(SEED), *KERNEL_FLAGS], timeout=DEADLINES["epochs"])
    seconds = time.perf_counter() - t0
    for line in ("global batch size: 2 (2x accumulated)",
                 "transfer init: encoder_freeze", "grad-norm G/F/dX/dY: "):
        if line not in out:
            raise AssertionError(f"run D printed no {line!r}:\n{out[-2000:]}")
    ckpt = Checkpointer(out_dir, keep=2)
    meta = ckpt.read_meta()
    want_transfer = dict(parent_ckpt=os.path.abspath(parent), parent_epoch=2,
                         parent_domain="horse2zebra",
                         transfer_mode="encoder_freeze", domain="npy_pair")
    if meta.get("domain") != "npy_pair" or meta.get("transfer") != want_transfer:
        raise AssertionError(f"run D's meta.json {meta}")
    _, slot_d = ckpt.slots()[0]
    _, slot_a = Checkpointer(parent, keep=2).slots()[0]
    frozen, total, same, changed = 0, 0, [], []
    for net in ("g", "f"):
        mine, theirs = (torch.load(os.path.join(slot, f"{net}.pt"),
                                   weights_only=True)
                        for slot in (slot_d, slot_a))
        for key, value in theirs.items():
            total += 1
            equal = torch.equal(mine[key], value)
            if is_frozen(key):
                frozen += 1
                if not equal:
                    changed.append(f"{net} {key}")
            elif equal:
                same.append(f"{net} {key}")
    # Each generator's stem conv, its downsampling blocks' conv and norm,
    # and each residual block's first conv: 16 at full width.
    g = Config().model.generator
    want_frozen = 2 * (1 + 3 * g.num_downsampling_blocks
                       + g.num_residual_blocks)
    if frozen != want_frozen or changed or same:
        raise AssertionError(f"run D: {frozen} frozen tensors, of which "
                             f"changed {changed}; unfrozen but unchanged "
                             f"{same}")
    scalars = read_scalars(out_dir)
    enc = scalars.get("health/gnorm_enc_frozen")
    upd = scalars.get("health/upd_ratio_enc_frozen")
    if enc != [(0, 0.0)] or upd != [(0, 0.0)]:
        raise AssertionError(f"run D: health/gnorm_enc_frozen {enc}, "
                             f"health/upd_ratio_enc_frozen {upd}")
    # 2 images a pair, 2 pairs an update.
    ms = 4e3 / dict(scalars["perf/train_images_per_sec"])[0]
    log(f"run D (encoder_freeze from A, fusedprop, 2 accumulated, domain "
        f"npy_pair) on {name_and_limit}: {seconds:.1f} s; {frozen} frozen "
        f"generator tensors bitwise A's, the other {total - frozen} changed; "
        f"health/gnorm_enc_frozen 0; epoch 0 at {ms:.1f} ms per update of 2 "
        f"accumulated pairs")
    return dict(seconds=seconds, frozen_tensors=frozen,
                generator_tensors=total, gnorm_enc_frozen=enc[0][1],
                meta_transfer=meta["transfer"],
                epoch0_ms_per_update=ms)


def bf16_phase(torch, device, name_and_limit, serve_summary, train_summary):
    """bfloat16 compute at full width: the bf16 forms of K1-K5 against
    their bf16 plain versions at every path shape, the bf16 generator
    served at buckets 1 and 4, the bf16 train step against float64 and 10
    bf16 steps, and ``--bf16`` through the training CLI and translate."""
    rows = check_kernels(torch, device, bf16=True)
    names = tuple(name + BF16 for name in FORWARD_KERNELS)
    log(f"bf16 forward norm kernels per batch-1 256^2 serving forward and "
        f"train step on {name_and_limit} (ms, calls x median): "
        f"{json.dumps(per_path(rows, names))}")
    log(f"bf16 backward kernels per batch-1 256^2 train step on "
        f"{name_and_limit} (ms, calls x median): "
        f"{json.dumps(backward_per_step(rows, BF16))}")
    log(f"bf16 upsample kernel per batch-1 256^2 serving forward and train "
        f"step on {name_and_limit} (ms, calls x median): "
        f"{json.dumps(upsample_per_path(rows))}")
    serve_launches, serve_out = serve_bf16(torch, device, name_and_limit,
                                           serve_summary)
    train_launches, train_out = train_bf16(torch, device, name_and_limit,
                                           train_summary)
    cli_out = cli_bf16(torch, device, name_and_limit)
    return rows, serve_launches, train_launches, dict(
        serve=serve_out, train=train_out, cli=cli_out)


def serve_bf16(torch, device, name_and_limit, serve_summary):
    """The full-width generator served in bf16 at buckets 1 and 4 (the main
    path: a flush at bucket 1, a ragged flush of 3 at bucket 4, counted
    from 0), at init-distribution and signal weights: through the kernels
    against the same engine through the plain versions, and against the
    f32 engine on the same weights within the JAX package's pins; ms per
    flush, images/s and peak memory beside the f32 engine's."""
    import numpy as np

    from cyclegan_tpu_torch.config import GeneratorConfig, ModelConfig
    from cyclegan_tpu_torch.convert import (
        generator_state_from_flax,
        random_flax_params,
        signal_flax_params,
    )
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig

    config = GeneratorConfig()
    model_cfg = ModelConfig(generator=config, image_size=256, **KERNEL_LAYOUT)
    images = np.random.default_rng(SEED).uniform(
        -1, 1, (4, 256, 256, 3)).astype(np.float32)
    checks, launches, peak_bytes, engine = {}, None, None, None
    for label, params in (("init", random_flax_params(config, SEED)),
                          ("signal", signal_flax_params(config, SEED + 2))):
        state = generator_state_from_flax(params)
        engines = {dtype: InferenceEngine(
            model_cfg, state, serve_cfg=ServeConfig(
                batch_buckets=(1, 4), sizes=(256,), dtype=dtype),
            device=device) for dtype in ("bfloat16", "float32")}
        engine = engines["bfloat16"]
        for flush in (images[:1], images[:3]):  # warm-up
            engine.run(flush)
        torch.cuda.synchronize()
        if label == "init":
            # The main path, counted from 0.
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            (out1,), n1 = engine.run(images[:1])
            (out3,), n3 = engine.run(images[:3])
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            peak_bytes = torch.cuda.max_memory_allocated()
            want = in_bf16({k: MAIN_PATH_FORWARDS * v
                            for k, v in LAUNCHES_PER_FORWARD.items()})
            log(f"bf16 main path launches {launches} over "
                f"{MAIN_PATH_FORWARDS} forwards")
            if launches != want:
                raise AssertionError(f"bf16 launches {launches}, expected "
                                     f"{want}")
            if (n1, n3) != (1, 3) or out1.dtype != torch.float32 or not (
                    torch.isfinite(out3).all() and out3.abs().max() <= 1.0):
                raise AssertionError(f"bf16 engine: n_valid {(n1, n3)}, "
                                     f"{out1.dtype}")
        out = torch.cat([engine.run(images[:1])[0][0],
                         engine.run(images[:3])[0][0][:3]])
        with plain_versions():
            plain = torch.cat([engine.run(images[:1])[0][0],
                               engine.run(images[:3])[0][0][:3]])
        f32 = torch.cat([engines["float32"].run(images[:1])[0][0],
                         engines["float32"].run(images[:3])[0][0][:3]])
        kp, kf, pf = ((a - b).abs() for a, b in ((out, plain), (out, f32),
                                                  (plain, f32)))
        row = dict(kernels_vs_plain_max=kp.max().item(),
                   kernels_vs_plain_mean=kp.mean().item(),
                   bf16_vs_f32_max=kf.max().item(),
                   bf16_vs_f32_mean=kf.mean().item(),
                   plain_bf16_vs_f32_mean=pf.mean().item(),
                   f32_output_std=f32.std().item())
        checks[label] = row
        log(f"bf16 engine, {label} weights: {json.dumps(row)}")
        if not (row["bf16_vs_f32_max"] < BF16_SERVE_MAX
                and row["bf16_vs_f32_mean"] < BF16_SERVE_MEAN
                and row["kernels_vs_plain_max"] < BF16_SERVE_MAX
                and row["kernels_vs_plain_mean"]
                <= row["plain_bf16_vs_f32_mean"]):
            raise AssertionError(f"bf16 engine, {label} weights: {row}")
        if label == "init":
            del engines
    timings = flush_timings(torch, engine, images)
    f32_t = serve_summary["timings"]
    log(f"serve 256^2 bf16 on {name_and_limit}: bucket 1 "
        f"{timings[1]['ms_per_flush']:.2f} ms/flush "
        f"({timings[1]['images_per_s']:.1f} images/s), bucket 4 "
        f"{timings[4]['ms_per_flush']:.2f} ms/flush "
        f"({timings[4]['images_per_s']:.1f} images/s), peak memory "
        f"{peak_bytes / 2**20:.1f} MiB; f32 (serve phase) bucket 1 "
        f"{f32_t[1]['ms_per_flush']:.2f}, bucket 4 "
        f"{f32_t[4]['ms_per_flush']:.2f} ms/flush, peak memory "
        f"{serve_summary['peak_bytes'] / 2**20:.1f} MiB")
    breakdown = {bucket: device_breakdown(
        torch, lambda flush=images[:bucket]: engine.run(flush))
        for bucket in (1, 4)}
    log(f"bf16 device time per flush on {name_and_limit} (profiled): "
        f"{json.dumps(breakdown)}")
    return launches, dict(checks=checks, peak_bytes=peak_bytes,
                          timings=timings, breakdown=breakdown)


def train_bf16(torch, device, name_and_limit, train_summary):
    """The full-width CycleGAN's bf16 combined step at batch 1: at signal
    weights against its plain bf16 and float64 runs over REACH_DRAWS
    draws of the images, then the main path, TRAIN_STEPS steps from the
    init weights counted from 0, with ms per step, images/s and peak memory
    beside the f32 step's."""
    import numpy as np

    from cyclegan_tpu_torch.config import Config, ModelConfig
    from cyclegan_tpu_torch.data.augment import normalize_image
    from cyclegan_tpu_torch.data.sources import SyntheticSource
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.train.steps import make_grad_fn, make_train_step

    config = Config(model=ModelConfig(compute_dtype="bfloat16",
                                      **KERNEL_LAYOUT))
    source = SyntheticSource(image_size=config.model.image_size)

    def images(split, index):
        return torch.from_numpy(normalize_image(
            source.load(split, index))[None]).to(device)

    per_step = train_launches_per_step(config)
    w = torch.ones(1, device=device)
    draws = [(images("trainA", i), images("trainB", i))
             for i in range(REACH_DRAWS)]
    grad_fn = make_grad_fn(config, 1)
    state = signal_state(config, SEED + 10, device)
    grad_fn(state, *draws[0], w)  # warm-up: cuDNN's first bf16 calls
    torch.cuda.synchronize()
    checks = hold_over_draws(torch, grad_fn, state, draws, w,
                             "bf16, signal", per_step, bf16=True)[0]
    del state

    state = create_state(config, SEED, device)
    train_step = make_train_step(config, 1)
    data = [(images("trainA", i), images("trainB", i))
            for i in range(TRAIN_STEPS)]
    train_step(state, *data[0], w)  # warm-up
    state, step_ms, losses, launches, peak_bytes = timed_steps(
        torch, train_step, state, data, w)
    if not all(np.isfinite(v) for row in losses for v in row.values()):
        raise AssertionError("a bf16 train step gave a non-finite loss")
    want = {k: TRAIN_STEPS * v for k, v in per_step.items()}
    if launches != want:
        raise AssertionError(f"bf16 train launches {launches}, expected "
                             f"{want}")
    median = statistics.median(step_ms[2:])
    log(f"train 256^2 bf16 batch 1 on {name_and_limit}: {median:.2f} ms per "
        f"step (median of the last {TRAIN_STEPS - 2}; all: "
        f"{', '.join(f'{t:.2f}' for t in step_ms)}), {1e3 / median:.2f} "
        f"images/s, peak memory {peak_bytes / 2**20:.1f} MiB, launches per "
        f"step { {k: v // TRAIN_STEPS for k, v in launches.items() if v} }; "
        f"f32 (train phase) {train_summary['ms_per_step']:.2f} ms per step, "
        f"{train_summary['images_per_s']:.2f} images/s, peak memory "
        f"{train_summary['peak_bytes'] / 2**20:.1f} MiB")
    log("bf16 losses, last step: " + ", ".join(
        f"{k} {v:.5f}" for k, v in losses[-1].items()))
    x, y = data[-1]
    breakdown = device_breakdown(
        torch, lambda: train_step(state, x, y, w), runs=3)
    log(f"bf16 device time per train step on {name_and_limit} (profiled): "
        f"{json.dumps(breakdown)}")
    return launches, dict(checks=checks, ms_per_step=median, step_ms=step_ms,
                          images_per_s=1e3 / median, peak_bytes=peak_bytes,
                          losses=losses, breakdown=breakdown)


def cli_bf16(torch, device, name_and_limit):
    """``--bf16`` through the training CLI for one epoch (in a child, on a
    folder of .npy images), then translate from its ring, which must run
    in bf16 by default: its PNGs against the bf16 engine on the ring's
    weights."""
    import shutil
    import tempfile

    import numpy as np

    from cyclegan_tpu_torch.convert import generator_state_from_flax
    from cyclegan_tpu_torch.data.augment import preprocess_test
    from cyclegan_tpu_torch.data.sources import load_image_file
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig
    from cyclegan_tpu_torch.translate import load_checkpoint, translate_arrays
    from cyclegan_tpu_torch.utils.checkpoint import Checkpointer
    from cyclegan_tpu_torch.utils.plotting import to_uint8
    from cyclegan_tpu_torch.utils.summary import read_scalars

    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    try:
        data_dir, run = os.path.join(tmp, "data"), os.path.join(tmp, "run")
        write_npy_folder(data_dir)
        t0 = time.perf_counter()
        run_module("cyclegan_tpu_torch.main", [
            "--output_dir", run, "--epochs", "1", "--data_source", "folder",
            "--data_dir", data_dir, "--verbose", "0", "--seed", str(SEED),
            "--bf16", *KERNEL_FLAGS], timeout=DEADLINES["bf16"])
        seconds = time.perf_counter() - t0
        meta = Checkpointer(run).read_meta()
        means = epoch_means(run)
        if meta["model"]["compute_dtype"] != "bfloat16" or sorted(means) != [
                0] or not all(np.isfinite(v) for v in means[0].values()):
            raise AssertionError(f"--bf16 run: meta {meta['model']}, epoch "
                                 f"means {means}")
        ips = dict(read_scalars(run)["perf/train_images_per_sec"])
        test_dir, out_dir = (os.path.join(data_dir, "testA"),
                             os.path.join(tmp, "translated"))
        printed = run_module("cyclegan_tpu_torch.translate", [
            "--output_dir", run, "--input", test_dir, "--output", out_dir],
            timeout=DEADLINES["bf16"])
        if "bfloat16)" not in printed:
            raise AssertionError(f"translate from the bf16 ring did not run "
                                 f"in bf16: {printed[-500:]}")
        g, _, model_cfg = load_checkpoint(run)
        engine = InferenceEngine(
            model_cfg, generator_state_from_flax(g),
            serve_cfg=ServeConfig(batch_buckets=(1, 8),
                                  sizes=(model_cfg.image_size,),
                                  dtype=model_cfg.compute_dtype),
            device=device)
        names = sorted(os.listdir(test_dir))
        fake, _ = translate_arrays(engine, np.stack([preprocess_test(
            load_image_file(os.path.join(test_dir, n)), model_cfg.image_size)
            for n in names]))
        worst = 0
        for i, n in enumerate(names):
            with open(os.path.join(out_dir, os.path.splitext(n)[0] + ".png"),
                      "rb") as fh:
                got = decode_png(fh.read())
            worst = max(worst, int(np.abs(got.astype(int)
                                          - to_uint8(fake[i])).max()))
        log(f"--bf16 through the training CLI on {name_and_limit}: one epoch "
            f"in {seconds:.1f} s (train images/s {json.dumps(ips)}), "
            f"meta compute_dtype {meta['model']['compute_dtype']}; translate "
            f"from its ring in bf16: {len(names)} PNGs, max {worst} count(s) "
            f"from the bf16 engine's output")
        if worst > PNG_TOL:
            raise AssertionError(f"bf16 translate PNGs differ by {worst} "
                                 f"counts")
        return dict(seconds=seconds, train_images_per_s=ips,
                    translate_max_count_err=worst)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The driver phase: several steps a dispatch as one CUDA graph, the epoch
# services, the preemption guard and the trace, at full width.
DRIVER_K = 4
DRIVER_ROUNDS = 4
# The epochs phase's folder trains 6 steps an epoch: at K = 4 one graphed
# dispatch and a remainder of 2 through the single step.
DRIVER_EPOCHS = 2
DRIVER_PREEMPT_DEADLINE_S = 30
GRAPH_CHECK = "--graph-check"
# The obs phase: dispatches of DRIVER_K bf16 steps on host batches, enough
# that the deferred fetch's window (MAX_IN_FLIGHT = 32 pinned batches, 8
# such dispatches) fills and at least OBS_MIN_FETCHES backpressure
# fetches follow; K = 1 passes as long; and the CLI runs with the stream
# on and off, in turns.
OBS_WINDOW_DISPATCHES = 24
OBS_MIN_FETCHES = 12
OBS_K1_DISPATCHES = 44
OBS_COST_TURNS = ("on", "off")
# The stream's cost in the loop itself, past the first pass: further
# passes with the telemetry on and with none, in turns (bf16 K = 1 is
# host-bound, so a host cost shows there whole).
OBS_K4_TURNS = ("off", "on", "on", "off", "off", "on")
OBS_K1_TURNS = ("off", "on", "on", "off")
OBS_TURN_DISPATCHES = 24


def driver_instantiations(per_step: dict, bf16: bool) -> dict:
    """Device launches of each kernel instantiation in one full-width
    train step, from the per-kernel counts (``train_launches_per_step``)
    and the network's structure: K1 and the discriminator's K3 sites
    (pad 0) share ``norm_forward_kernel<T, vec, false>``, the generator's
    residual K3 sites (pad 1) are ``<T, vec, true>``; K2 is
    ``norm_backward_kernel<T, false, false, vec>``, K4 folds the reflect
    pad where it has one (the residual sites and the last upsample's tail,
    pad 3) and masks without a fold elsewhere (the other upsample tails
    and the discriminator); K5 is its GEMM and its apply pass."""
    from cyclegan_tpu_torch.config import Config

    g = Config().model.generator
    t, v = ("__nv_bfloat16", 8) if bf16 else ("float", 4)
    suffix = BF16 if bf16 else ""
    k3_gen = 6 * g.num_residual_blocks
    k4_fold = 6 * (g.num_residual_blocks + 1)
    return {
        f"norm_forward_kernel<{t}, {v}, false>":
            per_step["instance_norm" + suffix]
            + per_step["epilogue" + suffix] - k3_gen,
        f"norm_forward_kernel<{t}, {v}, true>": k3_gen,
        f"norm_backward_kernel<{t}, false, false, {v}>":
            per_step["instance_norm_backward" + suffix],
        f"norm_backward_kernel<{t}, true, true, {v}>": k4_fold,
        f"norm_backward_kernel<{t}, false, true, {v}>":
            per_step["epilogue_backward" + suffix] - k4_fold,
        f"upsample_mma_kernel<{t}, {t}, true>": per_step["upsample" + suffix],
        f"norm_act_pad_kernel<{t}, {v}>": per_step["upsample" + suffix],
    }


def driver_images(torch, device, groups: int):
    """``groups`` groups of DRIVER_K batch-1 256^2 image pairs from a seed,
    and their weights, on ``device``."""
    g = torch.Generator().manual_seed(SEED)
    shape = (groups, DRIVER_K, 1, 256, 256, 3)
    xs = (torch.rand(shape, generator=g) * 2 - 1).to(device)
    ys = (torch.rand(shape, generator=g) * 2 - 1).to(device)
    return xs, ys, torch.ones(groups, DRIVER_K, 1, device=device)


def graph_check_child() -> int:
    """(a) and (b), in a child under torch's deterministic algorithms: from
    one state, 2 dispatches of DRIVER_K graphed steps against 2 * DRIVER_K
    eager steps, full width, 256^2, batch 1, health on, f32 and bf16; then
    the wrappers' counts at the capture and one replay's device launches.
    Prints one JSON line: per dtype whether the weights, both Adam
    moments, the counts, the step and every metric are bitwise equal, and
    the launch counts, which ``driver`` checks."""
    import torch

    from cyclegan_tpu_torch.config import Config, ModelConfig
    from cyclegan_tpu_torch.models.generator import use_full_fp32
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.train.multistep import make_multi_train_step
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.train.steps import make_train_step
    from cyclegan_tpu_torch.utils.checkpoint import state_digest

    use_full_fp32()
    device = torch.device("cuda", torch.cuda.current_device())
    out = {}
    for dtype in ("float32", "bfloat16"):
        config = Config(model=ModelConfig(compute_dtype=dtype,
                                          **KERNEL_LAYOUT))
        xs, ys, ws = driver_images(torch, device, 2)
        eager = create_state(config, SEED, device)
        step = make_train_step(config, 1)
        rows_eager = []
        for j in range(2):
            for i in range(DRIVER_K):
                eager, m = step(eager, xs[j, i], ys[j, i], ws[j, i])
                rows_eager.append(m)
        graphed = create_state(config, SEED, device)
        multi = make_multi_train_step(make_train_step(config, 1), DRIVER_K)
        rows_graph = []
        for j in range(2):
            if j == 1:  # the capture and its replay, counted from 0
                torch.cuda.synchronize()
                reset_launches()
            graphed, m = multi(graphed, xs[j], ys[j], ws[j])
            rows_graph += [{k: v[i] for k, v in m.items()}
                           for i in range(DRIVER_K)]
        torch.cuda.synchronize()
        at_capture = {k: v for k, v in LAUNCHES.items() if v}
        metrics_equal = all(
            a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
            for a, b in zip(rows_eager, rows_graph))
        out[dtype] = dict(
            captured=multi.graph is not None,
            steps=[eager.step, graphed.step],
            state_bitwise=state_digest(eager) == state_digest(graphed),
            metrics_bitwise=metrics_equal,
            rows=[len(rows_eager), len(rows_graph)])

        # (b): one replay's device launches, in this process, where the
        # profiler has not run before. A window that lost events reads
        # low, never high, so each kernel's count is its largest over the
        # windows that kept their marker.
        def replay():
            multi(graphed, xs[0], ys[0], ws[0])

        launched = device_launches(torch, replay)
        out[dtype].update(
            launches_at_capture=at_capture,
            replay_launches=({k: v for k, v in launched["max_counts"].items()
                              if k.startswith(("norm_", "upsample_"))}
                             if isinstance(launched, dict) else launched),
            replay_window_counts=(launched["window_counts"]
                                  if isinstance(launched, dict) else None),
            wrappers_at_replays={k: v for k, v in LAUNCHES.items() if v})
    print(json.dumps({"graph_check": out}), flush=True)
    return 0


def graphed_vs_eager(torch, device, config, name_and_limit, label):
    """(b)'s wrapper counts at the capture (DRIVER_K times a step's, and
    none at a replay) and (c), in the default mode for one compute dtype:
    ms per step, images/s, device idle share and peak memory at K = 1 and
    K = DRIVER_K, in turns."""
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.train.multistep import make_multi_train_step
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.train.steps import make_train_step

    per_step = train_launches_per_step(config)
    xs, ys, ws = driver_images(torch, device, 1)
    xs, ys, ws = xs[0], ys[0], ws[0]
    single = create_state(config, SEED, device)
    step = make_train_step(config, 1)

    def k1_group():
        nonlocal single
        for i in range(DRIVER_K):
            single, _ = step(single, xs[i], ys[i], ws[i])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_group()
    torch.cuda.synchronize()
    peak_k1 = torch.cuda.max_memory_allocated()

    graphed = create_state(config, SEED, device)
    multi = make_multi_train_step(make_train_step(config, 1), DRIVER_K)
    graphed, _ = multi(graphed, xs, ys, ws)  # warm-up: eager
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    graphed, _ = multi(graphed, xs, ys, ws)  # capture, then replay
    torch.cuda.synchronize()
    peak_k = torch.cuda.max_memory_allocated()
    # The wrappers count in Python: at the capture, never at a replay.
    at_capture = {k: v for k, v in LAUNCHES.items() if v}
    want_capture = {k: DRIVER_K * v for k, v in per_step.items() if v}
    if multi.graph is None or at_capture != want_capture:
        raise AssertionError(f"{label}: the capture counted {at_capture}, "
                             f"expected {want_capture}")

    def replay():
        nonlocal graphed
        graphed, _ = multi(graphed, xs, ys, ws)

    replay()
    torch.cuda.synchronize()
    if {k: v for k, v in LAUNCHES.items() if v} != at_capture:
        raise AssertionError(f"{label}: a wrapper ran outside the graph: "
                             f"{dict(LAUNCHES)}")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / DRIVER_K

    ms = {1: [], DRIVER_K: []}
    for r in range(DRIVER_ROUNDS):
        order = ((1, k1_group), (DRIVER_K, replay))
        for k, fn in (order if r % 2 == 0 else order[::-1]):
            ms[k].append(timed(fn))
    busy = {1: device_breakdown(torch, k1_group, runs=1),
            DRIVER_K: device_breakdown(torch, replay, runs=1)}
    summary = {}
    for k in ms:
        median = statistics.median(ms[k])
        summary[f"K={k}"] = dict(
            ms_per_step=median, ms_per_step_all=ms[k],
            images_per_s=1e3 / median,
            idle_share=busy[k].get("idle_share", busy[k].get("device_time")),
            busy_ms_per_step=(busy[k]["busy_ms_per_run"] / DRIVER_K
                              if "busy_ms_per_run" in busy[k] else None),
            peak_mib=(peak_k1 if k == 1 else peak_k) / 2**20)
    log(f"{label} train step 256^2 batch 1, health on, on {name_and_limit}: "
        + "; ".join(
            f"{k}: {v['ms_per_step']:.2f} ms per step (median of "
            f"{DRIVER_ROUNDS} dispatch groups in turns), "
            f"{v['images_per_s']:.2f} images/s, device idle "
            f"{v['idle_share']}, peak {v['peak_mib']:.1f} MiB"
            for k, v in summary.items()))
    return dict(summary, launches_at_capture=at_capture)


class Child:
    """A child process of this script started now and read on a thread of
    its own: ``python -m module args`` from the repo's root, under torch's
    deterministic algorithms where asked (as ``run_module`` runs it), with
    its output unbuffered. With ``sigterm_after`` it gets SIGTERM once it
    has printed a line that starts so. Several run at once on the card."""

    def __init__(self, module: str, args: list, deterministic: bool = True,
                 sigterm_after: str = None):
        import signal

        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        command = [sys.executable, "-m", module, *args]
        if deterministic:
            env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
            command = [sys.executable, "-c", DETERMINISTIC_RUN, module, *args]
        self.label = f"{module} {' '.join(args)}"
        self.proc = subprocess.Popen(command, cwd=root, env=env,
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        CHILDREN.append(self.proc)
        self.lines: list = []

        def read():
            after = sigterm_after
            for line in self.proc.stdout:
                self.lines.append(line)
                if after and line.startswith(after):
                    self.proc.send_signal(signal.SIGTERM)
                    after = None

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()

    def output(self, timeout: float) -> str:
        """Wait for the child; its output. Raises with the output's tail
        where it fails or runs past ``timeout`` seconds."""
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        finally:
            CHILDREN.remove(self.proc)
        self.reader.join(10)
        out = "".join(self.lines)
        if self.proc.returncode != 0:
            raise AssertionError(f"{self.label} exited "
                                 f"{self.proc.returncode}:\n{out[-3000:]}")
        return out


def driver_cli_runs(tmp, data_dir):
    """(d)'s runs of the CLI on the epochs phase's folder, f32, all under
    deterministic algorithms: P at K = 1, Q at K = DRIVER_K with
    --trace 2, and S at K = DRIVER_K with --preempt_deadline_s, sent
    SIGTERM after its first epoch line, started together; returns them
    (Child) for ``driver_cli`` to read."""
    def args(name, *extra):
        return ["--output_dir", os.path.join(tmp, name), "--epochs",
                str(DRIVER_EPOCHS), "--ckpt_keep", "2", "--data_source",
                "folder", "--data_dir", data_dir, "--verbose", "0", "--seed",
                str(SEED), *KERNEL_FLAGS, *extra]

    k = ("--steps_per_dispatch", str(DRIVER_K))
    preempt = ("--preempt_deadline_s", str(DRIVER_PREEMPT_DEADLINE_S))
    return dict(
        P=Child("cyclegan_tpu_torch.main", args("P")),
        Q=Child("cyclegan_tpu_torch.main", args("Q", *k, "--trace", "2")),
        S=Child("cyclegan_tpu_torch.main", args("S", *k, *preempt),
                sigterm_after="Epoch 001"),
        resume_S=lambda: Child("cyclegan_tpu_torch.main",
                               args("S", *k, *preempt)))


def driver_cli(tmp, runs):
    """(d): Q's epoch means bitwise P's (K = DRIVER_K against K = 1); the
    trace Q wrote names K1-K5; S exits 0 with the preemption line and a
    mid_epoch slot, and S resumed gives P's final epoch means bitwise.
    (The loop's wait at a checkpoint epoch is read in the epochs phase,
    whose runs have the card to themselves.)"""
    import re

    from cyclegan_tpu_torch.utils.checkpoint import Checkpointer

    budget = DEADLINES["driver"]
    out = {name: runs[name].output(budget) for name in "PQS"}
    means = {n: epoch_means(os.path.join(tmp, n)) for n in "PQ"}
    if sorted(means["P"]) != list(range(DRIVER_EPOCHS)) or (
            means["Q"] != means["P"]):
        raise AssertionError(
            f"K={DRIVER_K} epoch means are not K=1's bitwise: "
            f"{ {e: relative_gap(means['Q'][e], means['P'][e]) for e in means['P']} }")
    log(f"the CLI at K={DRIVER_K} (one graphed dispatch and 2 single steps "
        f"an epoch) against K=1, both under deterministic algorithms: "
        f"{DRIVER_EPOCHS} epochs' means bitwise equal")

    trace_dir = os.path.join(tmp, "Q", "traces")
    traces = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, traces[0])) as fh:
        text = fh.read()
    named = {k: text.count(k) for k in (
        "norm_forward_kernel", "norm_backward_kernel", "upsample_mma_kernel",
        "norm_act_pad_kernel")}
    if len(traces) != 1 or not all(named.values()):
        raise AssertionError(f"--trace 2 wrote {traces}, naming {named}")
    log(f"--trace 2 (dispatches 2-3 of run Q): {traces[0]} ({len(text)} "
        f"bytes), kernel names in it {named}")

    meta = Checkpointer(os.path.join(tmp, "S"), keep=2).read_meta()
    if ("preemption requested: checkpointed, exiting cleanly" not in out["S"]
            or "mid_epoch" not in meta):
        raise AssertionError(f"the SIGTERM'd run: meta {meta}, output\n"
                             f"{out['S'][-3000:]}")
    # Their streams: Q's K-step graph is one "multi" record a dispatch;
    # S's ends preempted, after its emergency save's event.
    q_kinds = [(e["epoch"], e["kind"]) for e in read_stream(
        os.path.join(tmp, "Q", "telemetry.jsonl"))
        if e["event"] == "step" and e["split"] == "train"]
    want_kinds = [(e, kind) for e in range(DRIVER_EPOCHS)
                  for kind in ("multi", "single", "single")]
    stream_s = read_stream(os.path.join(tmp, "S", "telemetry.jsonl"))
    saves = [e for e in stream_s if e["event"] == "emergency_save"]
    if (q_kinds != want_kinds or stream_s[-1].get("status") != "preempted"
            or len(saves) != 1 or not saves[0]["committed"]):
        raise AssertionError(f"run Q's train records {q_kinds}; run S's "
                             f"stream ends {stream_s[-3:]}")
    emergency = re.search(r"emergency save: .*", out["S"]).group(0)
    out_s2 = runs["resume_S"]().output(budget)
    resumed = re.search(r"Resumed from \S+ at epoch \d+(, step \d+)?", out_s2)
    means["S"] = epoch_means(os.path.join(tmp, "S"))
    last = DRIVER_EPOCHS - 1
    if resumed is None or means["S"].get(last) != means["P"][last]:
        raise AssertionError(
            f"the resumed run's final epoch means are not the uninterrupted "
            f"run's: {means['S'].get(last)} vs {means['P'][last]}\n"
            f"{out_s2[-3000:]}")
    log(f"SIGTERM after the first epoch line, K={DRIVER_K}, "
        f"--preempt_deadline_s {DRIVER_PREEMPT_DEADLINE_S}: exit 0, "
        f"mid_epoch {meta['mid_epoch']} ({emergency}, stream event "
        f"{json.dumps(saves[0])}); '{resumed.group(0)}';"
        f" its final epoch's means bitwise the uninterrupted run's")
    return dict(k_vs_1_bitwise=True, trace=dict(file=traces[0], named=named),
                preempt=dict(mid_epoch=meta["mid_epoch"], emergency=emergency,
                             resumed=resumed.group(0)))


def driver(torch, device, name_and_limit):
    """The driver phase: (b) and (c) alone on the card in this process,
    then (a)'s child and (d)'s runs together, then S's resume."""
    import shutil
    import tempfile

    from cyclegan_tpu_torch.config import Config, ModelConfig

    timing = {
        label: graphed_vs_eager(torch, device, Config(model=ModelConfig(
            compute_dtype=dtype, **KERNEL_LAYOUT)), name_and_limit, label)
        for label, dtype in (("f32", "float32"), ("bf16", "bfloat16"))}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_driver_")
    try:
        data_dir = os.path.join(tmp, "data")
        write_npy_folder(data_dir)
        t0 = time.perf_counter()
        graph = Child("chip_smoke", [GRAPH_CHECK])
        runs = driver_cli_runs(tmp, data_dir)
        out = graph.output(DEADLINES["driver"])
        check = json.loads(next(line for line in out.splitlines()
                                if line.startswith('{"graph_check"')))[
            "graph_check"]
        log(f"{DRIVER_K}-step CUDA graph against eager steps, 2 dispatches "
            f"against {2 * DRIVER_K} steps from one state, full width, "
            f"256^2, batch 1, health on, under deterministic algorithms: "
            f"{json.dumps(check)} ({time.perf_counter() - t0:.1f} s)")
        for dtype, c in check.items():
            if not (c["captured"] and c["state_bitwise"]
                    and c["metrics_bitwise"]
                    and c["steps"] == [2 * DRIVER_K] * 2):
                raise AssertionError(f"{dtype}: the graphed steps are not "
                                     f"the eager steps bitwise: {c}")
            config = Config(model=ModelConfig(compute_dtype=dtype,
                                              **KERNEL_LAYOUT))
            per_step = train_launches_per_step(config)
            want_capture = {k: DRIVER_K * v for k, v in per_step.items() if v}
            want_replay = {k: DRIVER_K * v for k, v in driver_instantiations(
                per_step, dtype == "bfloat16").items()}
            if (c["launches_at_capture"] != want_capture
                    or c["wrappers_at_replays"] != want_capture
                    or c["replay_launches"] != want_replay):
                raise AssertionError(
                    f"{dtype}: launches at the capture "
                    f"{c['launches_at_capture']} (want {want_capture}), "
                    f"after the replays {c['wrappers_at_replays']}; one "
                    f"replay's device launches {c['replay_launches']} (want "
                    f"{want_replay})")
        cli = driver_cli(tmp, runs)
        log(f"the graph check and the CLI runs: "
            f"{time.perf_counter() - t0:.1f} s")
        return dict(graph_check=check, timing=timing, cli=cli)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class HostBatches:
    """A ``CycleGANData`` stand-in whose train batches are already in host
    memory: full-width 256^2 batch-1 pairs from a seed, cycled, so the
    loop's staging is the pinned copy alone and the host can outrun the
    card."""

    def __init__(self, steps: int, pool: int = 4):
        import numpy as np

        rng = np.random.default_rng(SEED + 5)
        self.pool = [tuple(rng.uniform(-1, 1, (1, 256, 256, 3)).astype(
            np.float32) for _ in range(2)) + (np.ones(1, np.float32),)
            for _ in range(pool)]
        self.train_steps = steps

    def train_epoch(self, epoch, prefetch=True, start_step=0):
        for i in range(start_step, self.train_steps):
            yield self.pool[i % len(self.pool)]


class NoSummary:
    def scalar(self, *args, **kwargs):
        pass


class WatchedTelemetry:
    """``obs`` for ``train_epoch`` through its public hooks: a telemetry
    whose step clocks also note, after each backpressure fetch, whether
    the card still had the newest dispatch queued (an event recorded on
    the step's stream as the fetch returns is pending; the newest
    dispatch's pinned copy is the last work enqueued there), and which
    counts the host seconds spent inside the telemetry's own calls."""

    def __init__(self, torch, tele):
        self.torch, self.tele = torch, tele
        self.pending: list = []
        self.host_s = 0.0

    def timed(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            self.host_s += time.perf_counter() - t0

    def step_clock(self, epoch, split="train"):
        return WatchedClock(self, self.timed(self.tele.step_clock, epoch,
                                             split))

    def event(self, kind, /, **fields):
        self.timed(self.tele.event, kind, **fields)


class WatchedClock:
    def __init__(self, watch: WatchedTelemetry, clock):
        self.watch, self.clock = watch, clock

    def __getattr__(self, name):
        attr = getattr(self.clock, name)
        if not callable(attr):
            return attr
        return lambda *args, **kwargs: self.watch.timed(attr, *args,
                                                        **kwargs)

    def fetched(self, wait_s, **kwargs):
        self.watch.timed(self.clock.fetched, wait_s, **kwargs)
        probe = self.watch.torch.cuda.Event()
        probe.record()
        self.watch.pending.append(not probe.query())


def fetch_window(torch, device, tmp, dtype: str, k: int, dispatches: int,
                 cost_turns=()):
    """Train passes of ``dispatches`` dispatches of ``k`` steps at full
    width, batch 1, health on, on host batches. The first, with its
    telemetry watched: after each backpressure fetch, whether the newest
    dispatch was still pending (it was, when the fetch waited for its own
    dispatch alone). Then, past that warm-up, one pass a turn of
    ``cost_turns``, of ``OBS_TURN_DISPATCHES`` dispatches, with the
    telemetry ("on") or with none ("off").
    Returns (pending flags, the step records, the first pass's seconds,
    its host ms a dispatch inside the telemetry's calls, and the turns'
    ms a step by mode)."""
    from cyclegan_tpu_torch.config import (
        Config,
        ModelConfig,
        ObsConfig,
        TrainConfig,
    )
    from cyclegan_tpu_torch.obs import make_telemetry
    from cyclegan_tpu_torch.train import loop
    from cyclegan_tpu_torch.train.multistep import make_multi_train_step
    from cyclegan_tpu_torch.train.state import create_state
    from cyclegan_tpu_torch.train.steps import make_train_step

    config = Config(model=ModelConfig(compute_dtype=dtype, **KERNEL_LAYOUT),
                    train=TrainConfig(steps_per_dispatch=k, verbose=0))
    step = make_train_step(config, 1)
    multi = make_multi_train_step(step, k) if k > 1 else None
    state = create_state(config, SEED, device)

    def run(data, path, watched=False):
        """One pass, its seconds and its telemetry: a stream at ``path``
        (watched, or not), or none where ``path`` is None."""
        tele = None
        if path is not None:
            tele = make_telemetry(ObsConfig(jsonl_path=path), tmp,
                                  device=device)
        obs = WatchedTelemetry(torch, tele) if watched else tele
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loop.train_epoch(config, data, step, state, NoSummary(), 0,
                             multi_step_fn=multi, obs=obs)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, obs
        finally:
            if tele is not None:
                tele.close()

    path = os.path.join(tmp, f"{dtype}_k{k}.jsonl")
    seconds, watch = run(HostBatches(dispatches * k), path, watched=True)
    records = [e for e in read_stream(path) if e["event"] == "step"]
    cost = {"on": [], "off": []}
    for i, mode in enumerate(cost_turns):
        turn = os.path.join(tmp, f"{dtype}_k{k}_{i}.jsonl")
        elapsed, _ = run(HostBatches(OBS_TURN_DISPATCHES * k),
                         turn if mode == "on" else None)
        cost[mode].append(elapsed * 1e3 / (OBS_TURN_DISPATCHES * k))
    return (watch.pending, records, seconds,
            watch.host_s * 1e3 / dispatches, cost)


def step_breakdown(records, skip: int) -> dict:
    """Mean ms per dispatch of each part of the step records' wall and of
    the submit-to-ready latency, past the first ``skip`` dispatches (the
    warm-up and a graph's capture)."""
    rows = records[skip:]
    return {key: statistics.mean(r[key] for r in rows) * 1e3
            for key in STEP_PARTS}


def obs(torch, device, name_and_limit):
    """The obs phase: the deferred fetch's window at bf16 K = 4 (gated)
    and f32 K = 1, the step records' breakdown of a bf16 K = 1 step, the
    stream's cost in the loop (its host time inside the telemetry's calls,
    and later passes at bf16 K = 4 and K = 1 with the telemetry on and
    with none, in turns), and the training CLI's loop ms per step with its
    stream on and off."""
    import io
    import shutil
    import tempfile

    from cyclegan_tpu_torch import main as train_main
    from cyclegan_tpu_torch.utils.summary import read_scalars

    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    try:
        pending, records, seconds, stream_ms, loop_cost = fetch_window(
            torch, device, tmp, "bfloat16", DRIVER_K, OBS_WINDOW_DISPATCHES,
            OBS_K4_TURNS)
        share = sum(pending) / max(len(pending), 1)
        log(f"the deferred fetch at bf16 K={DRIVER_K}, {OBS_WINDOW_DISPATCHES}"
            f" dispatches on host batches, on {name_and_limit}: "
            f"{len(pending)} backpressure fetches, the newest dispatch still "
            f"pending after {sum(pending)} ({share:.2f}); {seconds:.1f} s; "
            f"step records past the capture, ms per dispatch of "
            f"{DRIVER_K} steps {json.dumps(step_breakdown(records, 2))}; "
            f"host ms a dispatch inside the telemetry's calls {stream_ms}; "
            f"later passes, ms a step with the stream on {loop_cost['on']}, "
            f"with none {loop_cost['off']} (turns {OBS_K4_TURNS})")
        if len(pending) < OBS_MIN_FETCHES or share < 0.5:
            raise AssertionError(
                f"{len(pending)} backpressure fetches (want at least "
                f"{OBS_MIN_FETCHES}), the newest dispatch pending after "
                f"{sum(pending)} (want at least half)")
        window = dict(bf16_k4=dict(fetches=len(pending),
                                   newest_pending=sum(pending),
                                   seconds=seconds,
                                   stream_host_ms_per_dispatch=stream_ms,
                                   loop_ms_per_step=loop_cost))
        for dtype, turns in (("float32", ()), ("bfloat16", OBS_K1_TURNS)):
            pending, records, seconds, stream_ms, loop_cost = fetch_window(
                torch, device, tmp, dtype, 1, OBS_K1_DISPATCHES, turns)
            parts = step_breakdown(records, 2)
            log(f"{dtype} K=1, {OBS_K1_DISPATCHES} dispatches on host "
                f"batches, on {name_and_limit}: {len(pending)} backpressure "
                f"fetches, the newest dispatch still pending after "
                f"{sum(pending)}; {seconds:.1f} s; step records past the "
                f"first 2, ms per dispatch (one step) {json.dumps(parts)}; "
                f"host ms a dispatch inside the telemetry's calls "
                f"{stream_ms}" + (
                    f"; later passes, ms a step with the stream on "
                    f"{loop_cost['on']}, with none {loop_cost['off']} "
                    f"(turns {turns})" if turns else ""))
            window[f"{dtype}_k1"] = dict(
                fetches=len(pending), newest_pending=sum(pending),
                seconds=seconds, step_ms=parts,
                stream_host_ms_per_dispatch=stream_ms,
                loop_ms_per_step=loop_cost)

        # The stream's cost: the CLI's loop ms per step (its train images/s
        # scalar; 2 images a step) with the stream on and with --no_obs, in
        # turns, one epoch each on a folder of .npy images.
        data_dir = os.path.join(tmp, "data")
        write_npy_folder(data_dir)
        cost = {"on": [], "off": []}
        for i, mode in enumerate(OBS_COST_TURNS):
            out_dir = os.path.join(tmp, f"{mode}{i}")
            args = ["--output_dir", out_dir, "--epochs", "1", "--data_source",
                    "folder", "--data_dir", data_dir, "--verbose", "0",
                    "--seed", str(SEED), *KERNEL_FLAGS] + (
                        ["--no_obs"] if mode == "off"
                                            else [])
            with contextlib.redirect_stdout(io.StringIO()):
                train_main.main(args)
            torch.cuda.synchronize()
            ips = dict(read_scalars(out_dir)["perf/train_images_per_sec"])[0]
            cost[mode].append(2e3 / ips)
            if (mode == "on") != os.path.exists(
                    os.path.join(out_dir, "telemetry.jsonl")):
                raise AssertionError(f"run {mode}{i}: stream present "
                                     f"{not mode == 'on'}")
        log(f"the training CLI's loop, 256^2 f32 batch 1, "
            f"{EPOCHS_TRAIN_IMAGES} steps an epoch, on {name_and_limit}: ms "
            f"per step with the stream on {cost['on']}, with --no_obs "
            f"{cost['off']} (turns {OBS_COST_TURNS}); the device's idle "
            f"share is not read in this phase")
        return dict(window=window, cli_ms_per_step=cost)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# The layouts phase: the JAX package's layout matrix at full width, 256^2,
# f32, batch 1 (ModelConfig fields), and the kernel layout at 512^2 with
# and without remat.
LAYOUT_MATRIX = {
    "jax_default": {},
    "xla_fused_zeroskip": dict(instance_norm_impl="xla", pad_impl="fused",
                               upsample_impl="zeroskip"),
    "pallas_pad_dense": dict(instance_norm_impl="pallas", pad_impl="pad",
                             upsample_impl="dense"),
    "pallas_fused_zeroskip_fused": dict(instance_norm_impl="pallas",
                                        pad_impl="fused",
                                        upsample_impl="zeroskip_fused"),
    "auto_epilogue_dense": dict(instance_norm_impl="auto",
                                pad_impl="epilogue", upsample_impl="dense"),
    "pad_mode_zero": dict(pad_mode="zero"),
    "perturb": dict(trunk_impl="perturb", instance_norm_impl="pallas",
                    pad_impl="fused"),
    "remat": dict(KERNEL_LAYOUT, remat=True),
    "scan_blocks": dict(KERNEL_LAYOUT, scan_blocks=True),
}
LAYOUT_BIG = 512
# Timed train steps a layout, after its held one (the first is warm).
LAYOUT_STEPS = 3


def layout_config(fields: dict, size: int = 256):
    from cyclegan_tpu_torch.config import Config, ModelConfig, ObsConfig

    return Config(model=ModelConfig(image_size=size, **fields),
                  obs=ObsConfig(health=False))


def layout_step(torch, device, label, config, draw, w, name_and_limit):
    """One layout's checks on the card: a generator forward's launches
    and a train step's, each against models/layout.py's count from the
    eligibility function (0 for the JAX default layout); the step held
    against float64 by compare_train_step's rule (hold_over_draws on one
    draw); then LAYOUT_STEPS steps with their ms and peak memory."""
    import numpy as np

    from cyclegan_tpu_torch.models import layout
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.train.steps import make_grad_fn, make_train_step

    size = config.model.image_size
    per_forward = all_launches(**layout.generator_launches(config.model, 1,
                                                           size))
    per_step = all_launches(**layout.train_step_launches(config, 1))
    state = signal_state(config, SEED + 10, device)
    grad_fn = make_grad_fn(config, 1)
    grad_fn(state, *draw, w)  # warm-up: cuDNN's first calls, the masks
    torch.cuda.synchronize()
    reset_launches()
    with torch.inference_mode():
        out = state.g(draw[0])
    torch.cuda.synchronize()
    forward = dict(LAUNCHES)
    if forward != per_forward or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: forward launches {forward}, expected "
                             f"{per_forward} (or a non-finite output)")
    summary = hold_over_draws(torch, grad_fn, state, [draw], w, label,
                              per_step)[0][0]
    del grad_fn
    state, step_ms, losses, launches, peak = timed_steps(
        torch, make_train_step(config, 1), state, [draw] * LAYOUT_STEPS, w)
    if launches != {k: LAYOUT_STEPS * v for k, v in per_step.items()}:
        raise AssertionError(f"{label}: step launches {launches}, expected "
                             f"{LAYOUT_STEPS} x {per_step}")
    if not all(np.isfinite(v) for row in losses for v in row.values()):
        raise AssertionError(f"{label}: a train step gave a non-finite loss")
    if config.model.remat:
        remat_graph(torch, config, state, draw, w, per_step, label)
    ms = statistics.median(step_ms[1:])
    kernels = {k: v for k, v in per_step.items() if v}
    log(f"layout {label}: forward launches {({k: v for k, v in forward.items() if v})}, "
        f"step launches {kernels}; {ms:.2f} ms per step (steps "
        f"{', '.join(f'{t:.2f}' for t in step_ms)}), peak memory "
        f"{peak / 2**20:.1f} MiB on {name_and_limit}")
    del state
    torch.cuda.empty_cache()
    return dict(forward_launches=forward, step_launches=kernels, step=summary,
                ms_per_step=ms, step_ms=step_ms, peak_bytes=peak)


def remat_graph(torch, config, state, draw, w, per_step, label):
    """remat under the K-step CUDA graph (train/multistep.py): 3
    dispatches of 2 steps, the first eager, the second captured (the
    wrappers count 2 steps' launches there, each recomputed block's
    forward kernels included) and replayed, the third replayed (no
    wrapper call): finite losses, and the step count advanced by 6."""
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.train.multistep import make_multi_train_step
    from cyclegan_tpu_torch.train.steps import make_train_step

    k = 2
    multi = make_multi_train_step(make_train_step(config, 1), k)
    xs, ys = (torch.stack([t] * k) for t in draw)
    ws = torch.stack([w] * k)
    step0 = state.step
    counts = []
    for _ in range(3):
        reset_launches()
        state, metrics = multi(state, xs, ys, ws)
        torch.cuda.synchronize()
        counts.append(dict(LAUNCHES))
        if not all(torch.isfinite(v).all() for v in metrics.values()):
            raise AssertionError(f"{label}: a graphed step gave a non-finite "
                                 "loss")
    want = [{n: k * v for n, v in per_step.items()}] * 2 + [
        dict.fromkeys(per_step, 0)]
    if counts != want or state.step != step0 + 3 * k:
        raise AssertionError(f"{label}: graphed launches {counts}, expected "
                             f"{want}; step {state.step}")
    log(f"layout {label}: {k}-step CUDA graph captured and replayed with "
        "remat")


def perturb_tier(torch, device, images, name_and_limit):
    """The perturb tier through InferenceEngine, served beside the kernel
    layout's base tier, at buckets 1 and 4 (a ragged flush of 3): each
    flush's launches against models/layout.py's, the output against the
    same engine through the plain versions (SERVE_TOL), ms a flush."""
    from cyclegan_tpu_torch.config import GeneratorConfig, ModelConfig
    from cyclegan_tpu_torch.convert import (
        generator_state_from_flax,
        random_flax_params,
        signal_flax_params,
    )
    from cyclegan_tpu_torch.models import layout
    from cyclegan_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from cyclegan_tpu_torch.serve.engine import InferenceEngine, ServeConfig

    g = GeneratorConfig()
    engine = InferenceEngine(
        ModelConfig(generator=g, **KERNEL_LAYOUT),
        generator_state_from_flax(random_flax_params(g, SEED)),
        perturb_params=generator_state_from_flax(
            signal_flax_params(g, SEED + 1, trunk_impl="perturb")),
        serve_cfg=ServeConfig(batch_buckets=(1, 4), sizes=(256,),
                              perturb_tier=True), device=device)
    if engine.tiers != ("base", "perturb"):
        raise AssertionError(f"tiers {engine.tiers}")
    out = {}
    for n, bucket in ((1, 1), (3, 4)):
        batch = images[:n]
        engine.run(batch, tier="perturb")  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        (fake,), valid = engine.run(batch, tier="perturb")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = all_launches(**layout.generator_launches(engine.perturb_cfg,
                                                         bucket, 256))
        if dict(LAUNCHES) != want or valid != n:
            raise AssertionError(f"perturb tier bucket {bucket}: launches "
                                 f"{dict(LAUNCHES)}, expected {want}")
        with plain_versions():
            (plain,), _ = engine.run(batch, tier="perturb")
        err = (fake[:n] - plain[:n]).abs().max().item()
        spread = plain[:n].std().item()
        if not (err <= SERVE_TOL and spread > 0.05
                and torch.isfinite(fake).all()):
            raise AssertionError(f"perturb tier bucket {bucket}: kernels vs "
                                 f"plain {err}, output std {spread}")
        out[bucket] = dict(max_abs_err=err, ms=ms, launches={
            k: v for k, v in want.items() if v})
        log(f"perturb tier bucket {bucket} ({n} images): kernels vs plain "
            f"{err:.3g}, {ms:.2f} ms a flush on {name_and_limit}, launches "
            f"{out[bucket]['launches']}")
    return out


def layout_cli(tmp, name_and_limit):
    """The training CLI for one epoch on a folder of .npy images at the JAX
    defaults, with --trunk_impl perturb and with --scan_blocks, the three
    at once on the card, then translate from each ring: each ring's
    meta.json records its layout and trunk, and translate writes a PNG an
    image."""
    from cyclegan_tpu_torch.utils.checkpoint import Checkpointer

    data_dir = os.path.join(tmp, "data")
    write_npy_folder(data_dir)
    # name -> (flags, the ModelConfig fields they set over the defaults)
    runs = {"jax_default": ([], {}),
            "perturb": (["--trunk_impl", "perturb"], {"trunk_impl": "perturb"}),
            "scan_blocks": (["--scan_blocks"], {"scan_blocks": True})}
    t0 = time.perf_counter()
    children = {name: Child("cyclegan_tpu_torch.main", [
        "--output_dir", os.path.join(tmp, name), "--epochs", "1",
        "--data_source", "folder", "--data_dir", data_dir, "--verbose", "0",
        "--seed", str(SEED), *flags], deterministic=False)
        for name, (flags, _) in runs.items()}
    for child in children.values():
        child.output(DEADLINES["layouts"])
    train_s = time.perf_counter() - t0
    for name, (_, fields) in runs.items():
        meta = Checkpointer(os.path.join(tmp, name)).read_meta()["model"]
        want = layout_config(fields).model.__dict__
        got = {k: meta[k] for k in ("instance_norm_impl", "pad_impl",
                                    "upsample_impl", "trunk_impl",
                                    "scan_blocks")}
        if any(got[k] != want[k] for k in got):
            raise AssertionError(f"CLI run {name}: meta {got}")
    t0 = time.perf_counter()
    test_dir = os.path.join(data_dir, "testA")
    children = {name: Child("cyclegan_tpu_torch.translate", [
        "--output_dir", os.path.join(tmp, name), "--input", test_dir,
        "--output", os.path.join(tmp, name + "_out")], deterministic=False)
        for name in runs}
    for name, child in children.items():
        out = child.output(DEADLINES["layouts"])
        pngs = [f for f in os.listdir(os.path.join(tmp, name + "_out"))
                if f.endswith(".png")]
        if len(pngs) != EPOCHS_TEST_IMAGES or "translated" not in out:
            raise AssertionError(f"translate from {name}: {pngs}\n{out[-2000:]}")
    translate_s = time.perf_counter() - t0
    log(f"CLI one epoch each at the JAX defaults, --trunk_impl perturb and "
        f"--scan_blocks (at once) in {train_s:.1f} s, translate from each "
        f"ring in {translate_s:.1f} s, on {name_and_limit}")
    return dict(train_s=train_s, translate_s=translate_s)


def layouts(torch, device, name_and_limit):
    """The layouts phase: the matrix at 256^2, the kernel layout at 512^2
    with and without remat (remat's peak memory lower), the perturb tier,
    the CLI, and the kernels at the other layouts' and 512^2's shapes."""
    import shutil
    import tempfile

    import numpy as np

    from cyclegan_tpu_torch.config import KERNEL_LAYOUT as PORT_KERNEL_LAYOUT
    from cyclegan_tpu_torch.data.augment import normalize_image
    from cyclegan_tpu_torch.data.sources import SyntheticSource

    if PORT_KERNEL_LAYOUT != KERNEL_LAYOUT:
        raise AssertionError(f"kernel layout {PORT_KERNEL_LAYOUT}")

    def draw(size):
        source = SyntheticSource(image_size=size)
        return tuple(torch.from_numpy(normalize_image(
            source.load(split, 0))[None]).to(device)
            for split in ("trainA", "trainB"))

    w = torch.ones(1, device=device)
    out = {"256": {}}
    small = draw(256)
    for name, fields in LAYOUT_MATRIX.items():
        out["256"][name] = layout_step(torch, device, name,
                                       layout_config(fields), small, w,
                                       name_and_limit)
    big = draw(LAYOUT_BIG)
    out["512"] = {}
    for label, remat in (("kernel", False), ("kernel_remat", True)):
        out["512"][label] = layout_step(
            torch, device, f"{label} {LAYOUT_BIG}^2",
            layout_config(dict(KERNEL_LAYOUT, remat=remat), LAYOUT_BIG), big,
            w, name_and_limit)
    peaks = {k: v["peak_bytes"] for k, v in out["512"].items()}
    if not peaks["kernel_remat"] < peaks["kernel"]:
        raise AssertionError(f"remat's peak memory is not lower: {peaks}")
    log(f"{LAYOUT_BIG}^2 kernel layout peak memory: "
        f"{peaks['kernel'] / 2**20:.1f} MiB, with remat "
        f"{peaks['kernel_remat'] / 2**20:.1f} MiB on {name_and_limit}")
    images = np.random.default_rng(SEED).uniform(
        -1, 1, (4, 256, 256, 3)).astype(np.float32)
    out["perturb_tier"] = perturb_tier(torch, device, images, name_and_limit)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_layouts_")
    try:
        out["cli"] = layout_cli(tmp, name_and_limit)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = check_kernels(torch, device, layouts=True)
    return rows, out


def kernels_line(rows, launches, train_launches, fused_launches):
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        path = [r for r in mine if r["calls"]]
        backward = base_name(name) in BACKWARD_KERNELS
        bf16 = name.endswith(BF16)

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
        bf16_tol = ("bf16 outputs within 2 bf16 ulps of the larger "
                    f"magnitude, never below {KERNEL_TOL}")
        if backward:
            entry.update(
                launches_per_step=train_launches[name] // TRAIN_STEPS,
                tolerance={"dx_abs": bf16_tol if bf16 else KERNEL_TOL,
                           "dscale_dbias_share_of_sum_abs": REDUCTION_TOL},
                dx_max_abs_err=max(r["dx_max_abs_err"] for r in mine),
                reduction_rel_err=max(r["reduction_rel_err"] for r in mine),
                per="sum over the kernel's calls in one batch-1 256^2 train "
                    "step; launches over the "
                    f"{'bf16' if bf16 else 'train'} phase's {TRAIN_STEPS} "
                    "train steps")
        else:
            entry.update(
                launches_per_forward=launches[name] // MAIN_PATH_FORWARDS,
                train_launches=train_launches[name],
                tolerance=(f"{bf16_tol}; statistics {KERNEL_TOL} abs" if bf16
                           else KERNEL_TOL),
                per="sum over the kernel's calls in one batch-1 256^2 "
                    "forward; launches over the "
                    f"{FORWARD_PATHS.get(name, 'serve')} phase's "
                    f"{MAIN_PATH_FORWARDS} forwards")
            if base_name(name) in FORWARD_KERNELS:
                entry.update(
                    per_train_step=per_path(rows, (name,))[name][
                        "per_train_step"],
                    launches_per_call=[
                        r["launches_per_call"]["count"]
                        if isinstance(r["launches_per_call"], dict)
                        else r["launches_per_call"] for r in mine])
            if name in UPSAMPLE_PASSES:
                entry.update(
                    bound_route=f"{UPSAMPLE_ROUTE[name]} on the tensor cores",
                    f32_fma_bound_ms=sum(r["bounds"]["f32_fma_ms"] * r["calls"]
                                         for r in path))
        if not bf16:
            entry["launches_per_fusedprop_step"] = (fused_launches[name]
                                                    // TRAIN_STEPS)
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
    with phase("train_options"):
        fused_launches, options_summary = train_options(torch, device,
                                                        name_and_limit)
    log(f"train_options summary on {name_and_limit}: "
        f"{json.dumps(options_summary)}")
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
    del engine
    with phase("bf16"):
        bf16_rows, bf16_launches, bf16_train_launches, bf16_summary = \
            bf16_phase(torch, device, name_and_limit, summary, train_summary)
    log(f"bf16 summary on {name_and_limit}: {json.dumps(bf16_summary)}")
    with phase("driver"):
        driver_summary = driver(torch, device, name_and_limit)
    log(f"driver summary on {name_and_limit}: {json.dumps(driver_summary)}")
    with phase("obs"):
        obs_summary = obs(torch, device, name_and_limit)
    log(f"obs summary on {name_and_limit}: {json.dumps(obs_summary)}")
    with phase("layouts"):
        layout_rows, layouts_summary = layouts(torch, device, name_and_limit)
    log(f"layouts summary on {name_and_limit}: "
        f"{json.dumps(layouts_summary)}")
    launches["upsample_int8"] = int8_launches["int8_fused"]["upsample_int8"]
    for name in KERNELS:
        if name.endswith(BF16):
            launches[name] = bf16_launches[name]
            train_launches[name] = bf16_train_launches[name]
    print(kernels_line(rows + bf16_rows + layout_rows, launches,
                       train_launches, fused_launches), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = (graph_check_child() if sys.argv[1:] == [GRAPH_CHECK]
                else main())
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
