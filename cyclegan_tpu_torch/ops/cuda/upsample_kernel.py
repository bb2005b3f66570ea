"""Zero-skip upsample forward (3x3/s2 SAME transposed conv -> instance norm
-> ReLU -> reflect-pad): the CUDA kernels' wrappers and their plain
versions, with f32 weights (K5) and with int8 weights (K6).

K5 (``csrc/upsample.cu``) replaces the TPU kernel
``cyclegan_tpu/ops/pallas/upsample_kernel.py:_forward``. Both versions map
NHWC f32 ``x`` [N, H, W, Cin] and the flax HWIO kernel [3, 3, Cin, Cout],
applied without a flip, to ``(y, mean, inv)`` with ``y``
[N, 2H+2p, 2W+2p, Cout]; with ``keep_conv=True`` also the pre-norm
transposed-conv output [N, 2H, 2W, Cout], which the training path keeps
for the backward (ops/upsample.py).

K6 (the same source) replaces ``_forward_int8``: the kernel arrives as
int8 [3, 3, Cin, Cout] with its f32 per-output-channel scale (Cout values,
as [Cout] or as the quantized tree's [1, 1, 1, Cout]), the weights widen
to f32 inside the kernel and each output phase is multiplied by the scale
after its C_in and tap sum. It is forward-only and returns ``(y, mean,
inv)``, and also its pre-norm output under ``keep_conv=True``.

On the card both run one GEMM kernel on the tensor cores in split TF32
that also reduces the norm statistics, then the epilogue kernel's apply
pass: two launches, on a plan from ``upsample_plan``.
"""

from __future__ import annotations

import dataclasses

import torch

from cyclegan_tpu_torch.ops.cuda import LAUNCHES, build
from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import (
    check_pad,
    instance_norm_act_pad_plain,
)
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
    SMEM_PER_BLOCK,
    _sm_count,
    check_activation,
    check_param,
    stream_scratch,
)

# The kernel's tiling (csrc/upsample.cu, which refuses a plan that differs):
# a patch of input pixels (one m16 MMA tile a patch row); output channels a
# block; input channels a stage; cp.async stages.
UPSAMPLE_PATCH = (8, 16)
UPSAMPLE_TILE = 32
UPSAMPLE_DEPTH = 16
UPSAMPLE_STAGES = 3
# Shared memory of a staged patch with its one-pixel halo (20 floats a
# pixel), and of a staged kernel row of the tile (f32: 40 floats; int8:
# 48 bytes): the paddings that keep fragment loads on distinct banks.
_X_STAGE_BYTES = 4 * (UPSAMPLE_PATCH[0] + 1) * (UPSAMPLE_PATCH[1] + 1) * (
    UPSAMPLE_DEPTH + 4)
_W_ROW_BYTES = {False: 4 * (UPSAMPLE_TILE + 8), True: UPSAMPLE_TILE + 16}
# The kernel's static shared memory: per-channel (count, mean, M2) of its
# two row warps, and the last-block flag.
UPSAMPLE_STATIC_SMEM = 3 * 2 * UPSAMPLE_TILE * 4 + 4


def conv_transpose_zeroskip(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The transposed conv as four output phases, each a sum of taps over
    the un-dilated input with x[-1] = 0: [N, H, W, Cin] x [3, 3, Cin, Cout]
    -> [N, 2H, 2W, Cout]. Pixel (2p+r, 2q+s) comes from phase (r, s)."""
    n, h, w, _ = x.shape
    cout = kernel.shape[-1]
    # One leading zero row and column: xp[i + 1, j + 1] = x[i, j].
    xp = torch.nn.functional.pad(x, (0, 0, 1, 0, 1, 0))
    prev_prev = xp[:, :h, :w]      # x[p-1, q-1]
    prev_row = xp[:, :h, 1:]       # x[p-1, q]
    prev_col = xp[:, 1:, :w]       # x[p, q-1]
    here = x                       # x[p, q]
    ee = (prev_prev @ kernel[0, 0] + prev_row @ kernel[0, 2]
          + prev_col @ kernel[2, 0] + here @ kernel[2, 2])
    eo = prev_row @ kernel[0, 1] + here @ kernel[2, 1]
    oe = prev_col @ kernel[1, 0] + here @ kernel[1, 2]
    oo = here @ kernel[1, 1]
    y = torch.stack([ee, eo, oe, oo], dim=-1).reshape(n, h, w, cout, 2, 2)
    return y.permute(0, 1, 4, 2, 5, 3).reshape(n, 2 * h, 2 * w, cout)


def upsample_norm_relu_pad_plain(x: torch.Tensor, kernel: torch.Tensor,
                                 scale: torch.Tensor, bias: torch.Tensor,
                                 pad: int = 0, eps: float = 1e-3,
                                 keep_conv: bool = False):
    """Plain PyTorch version of the upsample kernel."""
    conv_out = conv_transpose_zeroskip(x, kernel)
    y, mean, inv = instance_norm_act_pad_plain(conv_out, scale, bias, pad,
                                               0.0, eps)
    return (y, mean, inv, conv_out) if keep_conv else (y, mean, inv)


def check_int8_kernel(kernel_q: torch.Tensor, kernel_scale: torch.Tensor,
                      cin: int) -> int:
    """Raise unless ``kernel_q`` is an int8 [3, 3, cin, Cout] kernel and
    ``kernel_scale`` holds Cout f32 scales; return Cout. A kernel of
    another type raises TypeError, as the JAX package's entry does."""
    if kernel_q.dtype != torch.int8:
        raise TypeError(
            f"kernel_q must be int8, got {kernel_q.dtype}: pass the quantized "
            "weights, not a dequantized kernel")
    if kernel_q.dim() != 4 or tuple(kernel_q.shape[:3]) != (3, 3, cin):
        raise ValueError(f"int8 upsample kernel must be [3, 3, {cin}, Cout], "
                         f"got {tuple(kernel_q.shape)}")
    cout = kernel_q.shape[3]
    if kernel_scale.numel() != cout or kernel_scale.dtype != torch.float32:
        raise ValueError(f"kernel_scale must hold {cout} float32 scales, got "
                         f"{kernel_scale.dtype} {tuple(kernel_scale.shape)}")
    return cout


def upsample_norm_relu_pad_int8_plain(x: torch.Tensor, kernel_q: torch.Tensor,
                                      kernel_scale: torch.Tensor,
                                      scale: torch.Tensor, bias: torch.Tensor,
                                      pad: int = 0, eps: float = 1e-3,
                                      keep_conv: bool = False):
    """Plain PyTorch version of the int8 upsample kernel: the phases over
    the widened kernel, then the scale, then the norm tail."""
    cout = check_int8_kernel(kernel_q, kernel_scale, x.shape[-1])
    conv_out = (conv_transpose_zeroskip(x, kernel_q.to(x.dtype))
                * kernel_scale.reshape(cout))
    y, mean, inv = instance_norm_act_pad_plain(conv_out, scale, bias, pad,
                                               0.0, eps)
    return (y, mean, inv, conv_out) if keep_conv else (y, mean, inv)


@dataclasses.dataclass(frozen=True)
class UpsamplePlan:
    """How one call of the upsample GEMM kernel splits its work. Block
    ``b`` of the grid's first dimension owns patch ``b % patches`` of
    sample ``b // patches`` (``patch_origin``) and, along the second, the
    output channels ``[tile * j, tile * (j + 1))``; it computes all four
    output phases of the patch's in-image pixels, stepping through Cin
    ``depth`` channels at a time through ``stages`` cp.async stages in
    ``smem_bytes`` of dynamic shared memory. ``partial_shape`` is the
    [N, patches, Cout] scratch of each block's (mean, M2) partial;
    ``tickets`` the int32 counters, one a (sample, channel tile)."""
    patch_rows: int
    patch_cols: int
    patches_h: int
    patches_w: int
    tile: int
    depth: int
    stages: int
    smem_bytes: int
    grid: tuple
    partial_shape: tuple
    tickets: int
    waves: int

    @property
    def patches(self) -> int:
        return self.patches_h * self.patches_w

    def patch_origin(self, block: int) -> tuple[int, int, int]:
        """(sample, first row, first column) of the patch of grid block
        ``block``, as the kernel computes it."""
        sample, patch = divmod(block, self.patches)
        return (sample, (patch // self.patches_w) * self.patch_rows,
                (patch % self.patches_w) * self.patch_cols)

    def launch_args(self) -> tuple:
        """The C launchers' plan arguments after vec, in their order."""
        return (self.patch_rows, self.patch_cols, self.tile, self.depth,
                self.stages, self.smem_bytes)


def upsample_plan(n: int, h: int, w: int, cin: int, cout: int,
                  sm_count: int, int8: bool = False) -> UpsamplePlan:
    """The upsample kernel's plan for x [n, h, w, cin] and a [3, 3, cin,
    cout] kernel (int8 for K6) on a card of ``sm_count`` SMs.

    The tiling is the kernel's own (a patch of 8 x 16 input pixels, 32
    output channels, 16 input channels a stage, 3 stages). A block takes
    one SM (its 256 threads use up to 255 registers each), so ``waves`` is
    the grid over the SM count, rounded up. Patches tile each sample's
    H x W, the last row and column of them clipped at the image's edge."""
    rows, cols = UPSAMPLE_PATCH
    patches_h, patches_w = -(-h // rows), -(-w // cols)
    tiles = -(-cout // UPSAMPLE_TILE)
    blocks = n * patches_h * patches_w * tiles
    smem = UPSAMPLE_STAGES * (_X_STAGE_BYTES
                              + 9 * UPSAMPLE_DEPTH * _W_ROW_BYTES[int8])
    if smem + UPSAMPLE_STATIC_SMEM > SMEM_PER_BLOCK:
        raise ValueError(f"upsample_plan: {smem} bytes of shared memory")
    return UpsamplePlan(
        patch_rows=rows, patch_cols=cols, patches_h=patches_h,
        patches_w=patches_w, tile=UPSAMPLE_TILE, depth=UPSAMPLE_DEPTH,
        stages=UPSAMPLE_STAGES, smem_bytes=smem,
        grid=(n * patches_h * patches_w, tiles),
        partial_shape=(n, patches_h * patches_w, cout), tickets=n * tiles,
        waves=-(-blocks // sm_count))


def upsample_vec(cin: int, cout: int, int8: bool, *tensors: torch.Tensor) -> int:
    """4 (16-byte copies) where Cin % 4 == 0, Cout fills 16-byte kernel
    rows (% 4 for f32, % 16 for int8) and every tensor starts on a 16-byte
    boundary; else 1 (4-byte copies of x and f32 weights, byte loads of
    int8 ones)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    whole = cin % 4 == 0 and cout % (16 if int8 else 4) == 0
    return 4 if whole and aligned else 1


def _upsample_launch(name: str, x: torch.Tensor, kernel_args: list,
                     scale: torch.Tensor, bias: torch.Tensor, cout: int,
                     pad: int, eps: float, int8: bool):
    """Plan, allocate and launch either kernel, whose weights lead
    ``kernel_args``; (y, mean, inv, conv_out)."""
    n, h, w, cin = x.shape
    weights = kernel_args[0]
    check_pad((n, 2 * h, 2 * w, cout), pad)
    if n * 4 * h * w * cout >= 2**31 or weights.numel() >= 2**31:
        raise ValueError(f"{name}: unsupported size {tuple(x.shape)} x "
                         f"{tuple(weights.shape)}")
    plan = upsample_plan(n, h, w, cin, cout, _sm_count(x.device.index), int8)
    conv_out = torch.empty((n, 2 * h, 2 * w, cout), device=x.device,
                           dtype=x.dtype)
    y = torch.empty((n, 2 * h + 2 * pad, 2 * w + 2 * pad, cout),
                    device=x.device, dtype=x.dtype)
    part = torch.empty((2, *plan.partial_shape), device=x.device,
                       dtype=torch.float32)
    stats = torch.empty((2, n, cout), device=x.device, dtype=torch.float32)
    vec = upsample_vec(cin, cout, int8, x, weights)
    # Zero at every launch on the stream: the last block of each (sample,
    # channel tile) sets its ticket back to 0.
    tickets = stream_scratch(x, "upsample_tickets", plan.tickets, torch.int32)
    status = getattr(build.library(), name)(
        x.data_ptr(), *[t.data_ptr() for t in kernel_args], scale.data_ptr(),
        bias.data_ptr(), conv_out.data_ptr(), y.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), tickets.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), n, h, w, cin, cout, pad,
        float(eps), vec, *plan.launch_args(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, name)
    return y, stats[0], stats[1], conv_out


def upsample_norm_relu_pad_cuda(x: torch.Tensor, kernel: torch.Tensor,
                                scale: torch.Tensor, bias: torch.Tensor,
                                pad: int = 0, eps: float = 1e-3,
                                keep_conv: bool = False):
    """Launch the upsample kernel (the split-TF32 phase GEMM with the norm
    statistics in its epilogue, then the epilogue kernel's apply) on the
    current stream."""
    check_activation(x, "upsample_norm_relu_pad")
    n, h, w, cin = x.shape
    if kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, cin):
        raise ValueError(f"upsample kernel must be [3, 3, {cin}, Cout], got "
                         f"{tuple(kernel.shape)}")
    cout = kernel.shape[3]
    check_param(kernel, (3, 3, cin, cout), x, "upsample kernel")
    check_param(scale, (cout,), x, "upsample scale")
    check_param(bias, (cout,), x, "upsample bias")
    y, mean, inv, conv_out = _upsample_launch(
        "cg_upsample_forward", x, [kernel], scale, bias, cout, pad, eps,
        int8=False)
    LAUNCHES["upsample"] += 1
    return (y, mean, inv, conv_out) if keep_conv else (y, mean, inv)


def upsample_norm_relu_pad_int8_cuda(x: torch.Tensor, kernel_q: torch.Tensor,
                                     kernel_scale: torch.Tensor,
                                     scale: torch.Tensor, bias: torch.Tensor,
                                     pad: int = 0, eps: float = 1e-3,
                                     keep_conv: bool = False):
    """Launch the int8 upsample kernel (the phase GEMM over the int8
    kernel, widened as it loads and scaled per output channel at the
    store, then the norm tail) on the current stream."""
    check_activation(x, "upsample_norm_relu_pad_int8")
    n, h, w, cin = x.shape
    cout = check_int8_kernel(kernel_q, kernel_scale, cin)
    if kernel_q.device != x.device or not kernel_q.is_contiguous():
        raise ValueError(f"int8 upsample kernel: expected contiguous on "
                         f"{x.device}, got {kernel_q.device}")
    kernel_scale = kernel_scale.reshape(cout)
    check_param(kernel_scale, (cout,), x, "int8 upsample kernel_scale")
    check_param(scale, (cout,), x, "upsample scale")
    check_param(bias, (cout,), x, "upsample bias")
    y, mean, inv, conv_out = _upsample_launch(
        "cg_upsample_int8_forward", x, [kernel_q, kernel_scale], scale,
        bias, cout, pad, eps, int8=True)
    LAUNCHES["upsample_int8"] += 1
    return (y, mean, inv, conv_out) if keep_conv else (y, mean, inv)
