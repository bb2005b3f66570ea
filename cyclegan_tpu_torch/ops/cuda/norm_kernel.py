"""Instance norm forward and backward: the CUDA kernels' wrappers and
their plain versions.

The forward kernel (``csrc/instance_norm.cu``) replaces the TPU kernel
``cyclegan_tpu/ops/pallas/norm_kernel.py:_forward``. Both versions take an
NHWC f32 ``x`` and return ``(y, mean, inv)``: ``y`` as ``x``, ``mean`` and
``inv = 1/sqrt(var + eps)`` as [N, C] f32.

The backward kernel (``csrc/norm_backward.cu``) replaces
``cyclegan_tpu/ops/pallas/norm_kernel.py:_backward``. Both versions take
``x``, ``scale``, the forward's ``mean`` and ``inv`` and the cotangent
``g`` of ``y``, and return ``(dx, dscale_nc, dbias_nc)``: ``dx`` as ``x``,
the per-(n, c) partials of dscale and dbias as [N, C] f32, which the caller
sums over N.

This module also holds what the other wrappers share with it: the input
checks and the chunking of the reduction passes.
"""

from __future__ import annotations

import functools

import torch

from cyclegan_tpu_torch.ops.cuda import LAUNCHES, build

# Channels per statistics block: the warp width of csrc/instance_norm.cu.
STATS_CHANNELS = 32
# Fewest H*W rows a statistics chunk takes, so a chunk's partial is worth
# the cost of merging it.
MIN_CHUNK_ROWS = 64
# Statistics blocks wanted per SM, so that every SM has work.
BLOCKS_PER_SM = 4


def instance_norm_plain(x: torch.Tensor, scale: torch.Tensor,
                        bias: torch.Tensor, eps: float = 1e-3):
    """Plain PyTorch instance norm with the kernel's outputs."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    centered = x - mean
    var = (centered * centered).mean(dim=(1, 2), keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = centered * inv * scale + bias
    return y, mean[:, 0, 0, :], inv[:, 0, 0, :]


def instance_norm_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                                 mean: torch.Tensor, inv: torch.Tensor,
                                 g: torch.Tensor):
    """Plain PyTorch instance-norm VJP with the kernel's outputs:
    dx = scale * inv * (g - mean_hw(g) - xhat * mean_hw(g * xhat))."""
    mean, inv = mean[:, None, None, :], inv[:, None, None, :]
    xhat = (x - mean) * inv
    dbias_nc = g.sum(dim=(1, 2))
    dscale_nc = (g * xhat).sum(dim=(1, 2))
    hw = x.shape[1] * x.shape[2]
    dx = scale * inv * (g - dbias_nc[:, None, None, :] / hw
                        - xhat * (dscale_nc[:, None, None, :] / hw))
    return dx, dscale_nc, dbias_nc


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def stats_chunking(x: torch.Tensor, n: int, hw: int, c: int) -> tuple[int, int]:
    """(rows per chunk, chunks) for the statistics pass over [n, hw, c]:
    enough chunks of H*W that the card's SMs all get blocks."""
    channel_tiles = -(-c // STATS_CHANNELS)
    wanted = BLOCKS_PER_SM * _sm_count(x.device.index)
    chunks = max(1, min(-(-wanted // (n * channel_tiles)),
                        hw // MIN_CHUNK_ROWS))
    rows = -(-hw // chunks)
    return rows, -(-hw // rows)


def check_activation(x: torch.Tensor, name: str) -> None:
    """Raise unless ``x`` is what the kernels take: a 4-D NHWC-contiguous
    f32 tensor on the current CUDA device, with fewer than 2**31
    elements."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: kernel input must be on a CUDA device, "
                         f"got {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: input is on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the kernels take float32 (bfloat16 comes "
                        f"with a later slice of the port), got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name}: expected [N, H, W, C], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be NHWC-contiguous")
    if x.numel() == 0 or x.numel() >= 2**31:
        raise ValueError(f"{name}: unsupported size {tuple(x.shape)}")


def check_param(v: torch.Tensor, shape: tuple, like: torch.Tensor,
                name: str) -> None:
    if (tuple(v.shape) != tuple(shape) or v.dtype != torch.float32
            or v.device != like.device or not v.is_contiguous()):
        raise ValueError(
            f"{name}: expected contiguous float32 {tuple(shape)} on "
            f"{like.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")


def check_backward_inputs(x: torch.Tensor, scale: torch.Tensor,
                          mean: torch.Tensor, inv: torch.Tensor,
                          g: torch.Tensor, g_shape: tuple, name: str) -> None:
    """The checks of a backward wrapper: ``x`` and ``g`` as the kernels take
    activations, ``g`` of ``g_shape``, [C] ``scale`` and [N, C] ``mean`` and
    ``inv``."""
    check_activation(x, name)
    check_activation(g, f"{name} cotangent")
    if tuple(g.shape) != tuple(g_shape):
        raise ValueError(f"{name}: cotangent {tuple(g.shape)}, expected "
                         f"{tuple(g_shape)}")
    n, c = x.shape[0], x.shape[3]
    check_param(scale, (c,), x, f"{name} scale")
    check_param(mean, (n, c), x, f"{name} mean")
    check_param(inv, (n, c), x, f"{name} inv")


def stats_buffers(x: torch.Tensor, n: int, c: int, chunks: int):
    """Scratch partials [n, chunks, c] x2 and two [n, c] results (the
    forward's mean and inv, or the backward's dscale and dbias
    partials)."""
    part = torch.empty((2, n, chunks, c), device=x.device, dtype=torch.float32)
    stats = torch.empty((2, n, c), device=x.device, dtype=torch.float32)
    return part[0], part[1], stats[0], stats[1]


def instance_norm_cuda(x: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-3):
    """Launch the instance-norm kernel on the current stream."""
    check_activation(x, "instance_norm")
    n, h, w, c = x.shape
    check_param(scale, (c,), x, "instance_norm scale")
    check_param(bias, (c,), x, "instance_norm bias")
    rows, chunks = stats_chunking(x, n, h * w, c)
    y = torch.empty_like(x)
    part_mean, part_m2, mean, inv = stats_buffers(x, n, c, chunks)
    lib = build.library()
    status = lib.cg_instance_norm_forward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        part_mean.data_ptr(), part_m2.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), n, h * w, c, float(eps), rows, chunks,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "cg_instance_norm_forward")
    LAUNCHES["instance_norm"] += 1
    return y, mean, inv


def instance_norm_backward_cuda(x: torch.Tensor, scale: torch.Tensor,
                                mean: torch.Tensor, inv: torch.Tensor,
                                g: torch.Tensor):
    """Launch the instance-norm backward kernel on the current stream."""
    check_backward_inputs(x, scale, mean, inv, g, x.shape,
                          "instance_norm_backward")
    n, h, w, c = x.shape
    rows, chunks = stats_chunking(x, n, h * w, c)
    dx = torch.empty_like(x)
    part_g, part_gx, dscale_nc, dbias_nc = stats_buffers(x, n, c, chunks)
    lib = build.library()
    status = lib.cg_instance_norm_backward(
        x.data_ptr(), scale.data_ptr(), mean.data_ptr(), inv.data_ptr(),
        g.data_ptr(), dx.data_ptr(), part_g.data_ptr(), part_gx.data_ptr(),
        dscale_nc.data_ptr(), dbias_nc.data_ptr(), n, h * w, c, rows, chunks,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "cg_instance_norm_backward")
    LAUNCHES["instance_norm_backward"] += 1
    return dx, dscale_nc, dbias_nc
