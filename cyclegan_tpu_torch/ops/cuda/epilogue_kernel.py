"""Conv epilogue forward (instance norm -> LeakyReLU -> reflect-pad): the
CUDA kernel's wrapper and its plain version.

The kernel (``csrc/epilogue.cu``) replaces the TPU kernel
``cyclegan_tpu/ops/pallas/epilogue_kernel.py:_forward``. Both versions map
NHWC f32 ``x`` [N, H, W, C] to ``(y, mean, inv)`` with ``y`` the
[N, H+2p, W+2p, C] tf-REFLECT pad of
``max(t, 0) + slope * min(t, 0)``, ``t`` the instance norm of ``x``.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.ops.cuda import LAUNCHES, build
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
    check_activation,
    check_param,
    instance_norm_plain,
    stats_buffers,
    stats_chunking,
)
from cyclegan_tpu_torch.ops.padding import reflect_pad


def check_pad(shape, pad: int) -> None:
    """A reflect pad needs pad < H and pad < W (the border is not
    repeated)."""
    if pad < 0 or pad >= min(shape[1], shape[2]):
        raise ValueError(f"reflect pad {pad} needs 0 <= pad < min(H, W) for "
                         f"input {tuple(shape)}")


def leaky_relu(t: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.clamp_min(t, 0.0) + slope * torch.clamp_max(t, 0.0)


def instance_norm_act_pad_plain(x: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, pad: int,
                                negative_slope: float = 0.0,
                                eps: float = 1e-3):
    """Plain PyTorch version of the epilogue kernel."""
    check_pad(x.shape, pad)
    y, mean, inv = instance_norm_plain(x, scale, bias, eps)
    return reflect_pad(leaky_relu(y, negative_slope), pad), mean, inv


def instance_norm_act_pad_cuda(x: torch.Tensor, scale: torch.Tensor,
                               bias: torch.Tensor, pad: int,
                               negative_slope: float = 0.0,
                               eps: float = 1e-3):
    """Launch the epilogue kernel on the current stream."""
    check_activation(x, "instance_norm_act_pad")
    check_pad(x.shape, pad)
    n, h, w, c = x.shape
    check_param(scale, (c,), x, "instance_norm_act_pad scale")
    check_param(bias, (c,), x, "instance_norm_act_pad bias")
    rows, chunks = stats_chunking(x, n, h * w, c)
    y = torch.empty((n, h + 2 * pad, w + 2 * pad, c), device=x.device,
                    dtype=x.dtype)
    part_mean, part_m2, mean, inv = stats_buffers(x, n, c, chunks)
    lib = build.library()
    status = lib.cg_epilogue_forward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        part_mean.data_ptr(), part_m2.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), n, h, w, c, pad, float(negative_slope), float(eps),
        rows, chunks, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "cg_epilogue_forward")
    LAUNCHES["epilogue"] += 1
    return y, mean, inv
