"""Conv epilogue (instance norm -> LeakyReLU -> reflect-pad) forward and
backward: the CUDA kernels' wrappers and their plain versions.

The forward kernel (``csrc/instance_norm.cu``, the instance-norm forward
kernel with a pad and a slope) replaces the TPU kernel
``cyclegan_tpu/ops/pallas/epilogue_kernel.py:_forward``. Both versions map
NHWC f32 or bf16 ``x`` [N, H, W, C] to ``(y, mean, inv)`` with ``y`` the
[N, H+2p, W+2p, C] tf-REFLECT pad of
``max(t, 0) + slope * min(t, 0)``, ``t`` the instance norm of ``x``. On
the card it is one launch, on a plan from ``norm_kernel.forward_plan``.

The backward kernel (``csrc/norm_backward.cu``) replaces
``cyclegan_tpu/ops/pallas/epilogue_kernel.py:_backward``. Both versions
take the forward's inputs and statistics and the cotangent ``g`` of the
padded ``y``, fold ``g`` back onto the interior (the transpose of the
reflect pad), apply the activation's mask (``pre > 0 ? g : slope * g``,
``pre`` recomputed from ``x`` and the statistics) and then the instance
norm's VJP, and return ``(dx, dscale_nc, dbias_nc)`` as the instance-norm
backward does.

In bf16 both keep the JAX kernels' cast points (``norm_kernel.py``): the
activation and the pad act on the f32 normalised values and ``y`` is
rounded once; the cotangent is widened before its fold, and the mask comes
from the f32 pre-activation recomputed from ``x``, never from the stored
bf16 output.
"""

from __future__ import annotations

import torch

from cyclegan_tpu_torch.ops.cuda import LAUNCHES, build
from cyclegan_tpu_torch.ops.cuda.norm_kernel import (
    ELEMENT_BYTES,
    H100_SM_COUNT,
    check_activation,
    check_backward_inputs,
    check_param,
    forward_launch,
    forward_plan,
    instance_norm_backward_plain,
    instance_norm_compute,
    launch_backward_plan,
    launch_name,
    widened,
)
from cyclegan_tpu_torch.ops.padding import reflect_pad


def check_pad(shape, pad: int) -> None:
    """A reflect pad needs pad < H and pad < W (the border is not
    repeated)."""
    if pad < 0 or pad >= min(shape[1], shape[2]):
        raise ValueError(f"reflect pad {pad} needs 0 <= pad < min(H, W) for "
                         f"input {tuple(shape)}")


def epilogue_eligible(shape, dtype, pad: int,
                      sm_count: int = H100_SM_COUNT) -> bool:
    """Whether the epilogue kernels (K3 forward, K4 backward) take an
    [N, H, W, C] input of ``dtype`` with a reflect pad of ``pad``: a pure
    function of the shape, the dtype and the pad, decided before any
    launch, on the plan the wrapper would launch on an H100 (132 SMs).
    The pad must leave an interior row and column (pad < min(H, W)); a
    bf16 input needs C a multiple of 8 (the bf16 kernels' 16-byte
    accesses); the padded output must be indexable in 32 bits; and
    ``forward_plan`` must find a tile and a wave count whose slabs fit the
    card's shared memory (K4's ``backward_plan`` always has one). It is
    the port's counterpart of the JAX package's VMEM test
    (``ops/pallas/epilogue_kernel.py`` ``epilogue_eligible``)."""
    # float64 (the references' type, on the plain versions) decides as f32.
    esize = {**ELEMENT_BYTES, torch.float64: 4}.get(dtype)
    if len(shape) != 4 or esize is None:
        return False
    n, h, w, c = (int(d) for d in shape)
    if min(n, h, w, c) < 1 or pad < 0 or (pad and pad >= min(h, w)):
        return False
    if n * (h + 2 * pad) * (w + 2 * pad) * c >= 2**31:
        return False
    vec = 16 // esize
    if c % vec:
        if esize == 2:
            return False
        vec = 1
    try:
        forward_plan(n, h, w, c, pad, vec, sm_count, esize)
    except ValueError:
        return False
    return True


def leaky_relu(t: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.clamp_min(t, 0.0) + slope * torch.clamp_max(t, 0.0)


def instance_norm_act_pad_plain(x: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor, pad: int,
                                negative_slope: float = 0.0,
                                eps: float = 1e-3):
    """Plain PyTorch version of the epilogue kernel."""
    check_pad(x.shape, pad)
    y, mean, inv = instance_norm_compute(x, scale, bias, eps)
    return (reflect_pad(leaky_relu(y, negative_slope), pad).to(x.dtype),
            mean, inv)


def reflect_pad_transpose(g: torch.Tensor, pad: int) -> torch.Tensor:
    """Transpose of ``reflect_pad``: fold [N, H+2p, W+2p, C] back onto
    [N, H, W, C], adding each border band onto the interior row (then
    column) it was copied from, as the JAX package's
    ``_reflect_transpose_2d`` does."""
    if pad == 0:
        return g
    h, w = g.shape[1] - 2 * pad, g.shape[2] - 2 * pad
    rows = g[:, pad:pad + h].clone()
    for d in range(1, pad + 1):
        rows[:, d] += g[:, pad - d]
        rows[:, h - 1 - d] += g[:, pad + h - 1 + d]
    out = rows[:, :, pad:pad + w].clone()
    for d in range(1, pad + 1):
        out[:, :, d] += rows[:, :, pad - d]
        out[:, :, w - 1 - d] += rows[:, :, pad + w - 1 + d]
    return out


def instance_norm_act_pad_backward_plain(x: torch.Tensor, scale: torch.Tensor,
                                         bias: torch.Tensor, mean: torch.Tensor,
                                         inv: torch.Tensor, g: torch.Tensor,
                                         pad: int, negative_slope: float = 0.0):
    """Plain PyTorch version of the epilogue backward kernel."""
    check_pad(x.shape, pad)
    g = reflect_pad_transpose(widened(g), pad)
    pre = ((widened(x) - mean[:, None, None, :]) * inv[:, None, None, :]
           * scale + bias)
    g = torch.where(pre > 0, g, negative_slope * g)
    return instance_norm_backward_plain(x, scale, mean, inv, g)


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
    y = torch.empty((n, h + 2 * pad, w + 2 * pad, c), device=x.device,
                    dtype=x.dtype)
    mean, inv = forward_launch(
        "cg_epilogue_forward", x, scale, bias, y, pad,
        (n, h, w, c, pad, float(negative_slope), float(eps)))
    LAUNCHES[launch_name("epilogue", x)] += 1
    return y, mean, inv


def instance_norm_act_pad_backward_cuda(x: torch.Tensor, scale: torch.Tensor,
                                        bias: torch.Tensor, mean: torch.Tensor,
                                        inv: torch.Tensor, g: torch.Tensor,
                                        pad: int, negative_slope: float = 0.0):
    """Launch the epilogue backward kernel on the current stream."""
    check_pad(x.shape, pad)
    n, h, w, c = x.shape
    check_backward_inputs(x, scale, mean, inv, g,
                          (n, h + 2 * pad, w + 2 * pad, c),
                          "instance_norm_act_pad_backward")
    check_param(bias, (c,), x, "instance_norm_act_pad_backward bias")
    dx = torch.empty_like(x)
    dscale_nc, dbias_nc = torch.empty((2, n, c), device=x.device,
                                      dtype=torch.float32)
    plan = launch_backward_plan(x, g, dx)
    lib = build.library()
    status = lib.cg_epilogue_backward(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
        inv.data_ptr(), g.data_ptr(), dx.data_ptr(), dscale_nc.data_ptr(),
        dbias_nc.data_ptr(), n, h, w, c, pad, float(negative_slope),
        *plan.launch_args(), torch.cuda.current_stream(x.device).cuda_stream)
    build.check(status, "cg_epilogue_backward")
    LAUNCHES[launch_name("epilogue_backward", x)] += 1
    return dx, dscale_nc, dbias_nc
