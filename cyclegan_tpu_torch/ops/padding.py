"""Padding for NHWC tensors.

``reflect_pad`` is tf.pad(mode="REFLECT") over H and W, the JAX package's
``ops/padding.py:reflect_pad``: the border row is not repeated, which is
also what ``torch.nn.functional.pad(mode="reflect")`` does.
``same_pad`` is TensorFlow's SAME padding for a strided convolution,
which puts the odd pixel of the total padding at the bottom and right.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC view of an activation -> NCHW view of the same memory (an
    NHWC-contiguous tensor becomes a ``channels_last`` one)."""
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> NHWC-contiguous view (copies only when ``x`` is not
    already ``channels_last``)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the spatial dims of an NHWC tensor by ``pad``."""
    if pad == 0:
        return x
    return to_nhwc(F.pad(to_nchw(x), (pad, pad, pad, pad), mode="reflect"))


def same_pad_amounts(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """(low, high) zero padding of TensorFlow's SAME for one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Zero-pad an NCHW tensor so that a VALID ``kernel``/``stride`` conv
    over it equals TensorFlow's SAME conv over ``x``."""
    top, bottom = same_pad_amounts(x.shape[2], kernel, stride)
    left, right = same_pad_amounts(x.shape[3], kernel, stride)
    return F.pad(x, (left, right, top, bottom))
