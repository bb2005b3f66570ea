"""Padding, and convolutions with padding semantics, for NHWC tensors.

``reflect_pad`` is tf.pad(mode="REFLECT") over H and W, the JAX package's
``ops/padding.py:reflect_pad``: the border row is not repeated, which is
also what ``torch.nn.functional.pad(mode="reflect")`` does.
``same_pad`` is TensorFlow's SAME padding for a strided convolution,
which puts the odd pixel of the total padding at the bottom and right;
``zero_conv`` is the stride-1 SAME conv of ``pad_mode="zero"``.

``reflect_conv`` is the JAX package's ``reflect_conv`` (``pad_impl=
"fused"``, ``ops/padding.py:99-273``): a stride-1 conv over a
reflect-padded input without the padded copy, computed as the conv's own
zero padding plus four thin border-correction convs over strips of x a
few rows or columns wide. It is a ``torch.autograd.Function`` with the
JAX custom VJP's structure: it saves x and the kernel only, and its
backward is the zero-padded conv's own VJP (``aten.convolution_backward``,
cuDNN on the card) plus the thin corrections' VJPs scattered back onto
their strips. All of it runs on cuDNN convs and torch ops: the JAX package
computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

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


def _conv(x: torch.Tensor, weight: torch.Tensor, pad_h: tuple,
          pad_w: tuple) -> torch.Tensor:
    """Stride-1 conv of an NCHW ``x`` with an OIHW ``weight`` after zero
    padding of (top, bottom) rows and (left, right) columns."""
    if pad_h[0] == pad_h[1] and pad_w[0] == pad_w[1]:
        return F.conv2d(x, weight, padding=(pad_h[0], pad_w[0]))
    return F.conv2d(F.pad(x, (*pad_w, *pad_h)), weight)


def zero_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TensorFlow's stride-1 SAME conv of an NCHW ``x`` (zero padding,
    the odd pixel at the bottom and right), the convs of ``pad_mode=
    "zero"``."""
    kh, kw = weight.shape[-2:]
    pad_h = ((kh - 1) // 2, kh - 1 - (kh - 1) // 2)
    pad_w = ((kw - 1) // 2, kw - 1 - (kw - 1) // 2)
    y = _conv(x, weight, pad_h, pad_w)
    return y if bias is None else y + bias[:, None, None]


def _h_edge(strip: torch.Tensor, wsub: torch.Tensor, p: int) -> torch.Tensor:
    """The missing taps of the p output rows nearest an H edge (JAX
    ``_h_edge_correction``): the mirror-ordered strip of p rows, reflect
    padded along W, under the kernel's first p rows with one-sided zero
    padding (0, p - 1) along H: [N, C, p, W] -> [N, O, p, W]."""
    strip = F.pad(strip, (p, p, 0, 0), mode="reflect")
    return _conv(strip, wsub, (0, p - 1), (0, 0))


def _w_edge(strip: torch.Tensor, wsub: torch.Tensor, p: int) -> torch.Tensor:
    """The missing taps of the p output columns nearest a W edge, rows
    inside the image only (JAX ``_w_edge_correction``): the conv's own zero
    padding (p, p) along H, (0, p - 1) along W: [N, C, H, p] -> [N, O, H, p]."""
    return _conv(strip, wsub, (p, p), (0, p - 1))


def _edges(x: torch.Tensor, weight: torch.Tensor, p: int) -> list:
    """The four (strip, kernel part, closure) of ``reflect_conv``'s border
    corrections over an NCHW ``x`` and OIHW ``weight``, each closure mapping
    (strip, kernel part) to the correction as it is added to the output:
    top, bottom, left, right, in the JAX package's order. Every strip is a
    thin copy of x: rows p..1 reversed, rows H-1-p..H-2, and the same for
    columns."""
    h, w = x.shape[2], x.shape[3]
    flip_h, flip_w = weight.flip(2), weight.flip(3)
    return [
        (x[:, :, 1:p + 1].flip(2), weight[:, :, :p],
         lambda s, k: _h_edge(s, k, p)),
        (x[:, :, h - 1 - p:h - 1], flip_h[:, :, :p],
         lambda s, k: _h_edge(s, k, p).flip(2)),
        (x[:, :, :, 1:p + 1].flip(3), weight[:, :, :, :p],
         lambda s, k: _w_edge(s, k, p)),
        (x[:, :, :, w - 1 - p:w - 1], flip_w[:, :, :, :p],
         lambda s, k: _w_edge(s, k, p).flip(3)),
    ]


def _edge_slices(h: int, w: int, p: int) -> list:
    """Where each correction of ``_edges`` lands in the output."""
    full = slice(None)
    return [(slice(0, p), full), (slice(h - p, h), full),
            (full, slice(0, p)), (full, slice(w - p, w))]


class _ReflectConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, p):
        h, w = x.shape[2], x.shape[3]
        out = _conv(x, weight, (p, p), (p, p))
        for (strip, wsub, fn), (rows, cols) in zip(_edges(x, weight, p),
                                                   _edge_slices(h, w, p)):
            out[:, :, rows, cols] += fn(strip, wsub)
        ctx.save_for_backward(x, weight)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        p = ctx.p
        h, w = x.shape[2], x.shape[3]
        dx, dweight, _ = torch.ops.aten.convolution_backward(
            g, x, weight, None, [1, 1], [p, p], [1, 1], False, [0, 0], 1,
            [True, True, False])
        leaves, outs, cotangents = [], [], []
        with torch.enable_grad():
            for (strip, wsub, fn), (rows, cols) in zip(
                    _edges(x, weight, p), _edge_slices(h, w, p)):
                strip = strip.detach().requires_grad_()
                wsub = wsub.detach().requires_grad_()
                leaves += [strip, wsub]
                outs.append(fn(strip, wsub))
                cotangents.append(g[:, :, rows, cols])
            (ds_t, dk_t, ds_b, dk_b, ds_l, dk_l, ds_r,
             dk_r) = torch.autograd.grad(outs, leaves, cotangents)
        dx[:, :, 1:p + 1] += ds_t.flip(2)
        dx[:, :, h - 1 - p:h - 1] += ds_b
        dx[:, :, :, 1:p + 1] += ds_l.flip(3)
        dx[:, :, :, w - 1 - p:w - 1] += ds_r
        dweight[:, :, :p] += dk_t
        dweight[:, :, -p:] += dk_b.flip(2)
        dweight[:, :, :, :p] += dk_l
        dweight[:, :, :, -p:] += dk_r.flip(3)
        return dx, dweight, None


def reflect_conv(x: torch.Tensor, weight: torch.Tensor, pad: int,
                 bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 VALID conv of an NCHW ``x`` over its reflect pad by
    ``pad``, with an OIHW ``weight`` of (2 pad + 1)^2 taps, without the
    padded copy: equal to ``conv2d(F.pad(x, mode="reflect"), weight)`` to
    f32 rounding (the border sums are re-associated). Needs H, W > 2 pad."""
    kh, kw = weight.shape[-2:]
    if kh != 2 * pad + 1 or kw != 2 * pad + 1:
        raise ValueError(f"reflect_conv needs a (2*pad+1)^2 kernel; got "
                         f"{kh}x{kw} for pad={pad}")
    if min(x.shape[2], x.shape[3]) <= 2 * pad:
        raise ValueError(f"reflect_conv needs H, W > 2*pad; got "
                         f"{x.shape[2]}x{x.shape[3]} for pad={pad}")
    y = _ReflectConv.apply(x, weight, pad)
    return y if bias is None else y + bias[:, None, None]
