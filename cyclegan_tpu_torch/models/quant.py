"""Per-output-channel symmetric int8 weight-only quantization of a
generator state, the weight format of the quantized serving tiers (the
JAX package's ``serve/engine.py:quantize_params_int8`` and its
dequantize helpers). The engine quantizes and widens with it; convert.py
maps its format onto the JAX package's quantized tree."""

from __future__ import annotations

from typing import Mapping

import torch

# Suffixes of a quantized kernel's two entries in a quantized state.
QUANT_KEYS = ("int8_q", "int8_scale")


def quantize_state_int8(state: Mapping[str, torch.Tensor]) -> dict:
    """Per-output-channel symmetric int8 quantization of every float tensor
    with 2 or more dimensions (the conv kernels; 1-D norm scales and
    biases stay f32), with the JAX package's ``quantize_params_int8``
    operations in its order, so both give the same int8 values and scales.
    A kernel ``key`` becomes ``key.int8_q`` (int8, its layout and memory
    format) and ``key.int8_scale`` (f32, size 1 on every axis but the
    output channels': axis 0 of an OIHW conv ``weight``, the last axis of
    the HWIO transposed-conv ``kernel``)."""
    out = {}
    for key, w in state.items():
        if w.dim() < 2 or not w.is_floating_point():
            out[key] = w
            continue
        axis = w.dim() - 1 if key.endswith(".kernel") else 0
        dims = tuple(d for d in range(w.dim()) if d != axis)
        with torch.no_grad():
            scale = w.abs().amax(dim=dims, keepdim=True) / 127.0
            scale = torch.where(scale > 0, scale,
                                torch.ones_like(scale)).to(torch.float32)
            q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        out[f"{key}.int8_q"] = q
        out[f"{key}.int8_scale"] = scale
    return out


def _dequantize(qstate: Mapping[str, torch.Tensor], keep) -> dict:
    """``qstate`` with each quantized kernel widened to f32 under its own
    key, except those whose ``int8_q`` key ``keep`` accepts."""
    out = {}
    for key, v in qstate.items():
        base, _, leaf = key.rpartition(".")
        if leaf not in QUANT_KEYS or keep(key):
            out[key] = v
        elif leaf == "int8_q":
            # int8 * f32 promotes to f32: q widened, then one rounding, as
            # the JAX package's q.astype(f32) * scale; one kernel a leaf.
            out[base] = v * qstate[f"{base}.int8_scale"]
    return out


def dequantize_state(qstate: Mapping[str, torch.Tensor]) -> dict:
    """Inverse of ``quantize_state_int8``, run per flush by the int8 tier:
    the default layout's state with every kernel widened to f32."""
    return _dequantize(qstate, lambda key: False)


def dequantize_state_except_upsample(qstate: Mapping[str, torch.Tensor]) -> dict:
    """The int8_fused tier's widening: every quantized kernel except the
    upsample kernels (``ConvTranspose_0``, as the JAX package's
    ``dequantize_params_except_upsample`` keys on), which stay int8 with
    their scales, the state of ``upsample_impl="zeroskip_fused_int8"``."""
    return _dequantize(qstate, lambda key: ".ConvTranspose_0." in key)
