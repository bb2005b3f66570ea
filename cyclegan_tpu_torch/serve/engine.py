"""Bucketed generator inference (the JAX package's serve/engine.py).

A flush of preprocessed images runs at a (size, batch) bucket: the
ragged tail is zero-padded up to the smallest batch bucket that holds it,
and ``run`` returns the padded outputs with the count of valid rows, the
JAX engine's contract. ``with_cycle`` runs the cycle generator on the
translation too, for panels.

PyTorch runs eagerly, so there is no program to compile per bucket; the
bucket grammar still bounds the shapes the kernels see.

The base tier serves the layout and the trunk that the config records
(``build_generator``: every ``ModelConfig`` layout field, as the JAX
engine's ``build_generator``), so a ring's ``meta.json`` decides them.

Two optional tiers serve the same weights quantized, as in the JAX
engine. At start-up every conv kernel is quantized once to per-output-
channel symmetric int8 (``models/quant.py``), and only the int8
tensors, their f32 scales and the 1-D norm parameters and biases stay on
the device for those tiers:

- ``int8`` (``ServeConfig(int8_tier=True)``): each flush widens every
  quantized kernel to f32 and runs the served layout over them
  (``dequantize_state``), f32 accumulation everywhere.
- ``int8_fused`` (``ServeConfig(infer_tier=True)``): each flush widens
  every quantized kernel except the two upsample kernels
  (``dequantize_state_except_upsample``), which stay int8 into the int8
  upsample kernel (K6); no f32 copy of them ever exists. As in the JAX
  engine (``:391-395``) the tier forces ``upsample_impl=
  "zeroskip_fused_int8"``. The JAX engine also forces the norms to
  ``auto_fwd``, the forward-only form, which it needs to build its Pallas
  sites without a VJP; the port's kernels run forward-only under
  ``inference_mode`` whatever the impl, so the tier keeps the served
  layout's norms (K1 and K3 in the kernel layout).

A third tier serves another checkpoint, the perturb trunk's (Queue A's
brownout floor in the JAX engine, ``:259``, ``:279-301``, ``:414-440``):
``ServeConfig(perturb_tier=True)`` with ``perturb_params``, a perturb
generator's state_dict. It runs the served layout with
``trunk_impl="perturb"``, unscanned, and ``pad_impl="epilogue"`` coerced
to "fused" (the perturb trunk has no pad site for the epilogue), in the
serving dtype.

``ServeConfig(dtype="bfloat16")`` serves the base tier in bf16 compute
over the same f32 weights (the JAX engine's flax compute-dtype casting;
the outputs come back f32); the quantized tiers stay f32, as in the JAX
engine (``engine.py:365-367``, ``:393``).

``run(..., tier=...)`` selects the tier per flush. The quantized tiers run
the generator's structure through ``torch.func.functional_call`` over a
skeleton on the ``meta`` device, so no f32 weights of theirs stay
resident. ``run`` returns device tensors and does not synchronise; the
pipelined executor (serve/executor.py) fetches them.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from cyclegan_tpu_torch.config import ModelConfig
from cyclegan_tpu_torch.data.augment import preprocess_test
from cyclegan_tpu_torch.models.generator import ResNetGenerator
from cyclegan_tpu_torch.models.modules import compute_dtype
from cyclegan_tpu_torch.models.quant import (
    dequantize_state,
    dequantize_state_except_upsample,
    quantize_state_int8,
)
from cyclegan_tpu_torch.utils.device import resolve_device

DEFAULT_BATCH_BUCKETS: Tuple[int, ...] = (1, 8)
DEFAULT_SIZES: Tuple[int, ...] = (256,)


def build_generator(model_cfg: ModelConfig, state: Mapping[str, torch.Tensor],
                    device="cuda") -> ResNetGenerator:
    """The served generator with ``state`` (a port state_dict, see
    convert.py) loaded, in eval mode, in the config's layout and trunk,
    computing in the config's compute dtype."""
    gen = ResNetGenerator(model_cfg.generator, model_cfg.channels,
                          model_cfg.channels, device=resolve_device(device),
                          dtype=compute_dtype(model_cfg.compute_dtype),
                          **model_cfg.layout)
    gen.load_state_dict(state)
    return gen.eval()


def state_bytes(state: Mapping[str, torch.Tensor]) -> int:
    """Bytes of the tensors of a state."""
    return sum(v.numel() * v.element_size() for v in state.values())


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Batch buckets (flush sizes), size buckets (resolutions), the serving
    dtype and the tiers served, with the JAX ``ServeConfig``'s fields and
    refusals. ``dtype`` is the base tier's compute dtype, "float32" or
    "bfloat16" (the perturb tier's too); ``perturb_tier`` needs the
    engine's ``perturb_params``."""

    batch_buckets: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS
    sizes: Tuple[int, ...] = DEFAULT_SIZES
    dtype: str = "float32"  # "float32" | "bfloat16"
    with_cycle: bool = False
    int8_tier: bool = False
    infer_tier: bool = False
    perturb_tier: bool = False

    def __post_init__(self):
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"serve dtype must be 'float32' or "
                             f"'bfloat16', got {self.dtype!r}")
        if not self.batch_buckets or not self.sizes:
            raise ValueError("serve buckets must be non-empty")
        if any(b <= 0 for b in self.batch_buckets) or any(
                s <= 0 for s in self.sizes):
            raise ValueError("serve buckets must be positive")
        if self.int8_tier and self.with_cycle:
            raise ValueError("int8_tier with with_cycle is unsupported "
                             "(panel traffic serves from the base tier)")
        if self.infer_tier and self.with_cycle:
            raise ValueError("infer_tier with with_cycle is unsupported "
                             "(panel traffic serves from the base tier)")
        if self.perturb_tier and self.with_cycle:
            raise ValueError("perturb_tier with with_cycle is "
                             "unsupported (panel traffic serves from "
                             "the base tier)")


class InferenceEngine:
    """The generator(s) of one checkpoint on one device, behind the bucket
    grammar. ``run`` returns device tensors; the caller fetches them.
    ``run`` may be called from several threads (one per batcher): a lock
    orders the dispatches, which on the card only enqueue work."""

    def __init__(self, model_cfg: ModelConfig,
                 fwd_state: Mapping[str, torch.Tensor],
                 bwd_state: Optional[Mapping[str, torch.Tensor]] = None, *,
                 serve_cfg: ServeConfig = ServeConfig(), device="cuda",
                 perturb_params: Optional[Mapping[str, torch.Tensor]] = None):
        if serve_cfg.with_cycle and bwd_state is None:
            raise ValueError("with_cycle=True needs the cycle generator's "
                             "weights (bwd_state)")
        if serve_cfg.perturb_tier and perturb_params is None:
            raise ValueError(
                "perturb_tier=True needs a perturb-trunk checkpoint "
                "(perturb_params): the perturbative generator's parameter "
                "tree is not the resnet trunk's, so it cannot be derived "
                "from the base weights")
        self.device = resolve_device(device)
        # The serving dtype overrides the checkpoint's compute dtype; the
        # parameter tree does not depend on it.
        self.model_cfg = dataclasses.replace(model_cfg,
                                             compute_dtype=serve_cfg.dtype)
        self.serve_cfg = serve_cfg
        self.generator = build_generator(self.model_cfg, fwd_state, self.device)
        self.cycle_generator = (
            build_generator(self.model_cfg, bwd_state, self.device)
            if serve_cfg.with_cycle else None)
        self._batch_buckets = tuple(sorted(set(serve_cfg.batch_buckets)))
        self._sizes = tuple(sorted(set(serve_cfg.sizes)))
        self._lock = threading.Lock()
        # The quantized tiers: one int8 state, quantized once here from the
        # served weights and shared by both tiers, and per tier a skeleton
        # on the meta device that functional_call runs over it, in f32
        # whatever the serving dtype.
        self._qstate = None
        self._skeletons = {}
        if serve_cfg.int8_tier or serve_cfg.infer_tier:
            self._qstate = quantize_state_int8(self.generator.state_dict())
        fused = {"upsample_impl": "zeroskip_fused_int8"}
        for tier, on, forced in (("int8", serve_cfg.int8_tier, {}),
                                 ("int8_fused", serve_cfg.infer_tier, fused)):
            if on:
                self._skeletons[tier] = ResNetGenerator(
                    self.model_cfg.generator, self.model_cfg.channels,
                    self.model_cfg.channels, device="meta",
                    **{**self.model_cfg.layout, **forced}).eval()
        self.perturb_generator = None
        if serve_cfg.perturb_tier:
            m = self.model_cfg
            self.perturb_cfg = dataclasses.replace(
                m, trunk_impl="perturb", scan_blocks=False,
                pad_impl="fused" if m.pad_impl == "epilogue" else m.pad_impl)
            self.perturb_generator = build_generator(
                self.perturb_cfg, perturb_params, self.device)

    # -- bucket grammar ---------------------------------------------------
    @property
    def max_batch(self) -> int:
        return self._batch_buckets[-1]

    @property
    def sizes(self) -> Tuple[int, ...]:
        return self._sizes

    @property
    def tiers(self) -> Tuple[str, ...]:
        """Tiers this engine serves, cheapest last: "base" always, plus
        "int8", "int8_fused" and "perturb" when they were built."""
        return (("base",) + tuple(t for t in ("int8", "int8_fused")
                                  if t in self._skeletons)
                + (("perturb",) if self.perturb_generator is not None
                   else ()))

    def resolve_tier(self, tier: Optional[str]) -> str:
        """Normalise a request's tier tag. None, "base" and the serving
        dtype's name mean the base tier; "int8" and "int8_fused" need the
        tier to have been built."""
        if tier in (None, "base", self.serve_cfg.dtype):
            return "base"
        if tier == "int8":
            if "int8" not in self._skeletons:
                raise ValueError(
                    "int8 tier requested but the engine was built "
                    "without it (ServeConfig(int8_tier=True))")
            return "int8"
        if tier == "int8_fused":
            if "int8_fused" not in self._skeletons:
                raise ValueError(
                    "int8_fused tier requested but the engine was built "
                    "without it (ServeConfig(infer_tier=True))")
            return "int8_fused"
        if tier == "perturb":
            if self.perturb_generator is None:
                raise ValueError(
                    "perturb tier requested but the engine was built "
                    "without it (ServeConfig(perturb_tier=True) + "
                    "perturb_params)")
            return "perturb"
        raise ValueError(f"unknown serving tier {tier!r} "
                         f"(have {self.tiers})")

    def batch_bucket(self, n: int) -> Optional[int]:
        """Smallest batch bucket holding n requests; None when n exceeds
        the largest bucket (the caller splits the flush)."""
        for b in self._batch_buckets:
            if n <= b:
                return b
        return None

    def size_bucket(self, h: int, w: int) -> int:
        """Smallest resolution bucket covering an (h, w) request; larger
        requests clamp to the largest bucket (they are resized down)."""
        m = max(h, w)
        for s in self._sizes:
            if m <= s:
                return s
        return self._sizes[-1]

    def tier_state(self, tier: str) -> dict:
        """The state a flush of a quantized tier runs on, widened as that
        tier widens it (a new dict of new f32 tensors each call)."""
        if tier == "int8":
            return dequantize_state(self._qstate)
        if tier == "int8_fused":
            return dequantize_state_except_upsample(self._qstate)
        raise ValueError(f"{tier!r} is not a quantized tier")

    def resident_weight_bytes(self, tier: str) -> int:
        """Bytes of weights that the tier keeps on the device: the f32
        state for "base" and "perturb", the int8 state (shared by both
        quantized tiers) for "int8" and "int8_fused"."""
        tier = self.resolve_tier(tier)
        if tier == "base":
            return state_bytes(self.generator.state_dict())
        if tier == "perturb":
            return state_bytes(self.perturb_generator.state_dict())
        return state_bytes(self._qstate)

    # -- the device call --------------------------------------------------
    @torch.inference_mode()
    def run(self, batch_np: np.ndarray, size: Optional[int] = None,
            tier: Optional[str] = None):
        """Run one flush: ``batch_np`` float32 [n, size, size, 3], n <=
        max_batch, already preprocessed. Returns (outputs, n_valid):
        ``outputs`` is (fake,) or (fake, cycled), tensors on the engine's
        device still padded to the bucket; the first n_valid rows are
        real. ``tier`` selects the tier ("base" by default)."""
        tier = self.resolve_tier(tier)
        n = batch_np.shape[0]
        if size is None:
            size = batch_np.shape[1]
        if (size, size) != tuple(batch_np.shape[1:3]):
            raise ValueError(
                f"flush shape {batch_np.shape[1:3]} does not match its size "
                f"bucket {size}; preprocess before run()")
        if size not in self._sizes:
            raise KeyError(f"size {size} is not in the engine's size buckets "
                           f"{self._sizes}")
        bucket = self.batch_bucket(n)
        if bucket is None:
            raise ValueError(f"flush of {n} exceeds the largest batch bucket "
                             f"{self.max_batch}; the batcher must split it")
        if bucket > n:
            batch_np = np.concatenate(
                [batch_np, np.zeros((bucket - n,) + batch_np.shape[1:],
                                    np.float32)])
        x = torch.from_numpy(np.ascontiguousarray(batch_np, np.float32))
        with self._lock:
            x = x.to(self.device)
            if tier == "perturb":
                return (self.perturb_generator(x),), n
            if tier != "base":
                skeleton = self._skeletons[tier]
                state = self.tier_state(tier)
                # A perturb trunk's masks: buffers the skeleton made itself.
                state.update({k: v for k, v in skeleton.named_buffers()
                              if k not in state})
                fake = torch.func.functional_call(skeleton, state, (x,),
                                                  strict=True)
                return (fake,), n
            fake = self.generator(x)
            if self.cycle_generator is None:
                return (fake,), n
            return (fake, self.cycle_generator(fake)), n


def preprocess_request(img: np.ndarray, size: int) -> np.ndarray:
    """Decode-stage preprocessing of one request: the test-time transform
    (half-pixel-centre bilinear resize, then [-1, 1]; data/augment.py)."""
    return preprocess_test(np.asarray(img), size)
