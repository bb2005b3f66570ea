"""Bucketed generator inference (the JAX package's serve/engine.py,
base tier).

A flush of preprocessed images runs at a (size, batch) bucket: the
ragged tail is zero-padded up to the smallest batch bucket that holds it,
and ``run`` returns the padded outputs with the count of valid rows, the
JAX engine's contract. ``with_cycle`` runs the cycle generator on the
translation too, for panels.

PyTorch runs eagerly, so there is no program to compile per bucket; the
bucket grammar still bounds the shapes the kernels see.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from cyclegan_tpu_torch.config import ModelConfig
from cyclegan_tpu_torch.models.generator import ResNetGenerator
from cyclegan_tpu_torch.utils.device import resolve_device

DEFAULT_BATCH_BUCKETS: Tuple[int, ...] = (1, 8)
DEFAULT_SIZES: Tuple[int, ...] = (256,)


def build_generator(model_cfg: ModelConfig, state: Mapping[str, torch.Tensor],
                    device="cuda") -> ResNetGenerator:
    """The served generator with ``state`` (a port state_dict, see
    convert.py) loaded, in eval mode."""
    gen = ResNetGenerator(model_cfg.generator, model_cfg.channels,
                          model_cfg.channels, device=resolve_device(device))
    gen.load_state_dict(state)
    return gen.eval()


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Batch buckets (flush sizes) and size buckets (resolutions) served."""

    batch_buckets: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS
    sizes: Tuple[int, ...] = DEFAULT_SIZES
    with_cycle: bool = False

    def __post_init__(self):
        if not self.batch_buckets or not self.sizes:
            raise ValueError("serve buckets must be non-empty")
        if any(b <= 0 for b in self.batch_buckets) or any(
                s <= 0 for s in self.sizes):
            raise ValueError("serve buckets must be positive")


class InferenceEngine:
    """The generator(s) of one checkpoint on one device, behind the bucket
    grammar. ``run`` returns device tensors; the caller fetches them."""

    def __init__(self, model_cfg: ModelConfig,
                 fwd_state: Mapping[str, torch.Tensor],
                 bwd_state: Optional[Mapping[str, torch.Tensor]] = None, *,
                 serve_cfg: ServeConfig = ServeConfig(), device="cuda"):
        if serve_cfg.with_cycle and bwd_state is None:
            raise ValueError("with_cycle=True needs the cycle generator's "
                             "weights (bwd_state)")
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.serve_cfg = serve_cfg
        self.generator = build_generator(model_cfg, fwd_state, self.device)
        self.cycle_generator = (
            build_generator(model_cfg, bwd_state, self.device)
            if serve_cfg.with_cycle else None)
        self._batch_buckets = tuple(sorted(set(serve_cfg.batch_buckets)))
        self._sizes = tuple(sorted(set(serve_cfg.sizes)))

    @property
    def max_batch(self) -> int:
        return self._batch_buckets[-1]

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

    @torch.inference_mode()
    def run(self, batch_np: np.ndarray, size: Optional[int] = None):
        """Run one flush: ``batch_np`` float32 [n, size, size, 3], n <=
        max_batch, already preprocessed. Returns (outputs, n_valid):
        ``outputs`` is (fake,) or (fake, cycled), tensors on the engine's
        device still padded to the bucket; the first n_valid rows are
        real."""
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
        x = x.to(self.device)
        fake = self.generator(x)
        if self.cycle_generator is None:
            return (fake,), n
        return (fake, self.cycle_generator(fake)), n

