"""Synthetic images: the port's own copy of the JAX package's
``data/sources.py`` ``SyntheticSource``.

Index-seeded numpy blobs (an 8x8 grid of random colours, upscaled, plus
Gaussian noise), so that every run, and the JAX package's
``main.py --data_source synthetic``, sees the same images without files.
"""

from __future__ import annotations

import zlib

import numpy as np

SPLITS = ("trainA", "trainB", "testA", "testB")


def split_tag(split: str) -> int:
    """Stable cross-process tag for a split name (crc32, not Python's
    salted ``hash``)."""
    return zlib.crc32(split.encode()) & 0xFFFF


class SyntheticSource:
    """Deterministic synthetic uint8 RGB images, index-seeded."""

    def __init__(self, train_size: int = 64, test_size: int = 16,
                 image_size: int = 256):
        self.name = "synthetic"
        self._sizes = {"trainA": train_size, "trainB": train_size,
                       "testA": test_size, "testB": test_size}
        self._hw = image_size

    def split_size(self, split: str) -> int:
        return self._sizes[split]

    def load(self, split: str, index: int) -> np.ndarray:
        """One uint8 [H, W, 3] image."""
        seed = split_tag(split) * 100003 + index
        rng = np.random.RandomState(seed % (2**31))
        hw = self._hw
        low = rng.randint(0, 256, size=(8, 8, 3), dtype=np.uint8).astype(np.float32)
        reps = (hw + 7) // 8
        img = np.kron(low, np.ones((reps, reps, 1), np.float32))[:hw, :hw]
        img += rng.randn(hw, hw, 3) * 8.0
        return np.clip(img, 0, 255).astype(np.uint8)
