"""Image conversion for output (the JAX package's utils/plotting.py)."""

from __future__ import annotations

import numpy as np


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return np.clip((np.asarray(x, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)
