"""Per-step scalar accumulation (the JAX package's utils/dicts.py): the
reference's ``append_dict`` and the epoch mean it pairs with."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def append_dict(results: Dict[str, List], new: Dict) -> None:
    """Append each value of ``new`` onto the running lists in ``results``."""
    for k, v in new.items():
        results.setdefault(k, []).append(v)


def mean_dict(results: Dict[str, List]) -> Dict[str, float]:
    """Epoch mean of accumulated per-step scalars."""
    return {k: float(np.mean([np.asarray(v, np.float32) for v in vals]))
            for k, vals in results.items()}
