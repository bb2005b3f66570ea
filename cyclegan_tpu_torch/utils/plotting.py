"""Cycle panels, every checkpoint epoch (the JAX package's
utils/plotting.py): the inference cycle over the plot pairs, rescaled to
uint8, as the two panel families X_cycle = [X, G(X), F(G(X))] and
Y_cycle = [Y, F(Y), G(F(Y))]."""

from __future__ import annotations

import numpy as np
import torch


def to_uint8(x: np.ndarray) -> np.ndarray:
    """[-1, 1] float -> uint8."""
    return np.clip((np.asarray(x, np.float32) + 1.0) * 127.5, 0, 255).astype(np.uint8)


def plot_cycle(plot_pairs, cycle_fn, state, summary, epoch: int,
               services=None) -> None:
    """``cycle_fn``: (state, x, y) -> (fake_x, fake_y, cycle_x, cycle_y)
    (``train/steps.py`` ``make_cycle_step``); ``plot_pairs``: numpy
    (x, y) pairs at batch 1, moved to the state's device here. The
    forwards and the copies to the host run on the calling thread; with
    ``services`` (an ``EpochServices``) the panels' encoding and writing,
    which take only those host copies, run on its worker as the job
    ``plot_cycle:e<epoch>``."""
    device = next(state.g.parameters()).device
    x_rows, y_rows = [], []
    for x, y in plot_pairs:
        x_t, y_t = (torch.from_numpy(a).to(device) for a in (x, y))
        fake_x, fake_y, cycle_x, cycle_y = (
            t[0].cpu().numpy() for t in cycle_fn(state, x_t, y_t))
        x_rows.append(np.stack([to_uint8(x[0]), to_uint8(fake_y),
                                to_uint8(cycle_x)]))
        y_rows.append(np.stack([to_uint8(y[0]), to_uint8(fake_x),
                                to_uint8(cycle_y)]))
    x_cycle, y_cycle = np.stack(x_rows), np.stack(y_rows)

    def write() -> None:
        summary.image_cycle("X_cycle", x_cycle, step=epoch, training=False)
        summary.image_cycle("Y_cycle", y_cycle, step=epoch, training=False)

    if services is not None:
        services.submit(f"plot_cycle:e{epoch}", write)
    else:
        write()
