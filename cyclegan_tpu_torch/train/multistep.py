"""K train steps a dispatch (``TrainConfig.steps_per_dispatch``): the port's
counterpart of the JAX package's ``shard_multi_train_step``
(``parallel/dp.py``), which scans K steps in one jitted dispatch.

``make_multi_train_step(step, k)`` returns ``(state, xs, ys, ws) ->
(state, metrics)``: ``xs``, ``ys`` and ``ws`` carry a leading K axis, and
each metric comes back stacked [K], one row a step, in order. ``step`` is
the single-step path's own closure (``make_train_step``), so K steps a
dispatch make the same updates as K dispatches of one step.

On the card the K steps are one CUDA graph:
- the first call runs its K steps eagerly, one after another. It is the
  warm-up: the kernels' build, cuDNN's handles and workspaces, the launch
  plans, the kernels' per-stream scratch, the shared-memory attributes and
  Adam's state all come into being here, outside any capture;
- the second call copies its group into static input slots, captures K
  consecutive calls of ``step`` on them on a stream of its own (whose
  scratch it first adopts from the warm-up's stream,
  ``ops/cuda/norm_kernel.py`` ``adopt_scratch``), then replays the graph:
  capture runs nothing, so the replay makes that group's updates, and the
  update sequence is the eager one;
- every later call is one ``copy_`` of the group into the slots and one
  ``replay()``.
After each replay the graph's static [K, metrics] output is copied (one
small device copy), since the loop holds up to 32 steps' rows unfetched
and the next replay overwrites the output. The host-side ``state.step``,
which a replay does not run, advances by K after each replay.

Under ``ModelConfig.remat`` each residual block's forward is recomputed
inside the captured backward (``torch.utils.checkpoint`` without RNG
state, which a capture could not read), so its kernels' wrappers count
twice a step at the capture.

Capture runs in ``capture_error_mode="thread_local"``: the prefetch worker
(``data/prefetch.py``) goes on pinning and copying batches from its own
thread meanwhile, which the default "global" mode would refuse. A capture
that fails raises; nothing falls back to eager steps. The graph holds the
addresses of the weights and of Adam's moments and counts: each replay
first checks that none of them moved (an optimizer's ``load_state_dict``
replaces its tensors), and raises if one did.

The wrappers' ``LAUNCHES`` counters run in Python, so they advance when
the graph is captured and not when it is replayed. On the CPU the K steps
run one after another, for the tests.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from cyclegan_tpu_torch.ops.cuda.norm_kernel import adopt_scratch
from cyclegan_tpu_torch.train.state import CycleGANState


def _stacked(rows) -> Dict[str, torch.Tensor]:
    return {key: torch.stack([row[key].reshape(()) for row in rows])
            for key in rows[0]}


def _addresses(state: CycleGANState) -> tuple:
    """Where the weights and Adam's tensors live: what a graph captured."""
    out = []
    for net, opt in zip(state.networks, state.optimizers):
        for p in net.parameters():
            out.append(p.data_ptr())
            out.extend(t.data_ptr() for t in opt.state.get(p, {}).values()
                       if isinstance(t, torch.Tensor))
    return tuple(out)


class MultiTrainStep:
    """K calls of ``step`` a dispatch (module docstring)."""

    def __init__(self, step: Callable, k: int):
        if k < 1:
            raise ValueError(f"steps per dispatch must be >= 1, got {k}")
        self.step = step
        self.k = int(k)
        self.warm = False
        self.graph = None

    def __call__(self, state: CycleGANState, xs: torch.Tensor,
                 ys: torch.Tensor, ws: torch.Tensor
                 ) -> Tuple[CycleGANState, Dict[str, torch.Tensor]]:
        if not xs.shape[0] == ys.shape[0] == ws.shape[0] == self.k:
            raise ValueError(f"a dispatch of {self.k} steps got groups of "
                             f"{xs.shape[0]}, {ys.shape[0]}, {ws.shape[0]}")
        if xs.device.type != "cuda" or not self.warm:
            rows = []
            for i in range(self.k):
                state, metrics = self.step(state, xs[i], ys[i], ws[i])
                rows.append(metrics)
            self.warm = xs.device.type == "cuda"
            return state, _stacked(rows)
        if self.graph is None:
            self._capture(state, xs, ys, ws)
        return self._replay(state, xs, ys, ws)

    def _capture(self, state, xs, ys, ws) -> None:
        device = xs.device
        self.slots = tuple(torch.empty_like(t) for t in (xs, ys, ws))
        stream = torch.cuda.Stream(device)
        self.scratch = adopt_scratch(
            device, torch.cuda.current_stream(device), stream)
        graph = torch.cuda.CUDAGraph()
        step0 = state.step
        rows = []
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            for i in range(self.k):
                state, metrics = self.step(state, self.slots[0][i],
                                           self.slots[1][i], self.slots[2][i])
                rows.append(metrics)
            self.keys = tuple(rows[0])
            self.out = torch.stack([torch.stack(
                [row[key].reshape(()) for key in self.keys]) for row in rows])
        # Capture ran the step's Python, not its work: undo its count.
        state.step = step0
        self.stream, self.graph = stream, graph
        self.addresses = _addresses(state)

    def _replay(self, state, xs, ys, ws):
        if _addresses(state) != self.addresses:
            raise RuntimeError(
                "the state's weights or Adam tensors moved since the CUDA "
                "graph captured them (a load_state_dict after the capture?); "
                "make a new multi step")
        for slot, t in zip(self.slots, (xs, ys, ws)):
            slot.copy_(t)
        self.graph.replay()
        state.step += self.k
        values = self.out.clone()
        return state, {key: values[:, j] for j, key in enumerate(self.keys)}


def make_multi_train_step(step: Callable, k: int) -> MultiTrainStep:
    """``(state, xs, ys, ws) -> (state, metrics stacked [K])`` over K
    staged batches, by ``step``, the single-step path's closure."""
    return MultiTrainStep(step, k)
