"""Several train steps a dispatch (``--steps_per_dispatch K``) on the CPU.

The port's ``make_multi_train_step`` (one CUDA graph of K steps on the
card, the K steps one after another here) against the JAX package's
``shard_multi_train_step`` (a ``lax.scan`` of K steps in one dispatch) on
a one-device CPU mesh, in ``tests/test_torch_port_train.py``'s small
CycleGAN from its signal weights: K = 3 steps' stacked metrics and the
state after them. The first step's losses come from the same weights and
are held to that file's ``SCALAR_TOL``; the later ones and the weights and
Adam moments after three updates to its ``GRAD_TOL``, as its three-step
test holds the losses (f32 sums in another order move each update's
inputs).

On the port alone: an epoch of 5 batches at K = 2 (two dispatches of two
and a remainder of one through the single step) equals the K = 1 epoch
bitwise, state and per-step metrics, as ``tests/test_multistep.py`` holds
the JAX package's; and a checkpoint ring written by a K = 2 run restores
into a K = 1 run with the state bitwise equal.

Last, the capture-safety guard: a CUDA graph captures no host sync, so
the code that runs inside the train step (``train/steps.py``,
``obs/health.py``'s device half, ``losses.py``, ``models/``, ``ops/``)
must hold none. Read with ``ast``, as ``tests/test_torch_port_ops.py``
reads the port's imports, it may not call ``.item()``, ``.cpu()``,
``.numpy()``, ``.tolist()`` or a ``synchronize``, nor branch in Python
(``if``, ``while``, ``assert``, a conditional expression) on a
reduction of a tensor (``.any()``, ``.all()``, ``torch.equal``,
``torch.isfinite``...). Such a sync would break capture only on the card.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyclegan_tpu.parallel import (
    make_mesh_plan,
    shard_multi_train_step,
    shard_stacked_batch,
)
from cyclegan_tpu.parallel.mesh import replicated
from cyclegan_tpu.train.steps import make_train_step as jax_train_step
from cyclegan_tpu_torch.convert import NETWORKS, state_from_flax, state_to_flax
from cyclegan_tpu_torch.train import loop
from cyclegan_tpu_torch.train.multistep import make_multi_train_step
from cyclegan_tpu_torch.train.state import create_state
from cyclegan_tpu_torch.train.steps import METRIC_KEYS, make_train_step
from cyclegan_tpu_torch.utils.checkpoint import Checkpointer, state_digest
from tests.test_torch_port_train import (
    BATCH,
    CONFIG,
    GRAD_TOL,
    JAX_CONFIG,
    SCALAR_TOL,
    _jax,
    _numpy_state,
)

K = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _groups(k, seed=11):
    rng = np.random.default_rng(seed)
    xs, ys = (rng.uniform(-1, 1, (k, BATCH, 32, 32, 3)).astype(np.float32)
              for _ in range(2))
    ws = np.ones((k, BATCH), np.float32)
    ws[-1, -1] = 0.0  # a padded sample in the last step
    return xs, ys, ws


def test_multi_step_matches_jax_shard_multi_train_step():
    xs, ys, ws = _groups(K)
    plan = make_mesh_plan(devices=jax.devices()[:1])
    # A copy: the multi step donates its state.
    jax_state = jax.device_put(jax.tree.map(jnp.copy, _jax()["signal"]),
                               replicated(plan))
    multi = shard_multi_train_step(
        plan, jax_train_step(JAX_CONFIG, BATCH, plan), K)
    jax_state, jax_metrics = multi(jax_state,
                                   *shard_stacked_batch(plan, xs, ys, ws))
    want = _numpy_state(jax.device_get(jax_state))

    state = state_from_flax(_numpy_state(_jax()["signal"]), CONFIG,
                            device="cpu")
    state, metrics = make_multi_train_step(make_train_step(CONFIG, BATCH), K)(
        state, *(torch.from_numpy(a) for a in (xs, ys, ws)))
    got = state_to_flax(state)

    assert set(metrics) == set(METRIC_KEYS) == set(jax_metrics)
    for key in METRIC_KEYS:
        ours, theirs = metrics[key].numpy(), np.asarray(jax_metrics[key])
        assert ours.shape == theirs.shape == (K,)
        np.testing.assert_allclose(ours[0], theirs[0], err_msg=key,
                                   **SCALAR_TOL)
        np.testing.assert_allclose(ours, theirs, err_msg=key, **GRAD_TOL)
    assert got["step"] == want["step"] == K
    for name in NETWORKS:
        assert got[f"{name}_opt"]["count"] == want[f"{name}_opt"]["count"] == K
        for part, ours, theirs in (
                ("params", got[f"{name}_params"], want[f"{name}_params"]),
                ("mu", got[f"{name}_opt"]["mu"], want[f"{name}_opt"]["mu"]),
                ("nu", got[f"{name}_opt"]["nu"], want[f"{name}_opt"]["nu"])):
            for key in theirs:
                np.testing.assert_allclose(ours[key], theirs[key],
                                           err_msg=f"{name} {part} {key}",
                                           **GRAD_TOL)


class _FiveBatches:
    """The data of an epoch of 5 batches, as ``train_epoch`` reads it."""

    train_steps = 5

    def __init__(self):
        xs, ys, ws = _groups(5, seed=12)
        self.batches = list(zip(xs, ys, ws))

    def train_epoch(self, epoch, prefetch=True, start_step=0):
        return iter(self.batches[start_step:])


class _Rows:
    """A summary that keeps nothing; the rows come from ``health``."""

    def scalar(self, *args, **kwargs):
        pass


class _Recorder:
    """A stand-in HealthMonitor that records each fetched row in order."""

    def __init__(self):
        self.rows = []

    def begin_epoch(self, epoch):
        pass

    def observe(self, row):
        self.rows.append(row)


# The step's options that --steps_per_dispatch composes with: FusedProp,
# the health metrics, encoder-freeze transfer and bf16 compute.
OPTIONS = dict(
    fusedprop_health_freeze_bf16=dict(
        train=dict(grad_impl="fusedprop", init_from="parent",
                   transfer_mode="encoder_freeze"),
        obs=dict(health=True), model=dict(compute_dtype="bfloat16")))


def _epoch(k, prefetch=0, options=None):
    options = options or {}
    config = CONFIG.replace(
        train=dataclasses.replace(CONFIG.train, steps_per_dispatch=k,
                                  prefetch_batches=prefetch,
                                  **options.get("train", {})),
        obs=dataclasses.replace(CONFIG.obs, **options.get("obs", {})),
        model=dataclasses.replace(CONFIG.model, **options.get("model", {})))
    step = make_train_step(config, BATCH)
    state = create_state(config, 3, device="cpu")
    rows = _Recorder()
    state = loop.train_epoch(
        config, _FiveBatches(), step, state, _Rows(), 0, health=rows,
        multi_step_fn=make_multi_train_step(step, k) if k > 1 else None)
    return state, rows.rows


@pytest.mark.parametrize("prefetch,options", [
    (0, None), (2, None), (2, "fusedprop_health_freeze_bf16")])
def test_an_epoch_at_k2_equals_k1_bitwise(prefetch, options):
    one, rows_one = _epoch(1, prefetch, OPTIONS.get(options))
    two, rows_two = _epoch(2, prefetch, OPTIONS.get(options))
    assert one.step == two.step == 5
    assert state_digest(one) == state_digest(two)
    assert len(rows_one) == len(rows_two) == 5
    for a, b in zip(rows_one, rows_two):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key] == b[key], key


def test_a_ring_written_at_k2_restores_at_k1(tmp_path):
    state, _ = _epoch(2)
    Checkpointer(str(tmp_path), keep=2).save(state, 0)
    fresh = create_state(CONFIG, 9, device="cpu")
    restored, next_epoch = Checkpointer(str(tmp_path), keep=2).restore(fresh)
    assert next_epoch == 1 and restored.step == 5
    assert state_digest(restored) == state_digest(state)
    # Both go on alike through the single step.
    x, y, w = (torch.from_numpy(a[0]) for a in _groups(1, seed=13))
    step = make_train_step(CONFIG, BATCH)
    a, _ = step(state, x, y, w)
    b, _ = step(restored, x, y, w)
    assert state_digest(a) == state_digest(b)


# -- capture-safety guard ----------------------------------------------------

STEP_SOURCES = ("train/steps.py", "obs/health.py", "losses.py", "models",
                "ops")
# Definitions that never run inside the step: the health monitor's host
# half, which reads rows the loop already fetched, and the kernels' build.
HOST_SIDE = {"obs/health.py": {"HealthFault", "HealthMonitor",
                               "make_health_monitor"},
             "ops/cuda/build.py": None}
SYNC_METHODS = {"item", "cpu", "numpy", "tolist", "synchronize"}
TENSOR_TESTS = {"any", "all", "equal", "allclose", "isfinite", "isnan",
                "isinf", "is_nonzero", "nonzero"}
HOST_MODULES = {"math", "np", "numpy", "os", "re"}


def _step_files():
    root = os.path.join(REPO, "cyclegan_tpu_torch")
    for entry in STEP_SOURCES:
        path = os.path.join(root, entry)
        paths = [path] if path.endswith(".py") else sorted(
            os.path.join(d, f) for d, _, fs in os.walk(path) for f in fs
            if f.endswith(".py"))
        for p in paths:
            rel = os.path.relpath(p, root).replace(os.sep, "/")
            if HOST_SIDE.get(rel, ()) is not None:
                yield rel, p


def _syncs(tree, skip):
    """(line, what) of each host sync in ``tree`` outside ``skip``'s
    top-level definitions."""
    nodes = [n for n in tree.body
             if getattr(n, "name", None) not in skip]
    found = []
    for node in (sub for top in nodes for sub in ast.walk(top)):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            base = node.func.value
            if (node.func.attr in SYNC_METHODS and not (
                    isinstance(base, ast.Name) and base.id in HOST_MODULES)):
                found.append((node.lineno, f".{node.func.attr}()"))
        tests = []
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            tests.append(node.test)
        elif isinstance(node, ast.Assert):
            tests.append(node.test)
        for test in tests:
            for sub in ast.walk(test):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in TENSOR_TESTS
                        and not (isinstance(sub.func.value, ast.Name)
                                 and sub.func.value.id in HOST_MODULES)):
                    found.append((sub.lineno,
                                  f"a branch on .{sub.func.attr}()"))
    return found


def test_the_train_step_holds_no_host_sync():
    files = list(_step_files())
    assert len(files) > 10  # the guard reads what it should
    bad = []
    for rel, path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        bad += [f"{rel}:{line} {what}"
                for line, what in _syncs(tree, HOST_SIDE.get(rel) or ())]
    assert not bad, "host syncs inside the train step:\n" + "\n".join(bad)


@pytest.mark.parametrize("snippet", [
    "def f(x):\n    return x.sum().item()\n",
    "def f(x):\n    if torch.isfinite(x).all():\n        return x\n",
    "def f(x):\n    torch.cuda.synchronize()\n",
    "def f(x):\n    return x.tolist()\n",
])
def test_the_guard_sees_a_sync(snippet):
    assert _syncs(ast.parse(snippet), ())
