"""Which kernel each site of a layout launches, counted from the config.

The layout dispatch of ``models/modules.py`` and ``ops/norm.py`` decides,
per site, between a hand-written kernel and torch ops: a standalone norm
runs K1 (backward K2) under ``instance_norm_impl="pallas"`` only; an
epilogue site runs K3 (backward K4) under "pallas" and "auto" wherever
``epilogue_eligible`` takes its shape; an Upsample block is one K5 launch
under ``upsample_impl="zeroskip_fused"`` (backward K4 over its conv
output). This module counts those launches from the config and the
input's shape alone, with the same eligibility function and none of the
modules' code, so that a run's counts (``ops/cuda/LAUNCHES``) can be held
against them. The JAX default layout counts 0 everywhere.

Counts use the f32 kernels' names; a bf16 run makes the same launches
under the ``_bf16`` names.
"""

from __future__ import annotations

import collections

import torch

from cyclegan_tpu_torch.config import Config, ModelConfig
from cyclegan_tpu_torch.models.generator import TAIL_PAD
from cyclegan_tpu_torch.ops.cuda.epilogue_kernel import epilogue_eligible

# What each forward kernel's backward launches.
BACKWARD_OF = {"instance_norm": "instance_norm_backward",
               "epilogue": "epilogue_backward",
               "upsample": "epilogue_backward"}


def _dtype(model: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if model.compute_dtype == "bfloat16" \
        else torch.float32


def _norm(model: ModelConfig, out: collections.Counter, shape, pad: int,
          epilogue_site: bool) -> None:
    """One norm site of [N, H, W, C] ``shape``: an epilogue site (with a
    reflect ``pad``) or a standalone norm."""
    impl = model.instance_norm_impl
    if epilogue_site:
        if impl != "xla" and epilogue_eligible(shape, _dtype(model), pad):
            out["epilogue"] += 1
    elif impl == "pallas":
        out["instance_norm"] += 1


def _same(size: int, stride: int) -> int:
    return -(-size // stride)


def generator_forward(model: ModelConfig, batch: int, size: int) -> dict:
    """Launches of each forward kernel in one generator forward of a
    [batch, size, size, channels] input, and of the trunk alone:
    (forward, trunk)."""
    gen = model.generator
    out = collections.Counter()
    f, s = gen.filters, size
    _norm(model, out, (batch, s, s, f), 0, False)
    for _ in range(gen.num_downsampling_blocks):
        f, s = 2 * f, _same(s, 2)
        _norm(model, out, (batch, s, s, f), 0, False)
    trunk = collections.Counter()
    epilogue = model.pad_mode == "reflect" and model.pad_impl == "epilogue"
    for _ in range(gen.num_residual_blocks):
        site = (batch, s, s, f)
        _norm(model, trunk, site, 1,
              epilogue and model.trunk_impl == "resnet")
        _norm(model, trunk, site, 0, False)
    out.update(trunk)
    scale = 2 ** gen.num_upsample_blocks
    tail = (TAIL_PAD if epilogue and epilogue_eligible(
        (batch, s * scale, s * scale, gen.filters), _dtype(model), TAIL_PAD)
        else 0)
    for i in range(gen.num_upsample_blocks):
        f, s = f // 2, 2 * s
        pad = tail if i == gen.num_upsample_blocks - 1 else 0
        if model.upsample_impl == "zeroskip_fused":
            out["upsample"] += 1
        else:
            _norm(model, out, (batch, s, s, f), pad, pad > 0)
    return dict(out), dict(trunk)


def discriminator_forward(model: ModelConfig, batch: int, size: int) -> dict:
    """Launches of each forward kernel in one discriminator forward: each
    downsampling block's tail is an epilogue site under
    ``pad_impl="epilogue"`` (JAX ``train/state.py:95``), else a standalone
    norm."""
    disc = model.discriminator
    out = collections.Counter()
    f, s = disc.filters, _same(size, 2)
    for i in range(disc.num_downsampling):
        f, s = 2 * f, _same(s, 2 if i < 2 else 1)
        _norm(model, out, (batch, s, s, f), 0, model.pad_impl == "epilogue")
    return dict(out)


def backward(forward: dict) -> dict:
    """The backward kernels' launches of one backward through a forward
    that made ``forward``'s."""
    out = collections.Counter()
    for name, n in forward.items():
        out[BACKWARD_OF[name]] += n
    return dict(out)


def _add(total: collections.Counter, counts: dict, times: int) -> None:
    for name, n in counts.items():
        total[name] += times * n


def generator_launches(model: ModelConfig, batch: int, size: int) -> dict:
    """One generator forward without gradients."""
    return generator_forward(model, batch, size)[0]


def train_step_launches(config: Config, batch: int = None) -> dict:
    """Launches of each kernel in one train step of the grad fn
    (``train/steps.py``): each generator runs 3 times (the fake, the
    cycle, the identity), every run backpropagated once; under "combined"
    each discriminator runs 3 times (the adversarial site, the real image,
    the detached fake), each backpropagated once; under "fusedprop" twice,
    the fake's graph backpropagated twice. Under ``remat`` each
    generator backward runs its trunk's forward kernels again."""
    model = config.model
    batch = config.train.batch_size if batch is None else batch
    size = model.image_size
    g_fwd, g_trunk = generator_forward(model, batch, size)
    d_fwd = discriminator_forward(model, batch, size)
    total = collections.Counter()
    _add(total, g_fwd, 6)
    _add(total, backward(g_fwd), 6)
    if model.remat:
        _add(total, g_trunk, 6)
    d_forwards = 4 if config.train.grad_impl == "fusedprop" else 6
    _add(total, d_fwd, d_forwards)
    _add(total, backward(d_fwd), 6)
    return dict(total)
