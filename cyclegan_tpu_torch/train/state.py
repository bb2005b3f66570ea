"""Training state (the JAX package's train/state.py).

The JAX package keeps four parameter trees and four optax Adam states in
one immutable pytree; here the four networks are modules that own their
parameters, each with its own ``torch.optim.Adam``, and a train step
updates them in place. Names follow the reference:

  g:  G, X -> Y generator        f:  F, Y -> X generator
  dx: D_X, judges domain X       dy: D_Y, judges domain Y
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cyclegan_tpu_torch.config import Config
from cyclegan_tpu_torch.models import PatchGANDiscriminator, ResNetGenerator
from cyclegan_tpu_torch.utils.device import resolve_device

# Adam's eps: the Keras default the reference trains with (optax's eps is
# added outside the square root, as torch's is).
ADAM_EPS = 1e-7


@dataclasses.dataclass
class CycleGANState:
    step: int
    g: ResNetGenerator
    f: ResNetGenerator
    dx: PatchGANDiscriminator
    dy: PatchGANDiscriminator
    g_opt: torch.optim.Adam
    f_opt: torch.optim.Adam
    dx_opt: torch.optim.Adam
    dy_opt: torch.optim.Adam

    @property
    def networks(self) -> tuple:
        return (self.g, self.f, self.dx, self.dy)

    @property
    def optimizers(self) -> tuple:
        return (self.g_opt, self.f_opt, self.dx_opt, self.dy_opt)


def make_optimizer(config: Config, params) -> torch.optim.Adam:
    """Adam(lr 2e-4, b1 0.5, b2 0.9, eps 1e-7) over ``params``: optax's
    ``adam`` with bias correction, eps outside the square root and
    eps_root 0."""
    opt = config.optimizer
    return torch.optim.Adam(params, lr=opt.learning_rate,
                            betas=(opt.b1, opt.b2), eps=ADAM_EPS)


def build_models(config: Config, device="cuda",
                 generators: Optional[tuple] = None
                 ) -> Tuple[ResNetGenerator, ResNetGenerator,
                            PatchGANDiscriminator, PatchGANDiscriminator]:
    """G, F, D_X and D_Y on ``device``. ``generators`` are four
    ``torch.Generator``s on the CPU for their initial weights (the JAX
    package's init distribution); the weights are drawn on the CPU and
    then moved, so a seed gives the same weights on every device."""
    m = config.model
    generators = generators or (None,) * 4
    nets = (
        ResNetGenerator(m.generator, m.channels, m.channels, device="cpu",
                        generator=generators[0]),
        ResNetGenerator(m.generator, m.channels, m.channels, device="cpu",
                        generator=generators[1]),
        PatchGANDiscriminator(m.discriminator, m.channels, device="cpu",
                              generator=generators[2]),
        PatchGANDiscriminator(m.discriminator, m.channels, device="cpu",
                              generator=generators[3]),
    )
    device = resolve_device(device)
    return tuple(net.to(device) for net in nets)


def seeded_generators(seed: int) -> tuple:
    """Four independent ``torch.Generator``s from one seed, one per network
    (as the JAX package splits one key four ways)."""
    return tuple(torch.Generator().manual_seed(int(s.generate_state(1)[0]))
                 for s in np.random.SeedSequence(seed).spawn(4))


def create_state(config: Config, seed: Optional[int] = None,
                 device="cuda") -> CycleGANState:
    """The four networks at their initial weights from ``seed``
    (``config.train.seed`` when None) and four fresh Adams."""
    seed = config.train.seed if seed is None else seed
    g, f, dx, dy = build_models(config, device, seeded_generators(seed))
    return CycleGANState(
        step=0, g=g, f=f, dx=dx, dy=dy,
        g_opt=make_optimizer(config, g.parameters()),
        f_opt=make_optimizer(config, f.parameters()),
        dx_opt=make_optimizer(config, dx.parameters()),
        dy_opt=make_optimizer(config, dy.parameters()))
