"""Training state (the JAX package's train/state.py).

The JAX package keeps four parameter trees and four optax Adam states in
one immutable pytree; here the four networks are modules that own their
parameters, each with its own Adam (``CapturableAdam``), and a train step
updates them in place. Names follow the reference:

  g:  G, X -> Y generator        f:  F, Y -> X generator
  dx: D_X, judges domain X       dy: D_Y, judges domain Y

Under ``compute_dtype="bfloat16"`` the networks compute in bf16 over f32
parameters, so the gradients and the four Adams stay f32 (JAX
``train/state.py:68``).

Adam keeps its step count on the device, as optax keeps ``count``, so a
train step holds no value on the host and can be captured in a CUDA graph
(``train/multistep.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cyclegan_tpu_torch.config import Config
from cyclegan_tpu_torch.models import PatchGANDiscriminator, ResNetGenerator
from cyclegan_tpu_torch.models.modules import compute_dtype
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
    g_opt: torch.optim.Optimizer
    f_opt: torch.optim.Optimizer
    dx_opt: torch.optim.Optimizer
    dy_opt: torch.optim.Optimizer

    @property
    def networks(self) -> tuple:
        return (self.g, self.f, self.dx, self.dy)

    @property
    def optimizers(self) -> tuple:
        return (self.g_opt, self.f_opt, self.dx_opt, self.dy_opt)


class CapturableAdam(torch.optim.Adam):
    """``torch.optim.Adam`` with ``capturable=True``, whose step is optax's
    ``adam`` on the device: the count and both bias corrections are
    tensors beside the parameters, so a step reads nothing on the host and
    a CUDA graph can capture it.

    The state and its ``state_dict`` are torch Adam's (``step`` a float32
    0-d tensor a parameter, ``exp_avg``, ``exp_avg_sq``), so a checkpoint
    slot is the same whether its run stepped eagerly or in a graph. The
    arithmetic is optax's, on any device (torch's own capturable step
    refuses the CPU):

      mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2,   t += 1
      p -= lr (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    """

    def __init__(self, params, lr: float, betas: Tuple[float, float],
                 eps: float):
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         capturable=True)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("CapturableAdam takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32,
                                                device=p.device)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
            grads = [p.grad for p in params]
            steps = [self.state[p]["step"] for p in params]
            mus = [self.state[p]["exp_avg"] for p in params]
            nus = [self.state[p]["exp_avg_sq"] for p in params]
            b1, b2 = group["betas"]
            torch._foreach_add_(steps, 1.0)
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            # One count a network: its parameters step together.
            count = steps[0]
            mu_hat = torch._foreach_div(mus, 1 - torch.pow(b1, count))
            nu_hat = torch._foreach_div(nus, 1 - torch.pow(b2, count))
            torch._foreach_sqrt_(nu_hat)
            torch._foreach_add_(nu_hat, group["eps"])
            torch._foreach_div_(mu_hat, nu_hat)
            torch._foreach_add_(params, mu_hat, alpha=-group["lr"])
        return None


def make_optimizer(config: Config, params) -> CapturableAdam:
    """Adam(lr 2e-4, b1 0.5, b2 0.9, eps 1e-7) over ``params``: optax's
    ``adam`` with bias correction, eps outside the square root and
    eps_root 0, its count on the device (``CapturableAdam``)."""
    opt = config.optimizer
    return CapturableAdam(params, lr=opt.learning_rate,
                          betas=(opt.b1, opt.b2), eps=ADAM_EPS)


def build_models(config: Config, device="cuda",
                 generators: Optional[tuple] = None
                 ) -> Tuple[ResNetGenerator, ResNetGenerator,
                            PatchGANDiscriminator, PatchGANDiscriminator]:
    """G, F, D_X and D_Y on ``device``, computing in the config's compute
    dtype, in the config's layout (JAX ``train/state.py:50-100``: every
    layout field to the generators; the norm impl, and ``pad_impl`` where
    it is "epilogue", to the discriminators). ``generators`` are four ``torch.Generator``s on the CPU for
    their initial weights (the JAX package's init distribution); the
    weights are drawn on the CPU and then moved, so a seed gives the same
    weights on every device and in every compute dtype."""
    m = config.model
    generators = generators or (None,) * 4
    dtype = compute_dtype(m.compute_dtype)
    disc_pad_impl = m.pad_impl if m.pad_impl == "epilogue" else "pad"
    nets = tuple(
        ResNetGenerator(m.generator, m.channels, m.channels, device="cpu",
                        generator=gen, dtype=dtype, **m.layout)
        for gen in generators[:2]) + tuple(
        PatchGANDiscriminator(m.discriminator, m.channels, device="cpu",
                              generator=gen, dtype=dtype,
                              norm_impl=m.instance_norm_impl,
                              pad_impl=disc_pad_impl)
        for gen in generators[2:])
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
    (``config.train.seed`` when None) and four fresh Adams
    (``make_optimizer``)."""
    seed = config.train.seed if seed is None else seed
    g, f, dx, dy = build_models(config, device, seeded_generators(seed))
    opts = [make_optimizer(config, net.parameters())
            for net in (g, f, dx, dy)]
    return CycleGANState(step=0, g=g, f=f, dx=dx, dy=dy, g_opt=opts[0],
                         f_opt=opts[1], dx_opt=opts[2], dy_opt=opts[3])
