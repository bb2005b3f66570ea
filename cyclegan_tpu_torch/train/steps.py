"""Train, test and cycle steps with the reference's gradient semantics
(the JAX package's train/steps.py, ``grad_impl="combined"``).

The reference takes four gradients from one tape: each network's own loss
with respect to its own weights, all from the pre-update weights, and
updates the four networks at once. As in the JAX package, one scalar

  combined = G_total + F_total + X_loss + Y_loss

has, with respect to each network's weights, exactly that network's
gradient, because:
  - the adversarial terms apply the discriminators with DETACHED weights
    (the gradient still flows through their activations into the fakes);
  - the cycle terms feed DETACHED fakes to the second generator;
  - the discriminator terms see DETACHED fakes.
So one backward over ``combined`` gives all four gradients.

Every step takes a per-sample {0, 1} ``weights`` mask and scales each loss
as sum(w * per_sample) / global_batch_size (losses.py). Tensors are NHWC
on the state's device; on the card every step runs with TF32 off.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.func import functional_call

from cyclegan_tpu_torch import losses
from cyclegan_tpu_torch.config import Config
from cyclegan_tpu_torch.models.generator import use_full_fp32
from cyclegan_tpu_torch.train.state import CycleGANState

Metrics = Dict[str, torch.Tensor]
# Per network (G, F, D_X, D_Y): parameter name -> gradient.
Grads = Tuple[Dict[str, torch.Tensor], ...]

METRIC_KEYS = (
    "loss_G/loss", "loss_G/cycle", "loss_G/identity", "loss_G/total",
    "loss_F/loss", "loss_F/cycle", "loss_F/identity", "loss_F/total",
    "loss_X/loss", "loss_Y/loss",
)
TEST_ERROR_KEYS = (
    "error/MAE(X, F(G(X)))", "error/MAE(Y, G(F(Y)))",
    "error/MAE(X, F(X))", "error/MAE(Y, G(Y))",
)


def _frozen(net: torch.nn.Module) -> Callable:
    """``net`` applied with its weights detached: the gradient reaches its
    input, never its weights (the JAX package's ``stop(params)``)."""
    params = {k: p.detach() for k, p in net.named_parameters()}
    return lambda x: functional_call(net, params, (x,))


def _full_precision_on_card(x: torch.Tensor) -> None:
    if x.is_cuda:
        use_full_fp32()


def make_grad_fn(config: Config, global_batch_size: int) -> Callable:
    """(state, x, y, w) -> (grads, metrics): the four networks' gradients
    from one backward, with the ten loss scalars under the JAX package's
    keys."""
    lam_c = config.loss.lambda_cycle
    lam_i = config.loss.lambda_identity
    gbs = float(global_batch_size)

    def grad_fn(state: CycleGANState, x: torch.Tensor, y: torch.Tensor,
                w: torch.Tensor) -> Tuple[Grads, Metrics]:
        _full_precision_on_card(x)
        g, f, dx, dy = state.networks
        fake_y = g(x)
        fake_x = f(y)
        # Adversarial terms: detached discriminator weights.
        g_adv = losses.generator_loss(_frozen(dy)(fake_y), w, gbs)
        f_adv = losses.generator_loss(_frozen(dx)(fake_x), w, gbs)
        # Cycle terms: detached fakes, so each generator sees only its own
        # cycle gradient.
        g_cycle = losses.cycle_loss(y, g(fake_x.detach()), w, gbs, lam_c)
        f_cycle = losses.cycle_loss(x, f(fake_y.detach()), w, gbs, lam_c)
        g_id = losses.identity_loss(y, g(y), w, gbs, lam_i)
        f_id = losses.identity_loss(x, f(x), w, gbs, lam_i)
        g_total = g_adv + g_cycle + g_id
        f_total = f_adv + f_cycle + f_id
        # Discriminator terms: detached fakes.
        x_loss = losses.discriminator_loss(dx(x), dx(fake_x.detach()), w, gbs)
        y_loss = losses.discriminator_loss(dy(y), dy(fake_y.detach()), w, gbs)
        combined = g_total + f_total + x_loss + y_loss

        named = [list(net.named_parameters()) for net in state.networks]
        flat = torch.autograd.grad(combined, [p for ps in named for _, p in ps])
        grads, i = [], 0
        for ps in named:
            grads.append({k: flat[i + j] for j, (k, _) in enumerate(ps)})
            i += len(ps)
        values = (g_adv, g_cycle, g_id, g_total, f_adv, f_cycle, f_id,
                  f_total, x_loss, y_loss)
        metrics = {k: v.detach() for k, v in zip(METRIC_KEYS, values)}
        return tuple(grads), metrics

    return grad_fn


def make_update_fn() -> Callable:
    """(state, grads) -> state: each network's Adam (made from the config
    by ``create_state``) steps with its own gradient; all four gradients
    come from the pre-update weights, so the updates are simultaneous, not
    alternating. Updates in place and returns the same state with its step
    advanced."""

    def update(state: CycleGANState, grads: Grads) -> CycleGANState:
        for net, opt, grad in zip(state.networks, state.optimizers, grads):
            for name, p in net.named_parameters():
                p.grad = grad[name]
            opt.step()
            opt.zero_grad(set_to_none=True)
        state.step += 1
        return state

    return update


def make_train_step(config: Config, global_batch_size: int) -> Callable:
    """(state, x, y, weights) -> (state, metrics): gradients, then the four
    Adam updates."""
    grad_fn = make_grad_fn(config, global_batch_size)
    update = make_update_fn()

    def train_step(state: CycleGANState, x: torch.Tensor, y: torch.Tensor,
                   weights: torch.Tensor) -> Tuple[CycleGANState, Metrics]:
        grads, metrics = grad_fn(state, x, y, weights)
        return update(state, grads), metrics

    return train_step


def make_cycle_step() -> Callable:
    """(state, x, y) -> (fake_x, fake_y, cycle_x, cycle_y): x -> G -> F and
    y -> F -> G, without gradients."""

    @torch.no_grad()
    def cycle_step(state: CycleGANState, x: torch.Tensor, y: torch.Tensor):
        _full_precision_on_card(x)
        fake_y = state.g(x)
        cycle_x = state.f(fake_y)
        fake_x = state.f(y)
        cycle_y = state.g(fake_x)
        return fake_x, fake_y, cycle_x, cycle_y

    return cycle_step


def make_test_step(config: Config, global_batch_size: int) -> Callable:
    """(state, x, y, weights) -> metrics: the ten training losses without
    gradients, and the four cycle and identity MAE errors."""
    cycle_step = make_cycle_step()
    lam_c = config.loss.lambda_cycle
    lam_i = config.loss.lambda_identity
    gbs = float(global_batch_size)

    @torch.no_grad()
    def test_step(state: CycleGANState, x: torch.Tensor, y: torch.Tensor,
                  w: torch.Tensor) -> Metrics:
        fake_x, fake_y, cycle_x, cycle_y = cycle_step(state, x, y)
        disc_fake_x = state.dx(fake_x)
        disc_fake_y = state.dy(fake_y)
        g_adv = losses.generator_loss(disc_fake_y, w, gbs)
        f_adv = losses.generator_loss(disc_fake_x, w, gbs)
        # The reference's pairing: F's cycle term is on X, G's on Y.
        f_cycle = losses.cycle_loss(x, cycle_x, w, gbs, lam_c)
        g_cycle = losses.cycle_loss(y, cycle_y, w, gbs, lam_c)
        same_x = state.f(x)
        same_y = state.g(y)
        g_id = losses.identity_loss(y, same_y, w, gbs, lam_i)
        f_id = losses.identity_loss(x, same_x, w, gbs, lam_i)
        x_loss = losses.discriminator_loss(state.dx(x), disc_fake_x, w, gbs)
        y_loss = losses.discriminator_loss(state.dy(y), disc_fake_y, w, gbs)
        values = (g_adv, g_cycle, g_id, g_adv + g_cycle + g_id,
                  f_adv, f_cycle, f_id, f_adv + f_cycle + f_id,
                  x_loss, y_loss,
                  losses.scaled_mean(losses.mae(x, cycle_x), w, gbs),
                  losses.scaled_mean(losses.mae(y, cycle_y), w, gbs),
                  losses.scaled_mean(losses.mae(x, same_x), w, gbs),
                  losses.scaled_mean(losses.mae(y, same_y), w, gbs))
        return dict(zip(METRIC_KEYS + TEST_ERROR_KEYS, values))

    return test_step
