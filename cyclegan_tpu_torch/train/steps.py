"""Train, test and cycle steps with the reference's gradient semantics
(the JAX package's train/steps.py).

The reference takes four gradients from one tape: each network's own loss
with respect to its own weights, all from the pre-update weights, and
updates the four networks at once. Two engines give them
(``config.train.grad_impl``); their gradients agree to f32 rounding and
they return the same metric keys.

``"combined"``: as in the JAX package, one scalar

  combined = G_total + F_total + X_loss + Y_loss

has, with respect to each network's weights, exactly that network's
gradient, because:
  - the adversarial terms apply the discriminators with DETACHED weights
    (the gradient still flows through their activations into the fakes);
  - the cycle terms feed DETACHED fakes to the second generator;
  - the discriminator terms see DETACHED fakes.
So one backward over ``combined`` gives all four gradients, but each
discriminator runs twice on each fake.

``"fusedprop"`` (FusedProp, arXiv:2004.03335): each discriminator runs
once on each fake and once on each real image. The fake enters it as a
detached leaf that requires grad, and that one graph is pulled twice:
first, kept for the second pull, with the adversarial loss for the input
side alone (the generator's adversarial cotangent; autograd skips the
convolutions' weight gradients), then with the discriminator loss for
the weights, in one backward with the generators' (their adversarial
cotangent at the fake plus their cycle and identity terms).

``make_grad_fn`` wraps either engine in ``domains/transfer.apply_freeze``
on an encoder-freeze transfer run. With ``config.obs.health`` the grad fn
adds the discriminators' linear ``_health/`` moments, and the train steps
finalize them with the norm-based signals after the update
(``obs/health.py``). ``make_accum_train_step`` sums the gradients and the
linear metrics of A microbatches and updates once.

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
from cyclegan_tpu_torch.domains import transfer
from cyclegan_tpu_torch.models.generator import use_full_fp32
from cyclegan_tpu_torch.obs import health
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


def _health_moments(metrics: Metrics, outputs, w: torch.Tensor,
                    gbs: float) -> None:
    """Add the linear ``_health/`` moments of the discriminators' outputs
    ((side, real output, fake output) triples) to ``metrics``."""
    for side, d_real, d_fake in outputs:
        for which, d_out in (("real", d_real), ("fake", d_fake)):
            k1, k2 = health.moment_keys(side, which)
            metrics[k1], metrics[k2] = losses.disc_raw_moments(
                d_out.detach(), w, gbs)


def _by_network(state: CycleGANState, flat) -> Grads:
    """A flat sequence of gradients, in the order of the four networks'
    ``named_parameters``, as four name -> gradient dicts."""
    grads, i = [], 0
    for net in state.networks:
        names = [k for k, _ in net.named_parameters()]
        grads.append(dict(zip(names, flat[i:i + len(names)])))
        i += len(names)
    return tuple(grads)


def make_grad_fn(config: Config, global_batch_size: int) -> Callable:
    """(state, x, y, w) -> (grads, metrics): the four networks' gradients
    by ``config.train.grad_impl``, with the ten loss scalars under the JAX
    package's keys (and the ``_health/`` moments with
    ``config.obs.health``). On an encoder-freeze transfer run both
    generators' encoder gradients are zero tensors."""
    make = (_make_fusedprop_grad_fn if config.train.grad_impl == "fusedprop"
            else _make_combined_grad_fn)
    fn = make(config, global_batch_size)
    if not transfer.freeze_active(config):
        return fn

    def frozen_grad_fn(state, x, y, w):
        grads, metrics = fn(state, x, y, w)
        return transfer.apply_freeze(grads), metrics

    return frozen_grad_fn


def _make_combined_grad_fn(config: Config, global_batch_size: int
                           ) -> Callable:
    """One combined scalar, one backward (module docstring)."""
    lam_c = config.loss.lambda_cycle
    lam_i = config.loss.lambda_identity
    with_health = config.obs.health
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
        d_real_x, d_fake_x = dx(x), dx(fake_x.detach())
        d_real_y, d_fake_y = dy(y), dy(fake_y.detach())
        x_loss = losses.discriminator_loss(d_real_x, d_fake_x, w, gbs)
        y_loss = losses.discriminator_loss(d_real_y, d_fake_y, w, gbs)
        combined = g_total + f_total + x_loss + y_loss

        params = [p for net in state.networks for p in net.parameters()]
        grads = _by_network(state, torch.autograd.grad(combined, params))
        values = (g_adv, g_cycle, g_id, g_total, f_adv, f_cycle, f_id,
                  f_total, x_loss, y_loss)
        metrics = {k: v.detach() for k, v in zip(METRIC_KEYS, values)}
        if with_health:
            _health_moments(metrics, (("dX", d_real_x, d_fake_x),
                                      ("dY", d_real_y, d_fake_y)), w, gbs)
        return grads, metrics

    return grad_fn


def _make_fusedprop_grad_fn(config: Config, global_batch_size: int
                            ) -> Callable:
    """FusedProp: one discriminator forward per fake, pulled twice
    (module docstring). Same gradients as the combined engine to f32
    rounding, same metric keys."""
    lam_c = config.loss.lambda_cycle
    lam_i = config.loss.lambda_identity
    with_health = config.obs.health
    gbs = float(global_batch_size)

    def grad_fn(state: CycleGANState, x: torch.Tensor, y: torch.Tensor,
                w: torch.Tensor) -> Tuple[Grads, Metrics]:
        _full_precision_on_card(x)
        g, f, dx, dy = state.networks
        fake_y = g(x)
        fake_x = f(y)
        # The shared forwards: each fake enters its discriminator once, as
        # a leaf, so that one graph serves the input side and the weights.
        leaf_y = fake_y.detach().requires_grad_()
        leaf_x = fake_x.detach().requires_grad_()
        d_fake_y, d_fake_x = dy(leaf_y), dx(leaf_x)
        d_real_y, d_real_x = dy(y), dx(x)
        g_adv = losses.generator_loss(d_fake_y, w, gbs)
        f_adv = losses.generator_loss(d_fake_x, w, gbs)
        y_loss = losses.discriminator_loss(d_real_y, d_fake_y, w, gbs)
        x_loss = losses.discriminator_loss(d_real_x, d_fake_x, w, gbs)

        # Pull 1, input side: the adversarial cotangents at the fakes. The
        # LSGAN cotangents of the two losses differ (2(d - 1) against d),
        # so the graphs are kept for pull 2.
        ct_fake_y, ct_fake_x = torch.autograd.grad(
            g_adv + f_adv, (leaf_y, leaf_x), retain_graph=True)
        # Cycle and identity terms see detached fakes, as in combined.
        g_cycle = losses.cycle_loss(y, g(fake_x.detach()), w, gbs, lam_c)
        f_cycle = losses.cycle_loss(x, f(fake_y.detach()), w, gbs, lam_c)
        g_id = losses.identity_loss(y, g(y), w, gbs, lam_i)
        f_id = losses.identity_loss(x, f(x), w, gbs, lam_i)
        rest = g_cycle + g_id + f_cycle + f_id + x_loss + y_loss

        # Pull 2: the generators (their adversarial cotangent at the fake
        # plus their own cycle and identity terms) and the discriminators'
        # weights (their loss through the same graphs, now freed).
        params = [p for net in state.networks for p in net.parameters()]
        grads = _by_network(state, torch.autograd.grad(
            (fake_y, fake_x, rest), params,
            grad_outputs=(ct_fake_y, ct_fake_x, None)))
        values = (g_adv, g_cycle, g_id, g_adv + g_cycle + g_id,
                  f_adv, f_cycle, f_id, f_adv + f_cycle + f_id,
                  x_loss, y_loss)
        metrics = {k: v.detach() for k, v in zip(METRIC_KEYS, values)}
        if with_health:
            _health_moments(metrics, (("dX", d_real_x, d_fake_x),
                                      ("dY", d_real_y, d_fake_y)), w, gbs)
        return grads, metrics

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


def _with_health(config: Config, step: Callable) -> Callable:
    """``step``, (state, x, y, weights) -> (grads, metrics, state), as a
    train step (state, x, y, weights) -> (state, metrics); with
    ``config.obs.health`` the metrics are finalized after the update, from
    a copy of the weights taken before it (the update is in place)."""
    if not config.obs.health:
        def train_step(state, x, y, weights):
            _, metrics, state = step(state, x, y, weights)
            return state, metrics

        return train_step
    frozen_group = transfer.freeze_active(config)

    def health_step(state, x, y, weights):
        old = health.copy_params(state.networks)
        grads, metrics, state = step(state, x, y, weights)
        return state, health.finalize_health_metrics(
            metrics, grads, old, health.param_dicts(state.networks),
            frozen_group=frozen_group)

    return health_step


def make_train_step(config: Config, global_batch_size: int) -> Callable:
    """(state, x, y, weights) -> (state, metrics): gradients, then the four
    Adam updates."""
    grad_fn = make_grad_fn(config, global_batch_size)
    update = make_update_fn()

    def step(state: CycleGANState, x: torch.Tensor, y: torch.Tensor,
             weights: torch.Tensor):
        grads, metrics = grad_fn(state, x, y, weights)
        return grads, metrics, update(state, grads)

    return _with_health(config, step)


def make_accum_grad_fn(config: Config, global_batch_size: int,
                       accum_steps: int) -> Callable:
    """(state, x, y, w) -> (grads, metrics) over an effective batch of
    ``accum_steps`` microbatches: microbatch i is rows
    [i * micro, (i + 1) * micro), as the JAX package's
    ``reshape(accum, -1, ...)`` splits it. Their gradients and linear
    metrics are summed. With ``global_batch_size`` the effective batch,
    every loss already carries its share of it, so the sums are the big
    batch's."""
    grad_fn = make_grad_fn(config, global_batch_size)

    def accum_grad_fn(state: CycleGANState, x: torch.Tensor, y: torch.Tensor,
                      w: torch.Tensor) -> Tuple[Grads, Metrics]:
        micro = x.shape[0] // accum_steps
        if micro * accum_steps != x.shape[0]:
            raise ValueError(f"an accumulated batch of {x.shape[0]} does not "
                             f"split into {accum_steps} microbatches")
        grads, metrics = None, None
        for i in range(accum_steps):
            rows = slice(i * micro, (i + 1) * micro)
            g_i, m_i = grad_fn(state, x[rows], y[rows], w[rows])
            if grads is None:
                grads, metrics = g_i, dict(m_i)
                continue
            grads = tuple(
                dict(zip(acc, torch._foreach_add(list(acc.values()),
                                                 [new[k] for k in acc])))
                for acc, new in zip(grads, g_i))
            for k, v in m_i.items():
                metrics[k] = metrics[k] + v
        return grads, metrics

    return accum_grad_fn


def make_accum_train_step(config: Config, global_batch_size: int,
                          accum_steps: int) -> Callable:
    """(state, x, y, weights) -> (state, metrics): ``make_accum_grad_fn``'s
    summed gradients, then one update, equal to the single big-batch
    step."""
    grad_fn = make_accum_grad_fn(config, global_batch_size, accum_steps)
    update = make_update_fn()

    def step(state: CycleGANState, x: torch.Tensor, y: torch.Tensor,
             weights: torch.Tensor):
        grads, metrics = grad_fn(state, x, y, weights)
        return grads, metrics, update(state, grads)

    return _with_health(config, step)


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
