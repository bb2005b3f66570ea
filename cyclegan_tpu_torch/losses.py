"""CycleGAN losses as per-sample-weighted PyTorch functions (the JAX
package's ``losses.py``).

Every scalar is ``sum(weights * per_sample) / global_batch_size``. The
divisor is the global batch size, not ``sum(weights)``: a ragged final
batch is padded with samples of weight 0, and dividing by the true
global batch size gives the reference's remainder semantics. The GAN
objective is LSGAN (least squares); lambda_cycle 10, lambda_identity 5.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _per_sample_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes -> [N]."""
    return x.float().mean(dim=tuple(range(1, x.dim())))


def mae(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-sample mean absolute error -> [N]."""
    return _per_sample_mean((y_true - y_pred).abs())


def mse(y_true: torch.Tensor, y_pred: torch.Tensor) -> torch.Tensor:
    """Per-sample mean squared error -> [N]."""
    return _per_sample_mean((y_true - y_pred).square())


def bce(y_true: torch.Tensor, y_pred: torch.Tensor,
        from_logits: bool = False) -> torch.Tensor:
    """Per-sample binary cross entropy -> [N] (not used by training; part
    of the reference's API)."""
    if from_logits:
        log_p = -torch.logaddexp(torch.zeros_like(y_pred), -y_pred)
        log_not_p = -torch.logaddexp(torch.zeros_like(y_pred), y_pred)
    else:
        eps = 1e-7
        p = y_pred.clamp(eps, 1.0 - eps)
        log_p = torch.log(p)
        log_not_p = torch.log1p(-p)
    return _per_sample_mean(-(y_true * log_p + (1.0 - y_true) * log_not_p))


def scaled_mean(per_sample: torch.Tensor, weights: torch.Tensor,
                global_batch_size: float) -> torch.Tensor:
    """sum(weights * per_sample) / global_batch_size."""
    return (weights * per_sample).sum() / global_batch_size


def disc_raw_moments(disc_out: torch.Tensor, weights: torch.Tensor,
                     global_batch_size: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted first and second moments of raw PatchGAN outputs, in the
    same linear form as the losses."""
    m1 = scaled_mean(_per_sample_mean(disc_out), weights, global_batch_size)
    m2 = scaled_mean(_per_sample_mean(disc_out.float().square()), weights,
                     global_batch_size)
    return m1, m2


def generator_loss(discriminate_fake: torch.Tensor, weights: torch.Tensor,
                   global_batch_size: float) -> torch.Tensor:
    """LSGAN generator loss: MSE(1, D(fake))."""
    per_sample = mse(torch.ones_like(discriminate_fake), discriminate_fake)
    return scaled_mean(per_sample, weights, global_batch_size)


def cycle_loss(real: torch.Tensor, cycled: torch.Tensor, weights: torch.Tensor,
               global_batch_size: float,
               lambda_cycle: float = 10.0) -> torch.Tensor:
    """lambda_cycle * MAE(real, cycled)."""
    return lambda_cycle * scaled_mean(mae(real, cycled), weights,
                                      global_batch_size)


def identity_loss(real: torch.Tensor, same: torch.Tensor,
                  weights: torch.Tensor, global_batch_size: float,
                  lambda_identity: float = 5.0) -> torch.Tensor:
    """lambda_identity * MAE(real, same)."""
    return lambda_identity * scaled_mean(mae(real, same), weights,
                                         global_batch_size)


def discriminator_loss(discriminate_real: torch.Tensor,
                       discriminate_fake: torch.Tensor,
                       weights: torch.Tensor,
                       global_batch_size: float) -> torch.Tensor:
    """0.5 * (MSE(1, D(real)) + MSE(0, D(fake)))."""
    real_loss = mse(torch.ones_like(discriminate_real), discriminate_real)
    fake_loss = mse(torch.zeros_like(discriminate_fake), discriminate_fake)
    return scaled_mean(0.5 * (real_loss + fake_loss), weights,
                       global_batch_size)
