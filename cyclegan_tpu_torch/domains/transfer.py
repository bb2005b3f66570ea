"""Transfer onboarding: fine-tune a new domain pair from a trained parent
run (Mind2Mind, arXiv:1906.11613). The port's form of the JAX package's
``domains/transfer.py``.

``--init_from <parent_run>`` seeds the four networks' weights from the
newest verified slot of the parent's checkpoint ring; the step and the
four Adams start fresh. ``--transfer encoder_freeze`` also pins both
generators' encoder by giving its parameters zero gradients in the step
(``apply_freeze``, wrapped around the grad fn by ``train/steps.py``), so
that every step variant (combined, fusedprop, accumulated) inherits the
mask. The zeros reach Adam: every parameter keeps its Adam state, a
checkpoint of a frozen run interchanges with an unfrozen one, and from a
fresh Adam state a zero gradient leaves the weight bitwise unchanged.

The frozen set is the JAX package's: a parameter is frozen when any
module on its path is named ``Conv_0``, ``Downsample_0`` or
``Downsample_1``. On the generator that is the stem's conv, both
downsampling blocks, and also each residual block's first conv
(``ResidualBlock_k/Conv_0``), since the match is at any depth; the
stem's ``InstanceNorm_0`` trains. The port copies this on purpose.

Every save of a transfer run records its provenance in ``meta.json``
(``parent_ckpt``, ``parent_epoch``, ``parent_domain``, ``transfer_mode``,
``domain``).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import torch

from cyclegan_tpu_torch.domains.registry import DEFAULT_DOMAIN, DomainError

TRANSFER_MODES = ("full_finetune", "encoder_freeze")

# Generator modules of the encoder: the c7s1 stem and the downsampling
# blocks, matched at any depth of a parameter's path.
ENCODER_MODULES = ("Conv_0", "Downsample_0", "Downsample_1")

_PATH_SEP = re.compile(r"[./]")


class TransferError(ValueError):
    """A transfer request that cannot be satisfied (a bad mode, a parent
    without a slot, another architecture), raised before training."""


def validate_mode(mode: str) -> str:
    if mode not in TRANSFER_MODES:
        raise TransferError(
            f"transfer mode must be one of {TRANSFER_MODES}, "
            f"got {mode!r}")
    return mode


# --------------------------------------------------------- freeze mask


def is_frozen(name: str) -> bool:
    """Whether a parameter (a ``state_dict`` key, ``ResidualBlock_0.Conv_0.
    weight``, or its flax path, ``ResidualBlock_0/Conv_0/kernel``) lies in
    the encoder."""
    return any(part in ENCODER_MODULES for part in _PATH_SEP.split(name))


def mask_encoder_grads(grads: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """One generator's gradients with every encoder entry a zero tensor."""
    return {k: torch.zeros_like(g) if is_frozen(k) else g
            for k, g in grads.items()}


def apply_freeze(grads: Tuple) -> Tuple:
    """Mask the two generators' gradients of the (G, F, D_X, D_Y) tuple;
    the discriminators always train."""
    g_g, g_f, g_dx, g_dy = grads
    return (mask_encoder_grads(g_g), mask_encoder_grads(g_f), g_dx, g_dy)


def frozen_leaves(tree: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """The encoder entries of one generator's dict (parameters or
    gradients), in its order."""
    return [v for k, v in tree.items() if is_frozen(k)]


# ------------------------------------------------- domain compatibility


def sidecar_domain(meta: Optional[dict]) -> str:
    """The domain a checkpoint's ``meta.json`` records; one that records
    none reads as the default."""
    if not isinstance(meta, dict):
        return DEFAULT_DOMAIN
    domain = meta.get("domain")
    return str(domain) if domain else DEFAULT_DOMAIN


def check_domain_compat(meta: Optional[dict], domain: str, strict: bool,
                        context: str = "restore", telemetry=None,
                        echo=None) -> bool:
    """A checkpoint's domain against the run's. Match: True. Mismatch: a
    ``domain_mismatch`` event to ``telemetry`` where given; then with
    ``strict`` (``--strict_domain``) refuse with ``DomainError``, else
    warn through ``echo`` and return False."""
    saved = sidecar_domain(meta)
    if saved == domain:
        return True
    msg = (f"{context}: checkpoint domain {saved!r} does not match this "
           f"run's domain {domain!r}")
    if telemetry is not None:
        telemetry.event("domain_mismatch", context=context,
                        checkpoint_domain=saved, run_domain=domain,
                        strict=bool(strict))
    if strict:
        raise DomainError(
            msg + " — refused under --strict_domain (drop the flag to "
                  "proceed, e.g. for deliberate cross-domain transfer)")
    if echo is not None:
        echo(f"WARNING: {msg} (continuing; --strict_domain refuses)")
    return False


# ------------------------------------------------------ parent restore


def restore_parent(config, template_state, telemetry=None, echo=None):
    """Load the parent run's weights into ``template_state``, the child's
    fresh state, whose architecture they must match. The step and the
    Adam states stay fresh. Returns (state, provenance), which also goes
    to ``telemetry`` as a ``transfer_init`` event where given."""
    from cyclegan_tpu_torch.utils.checkpoint import Checkpointer

    parent_dir = config.train.init_from
    mode = validate_mode(config.train.transfer_mode)
    ckpt = Checkpointer(parent_dir, keep=1)
    if not ckpt.slots():
        raise TransferError(
            f"--init_from {parent_dir!r}: no checkpoint slots found "
            f"(want a run directory whose checkpoints/ ring has at "
            f"least one verified slot)")
    meta = ckpt.read_meta()
    parent_domain = sidecar_domain(meta)
    check_domain_compat(meta, config.data.domain,
                        strict=config.train.strict_domain,
                        context="transfer init", telemetry=telemetry,
                        echo=echo)
    try:
        state, next_epoch = ckpt.restore(template_state, params_only=True)
    except (ValueError, KeyError, RuntimeError, FileNotFoundError) as e:
        raise TransferError(
            f"--init_from {parent_dir!r}: parent restore failed — "
            f"transfer requires the parent and child architectures to "
            f"match (same generator/discriminator config): {e}") from e
    provenance = {
        "parent_ckpt": os.path.abspath(parent_dir),
        "parent_epoch": int(next_epoch) - 1,
        "parent_domain": parent_domain,
        "transfer_mode": mode,
        "domain": str(config.data.domain),
    }
    if telemetry is not None:
        telemetry.event("transfer_init", **provenance)
    if echo is not None:
        echo(f"transfer init: {mode} from {parent_dir} "
             f"(parent domain {parent_domain!r}, epoch "
             f"{provenance['parent_epoch']}) -> domain "
             f"{config.data.domain!r}")
    return state, provenance


def freeze_active(config) -> bool:
    return (config.train.init_from is not None
            and config.train.transfer_mode == "encoder_freeze")


def spec_summary(config) -> dict:
    """The run's transfer facts, flat."""
    init_from = config.train.init_from
    return {
        "init_from": init_from,
        "transfer_mode": config.train.transfer_mode if init_from else None,
        "frozen_modules": (list(ENCODER_MODULES) if freeze_active(config)
                           else []),
    }
