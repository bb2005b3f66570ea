"""Model health: numerics of the train step and host-side detectors of
GAN-balance faults. The port's form of the JAX package's
``obs/health.py``.

Two halves, split by where they run:

Device side, called inside the train step (``train/steps.py``): the grad
fn adds the discriminators' raw-output moments under internal
``_health/`` keys, LINEAR in the batch (the ``sum(w·x)/global_batch``
form of the losses), so they sum exactly over accumulated microbatches;
``finalize_health_metrics`` turns them into mean and σ after the
aggregation and adds each network's global gradient norm, its update
ratio ||Δθ|| / (||θ_old|| + 1e-12), one count of non-finite gradient
elements over all four networks and, on an encoder-freeze transfer run,
the frozen group's norm and ratio (which must stay 0). All are tensors on
the step's device: no ``.item()`` and no synchronize. They ride the
metrics dict through the loop's deferred fetch (``train/loop.py``).

Host side, on the rows the loop fetched: ``HealthMonitor`` runs a
non-finite tripwire with the ``on_nan`` policy ("warn" or "halt": raise
``HealthFault``, which ``main.py`` turns into exit 3 with no save), an
EMA divergence detector on the generator totals and a D-collapse
detector, and rolls each epoch up for ``print_epoch_summary``. With a
``telemetry`` (obs/telemetry.py) each detection is a ``health_fault``
event, a halting one flushes the stream before it raises, and each
epoch's rollup is one ``health`` event, as the JAX package's monitor
writes them; the console gets the first detection of each kind an epoch
through ``echo``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

NETWORKS = ("G", "F", "dX", "dY")

# (side, which) pairs for the discriminator raw-output moments; the
# internal `_health/` keys exist only between the grad fn and
# finalize_health_metrics.
DISC_STATS = (("dX", "real"), ("dX", "fake"), ("dY", "real"), ("dY", "fake"))

INTERNAL_PREFIX = "_health/"

# Loss scalars the host-side detectors read.
GEN_TOTAL_KEYS = ("loss_G/total", "loss_F/total")
LOSS_KEYS = GEN_TOTAL_KEYS + ("loss_X/loss", "loss_Y/loss")


def moment_keys(side: str, which: str) -> Tuple[str, str]:
    """Internal (m1, m2) metric keys for one D output tensor."""
    return (
        f"{INTERNAL_PREFIX}{side}_{which}_m1",
        f"{INTERNAL_PREFIX}{side}_{which}_m2",
    )


# ---------------------------------------------------------------------------
# Device side: called inside the train step.
# ---------------------------------------------------------------------------


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all ``tensors`` (optax's
    ``global_norm``): one multi-tensor norm, then the norm of the norms."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(tensors))))


def copy_params(nets: Sequence[torch.nn.Module]
                ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Copies of each network's weights, taken before an in-place update
    so that the update ratio sees the old ones: one multi-tensor copy a
    network."""
    out = []
    for net in nets:
        names = [k for k, _ in net.named_parameters()]
        values = [p.detach() for p in net.parameters()]
        out.append(dict(zip(names, torch._foreach_mul(values, 1.0))))
    return tuple(out)


def param_dicts(nets: Sequence[torch.nn.Module]
                ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """Each network's weights, detached, by name."""
    return tuple({k: p.detach() for k, p in net.named_parameters()}
                 for net in nets)


def nonfinite_count(grads: Sequence[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """The count of non-finite elements over all four gradient sets, as a
    float32 scalar (counts sum like every metric): one concatenation and
    one reduction."""
    flat = torch.cat([g.reshape(-1) for tree in grads for g in tree.values()])
    return (~torch.isfinite(flat)).sum().to(torch.float32)


def _update_ratio(old: Sequence[torch.Tensor], new: Sequence[torch.Tensor]
                  ) -> torch.Tensor:
    old, new = list(old), list(new)
    return (global_norm(torch._foreach_sub(new, old))
            / (global_norm(old) + 1e-12))


def finalize_health_metrics(metrics, grads, old_params, new_params,
                            frozen_group: bool = False):
    """Fold the aggregated moments into mean and σ and add the norm-based
    signals. Call after the microbatch aggregation (the norms are not
    linear), inside the step.

    ``grads``, ``old_params`` and ``new_params`` are (G, F, D_X, D_Y)
    tuples of name -> tensor dicts. The update ratio is the step Adam
    actually took. ``frozen_group`` (encoder-freeze transfer runs) adds
    ``health/gnorm_enc_frozen`` and ``health/upd_ratio_enc_frozen`` over
    both generators' encoder entries; both must be exactly 0."""
    metrics = dict(metrics)
    for side, which in DISC_STATS:
        k1, k2 = moment_keys(side, which)
        if k1 not in metrics:
            continue
        m1 = metrics.pop(k1)
        m2 = metrics.pop(k2)
        metrics[f"health/{side}_{which}_mean"] = m1
        metrics[f"health/{side}_{which}_std"] = torch.sqrt(
            torch.clamp_min(m2 - m1 * m1, 0.0))
    for name, g, p_old, p_new in zip(NETWORKS, grads, old_params, new_params):
        metrics[f"health/gnorm_{name}"] = global_norm(g.values())
        metrics[f"health/upd_ratio_{name}"] = _update_ratio(
            p_old.values(), p_new.values())
    if frozen_group:
        from cyclegan_tpu_torch.domains.transfer import frozen_leaves

        def both(trees):
            return frozen_leaves(trees[0]) + frozen_leaves(trees[1])

        metrics["health/gnorm_enc_frozen"] = global_norm(both(grads))
        metrics["health/upd_ratio_enc_frozen"] = _update_ratio(
            both(old_params), both(new_params))
    metrics["health/nonfinite"] = nonfinite_count(grads)
    return metrics


# ---------------------------------------------------------------------------
# Host side: detectors over fetched metric rows. Pure Python: values
# arrive as numpy scalars on the loop's deferred-fetch path; this half
# never touches a device tensor.
# ---------------------------------------------------------------------------


class HealthFault(RuntimeError):
    """Raised by the monitor when a halting anomaly fires (only the
    non-finite tripwire under on_nan='halt'). main.py turns it into a
    nonzero exit with the last-good checkpoint slot untouched."""

    def __init__(self, kind: str, message: str, details: Optional[dict] = None):
        super().__init__(message)
        self.kind = kind
        self.details = details or {}


class HealthMonitor:
    """Feeds on fetched metric rows (``train/loop.py`` calls `observe` at
    the two fetch sites of its deferred fetch), detects anomalies, and
    rolls each epoch up into its means.

    Detector latency is one deferred-fetch horizon: a poisoned gradient
    surfaces when its row leaves the bounded backpressure window (≤
    MAX_IN_FLIGHT batches later), not at end of run.
    """

    def __init__(
        self,
        telemetry=None,
        on_nan: str = "warn",
        divergence_multiple: float = 4.0,
        divergence_beta: float = 0.98,
        divergence_warmup: int = 20,
        collapse_eps: float = 0.05,
        collapse_patience: int = 50,
        echo=None,
    ):
        if on_nan not in ("warn", "halt", "rollback"):
            raise ValueError(
                f"on_nan must be 'warn', 'halt', or 'rollback', "
                f"got {on_nan!r}")
        self.telemetry = telemetry
        self.on_nan = on_nan
        self.divergence_multiple = float(divergence_multiple)
        self.divergence_beta = float(divergence_beta)
        self.divergence_warmup = int(divergence_warmup)
        self.collapse_eps = float(collapse_eps)
        self.collapse_patience = int(collapse_patience)
        self.echo = echo
        self.fault_counts: Dict[str, int] = {}
        self._epoch = 0
        self._row = 0  # row index within the current epoch
        self._ema: Dict[str, float] = {}
        self._ema_n: Dict[str, int] = {}
        self._collapse_streak: Dict[str, int] = {"dX": 0, "dY": 0}
        self._collapse_fired: Dict[str, bool] = {"dX": False, "dY": False}
        self._reset_epoch_accumulators()

    # -- epoch lifecycle ---------------------------------------------------

    def begin_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self._row = 0
        self._reset_epoch_accumulators()

    def _reset_epoch_accumulators(self) -> None:
        self._acc: Dict[str, list] = {}  # key -> [n, sum, min, max]
        self._epoch_faults: Dict[str, int] = {}
        self._nonfinite_rows = 0
        self._diverged_keys: set = set()

    # -- observation -------------------------------------------------------

    def observe(self, row: dict) -> None:
        """Consume one fetched metrics row (a dict of scalars)."""
        vals: Dict[str, float] = {}
        for key, v in row.items():
            if key.startswith("health/") or key in LOSS_KEYS:
                try:
                    vals[key] = float(v)
                except (TypeError, ValueError):
                    continue
        if not vals:
            return
        self._row += 1
        for key, v in vals.items():
            acc = self._acc.get(key)
            if acc is None:
                self._acc[key] = [1, v, v, v]
            else:
                acc[0] += 1
                acc[1] += v
                acc[2] = min(acc[2], v)
                acc[3] = max(acc[3], v)
        self._detect_nonfinite(vals)
        self._detect_divergence(vals)
        self._detect_collapse(vals)

    # -- detectors ---------------------------------------------------------

    def _detect_nonfinite(self, vals: Dict[str, float]) -> None:
        count = vals.get("health/nonfinite", 0.0)
        bad_losses = [
            k for k in LOSS_KEYS if k in vals and not math.isfinite(vals[k])
        ]
        bad_count = not math.isfinite(count) or count > 0
        if not bad_count and not bad_losses:
            return
        self._nonfinite_rows += 1
        self._fault(
            "nonfinite",
            # "rollback" also raises HealthFault out of the loop; its
            # restore and rewind come with a later slice of the port.
            halt=self.on_nan in ("halt", "rollback"),
            policy=self.on_nan,
            count=None if not math.isfinite(count) else int(count),
            bad_losses=bad_losses,
            message=(
                f"non-finite gradients at epoch {self._epoch} row {self._row}"
                f" (count={count!r}, bad_losses={bad_losses})"
            ),
        )

    def _detect_divergence(self, vals: Dict[str, float]) -> None:
        if self.divergence_multiple <= 0:
            return
        for key in GEN_TOTAL_KEYS:
            v = vals.get(key)
            if v is None or not math.isfinite(v):
                continue  # the non-finite tripwire owns that case
            n = self._ema_n.get(key, 0)
            ema = self._ema.get(key)
            if (
                ema is not None
                and n >= self.divergence_warmup
                and v > self.divergence_multiple * max(ema, 1e-3)
                and key not in self._diverged_keys
            ):
                self._diverged_keys.add(key)  # once per epoch per key
                self._fault(
                    "divergence",
                    halt=False,
                    key=key,
                    value=round(v, 6),
                    ema=round(ema, 6),
                    multiple=self.divergence_multiple,
                    message=(
                        f"{key}={v:.4g} exceeds {self.divergence_multiple}x "
                        f"its EMA ({ema:.4g}) at epoch {self._epoch} "
                        f"row {self._row}"
                    ),
                )
            b = self.divergence_beta
            self._ema[key] = v if ema is None else b * ema + (1.0 - b) * v
            self._ema_n[key] = n + 1

    def _detect_collapse(self, vals: Dict[str, float]) -> None:
        eps = self.collapse_eps
        if eps <= 0:
            return
        for side in ("dX", "dY"):
            stats = [
                vals.get(f"health/{side}_real_mean"),
                vals.get(f"health/{side}_fake_mean"),
                vals.get(f"health/{side}_real_std"),
                vals.get(f"health/{side}_fake_std"),
            ]
            if any(s is None or not math.isfinite(s) for s in stats):
                continue
            real_mean, fake_mean, real_std, fake_std = stats
            # Saturation toward the LSGAN targets: D(real)→1, D(fake)→0
            # with vanishing spread — D has stopped discriminating
            # ANYTHING about the generator's output; its gradient to the
            # generator is dead.
            saturated = (
                abs(real_mean - 1.0) < eps
                and abs(fake_mean) < eps
                and real_std < eps
                and fake_std < eps
            )
            if not saturated:
                self._collapse_streak[side] = 0
                self._collapse_fired[side] = False
                continue
            self._collapse_streak[side] += 1
            if (
                self._collapse_streak[side] >= self.collapse_patience
                and not self._collapse_fired[side]
            ):
                self._collapse_fired[side] = True  # once per episode
                self._fault(
                    "d_collapse",
                    halt=False,
                    side=side,
                    streak=self._collapse_streak[side],
                    real_mean=round(real_mean, 6),
                    fake_mean=round(fake_mean, 6),
                    message=(
                        f"{side} saturated at LSGAN targets for "
                        f"{self._collapse_streak[side]} consecutive rows "
                        f"(D(real)={real_mean:.3f}, D(fake)={fake_mean:.3f}) "
                        f"at epoch {self._epoch}"
                    ),
                )

    def _fault(self, kind: str, halt: bool, message: str,
               policy: str = None, **details) -> None:
        self.fault_counts[kind] = self.fault_counts.get(kind, 0) + 1
        self._epoch_faults[kind] = self._epoch_faults.get(kind, 0) + 1
        tele = self.telemetry
        if tele is not None:
            tele.event(
                "health_fault",
                kind=kind,
                epoch=self._epoch,
                row=self._row,
                policy=policy or ("halt" if halt else "warn"),
                **{k: v for k, v in details.items() if v is not None},
            )
        if self.echo is not None and self._epoch_faults[kind] == 1:
            # once per epoch per kind on the console; the stream has all
            self.echo(f"health: {message}")
        if halt:
            if tele is not None:
                tele.flush()
            raise HealthFault(kind, message, details)

    # -- rollup ------------------------------------------------------------

    def epoch_rollup(self, epoch: Optional[int] = None) -> dict:
        """Emit one `health` event summarizing the epoch's rows (with a
        telemetry); return the epoch's means of the gradient norms and the
        D moments, a flat dict for print_epoch_summary. Resets epoch
        accumulators."""
        epoch = self._epoch if epoch is None else epoch

        def _mean(key):
            acc = self._acc.get(key)
            return acc[1] / acc[0] if acc else None

        def _env(key):
            acc = self._acc.get(key)
            if not acc:
                return None
            return {
                "min": round(acc[2], 6),
                "mean": round(acc[1] / acc[0], 6),
                "max": round(acc[3], 6),
            }

        event = {
            "epoch": epoch,
            "rows": self._row,
            # enc_frozen is the fifth group on encoder-freeze transfer runs;
            # its envelope must pin at 0.
            "gnorm": {
                net: env
                for net in NETWORKS + ("enc_frozen",)
                if (env := _env(f"health/gnorm_{net}")) is not None
            },
            "upd_ratio": {
                net: env
                for net in NETWORKS + ("enc_frozen",)
                if (env := _env(f"health/upd_ratio_{net}")) is not None
            },
            "disc": {
                side: {
                    stat: round(m, 6)
                    for stat in ("real_mean", "fake_mean", "real_std", "fake_std")
                    if (m := _mean(f"health/{side}_{stat}")) is not None
                }
                for side in ("dX", "dY")
            },
            "loss": {
                key: round(m, 6)
                for key in LOSS_KEYS
                if (m := _mean(key)) is not None
            },
            "ema": {k: round(v, 6) for k, v in self._ema.items()},
            "nonfinite_rows": self._nonfinite_rows,
            "anomalies": dict(self._epoch_faults),
        }
        if self.telemetry is not None:
            self.telemetry.event("health", **event)

        flat: Dict[str, float] = {}
        for net in NETWORKS:
            m = _mean(f"health/gnorm_{net}")
            if m is not None:
                flat[f"gnorm_{net}"] = m
        for side, stat in DISC_STATS:
            m = _mean(f"health/{side}_{stat}_mean")
            if m is not None:
                flat[f"{side}_{stat}_mean"] = m
        self._reset_epoch_accumulators()
        return flat


def make_health_monitor(obs_config, telemetry=None) -> Optional[HealthMonitor]:
    """Build the monitor from the config's `obs` section, writing to
    ``telemetry`` where given; None when the health layer is disabled."""
    if not getattr(obs_config, "health", True):
        return None
    return HealthMonitor(
        telemetry=telemetry,
        on_nan=getattr(obs_config, "on_nan", "warn"),
        divergence_multiple=float(
            getattr(obs_config, "divergence_multiple", 4.0)
        ),
        collapse_eps=float(getattr(obs_config, "collapse_eps", 0.05)),
        collapse_patience=int(getattr(obs_config, "collapse_patience", 50)),
        echo=print,
    )
