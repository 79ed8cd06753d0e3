"""SLO scoring for serving runs: availability, M/M/c p99 latency, $/Mreq.

The port's copy of :mod:`repro.serving.slo`, host NumPy.  ``np.log`` is not
bitwise a device ``log``, so the batch engine brings its per-period arrays
and totals home once, after its period loop, and scoring runs here.

Serving replaces the batch subsystem's deadline objective with the three
service-level metrics of Qu, Calheiros & Buyya (arxiv 1509.05197):

* **availability** — the fraction of offered requests the tier had capacity
  for, ``sum(min(rate, cap) * dt) / sum(rate * dt)`` (1.0 when no traffic
  was offered);
* **p99 queueing latency** — per control period the tier is approximated as
  an M/M/c queue with ``c = round(cap / mu)`` servers of rate ``mu`` (one
  reference replica each); the Erlang-C wait probability gives the tail
  ``P(W > t) = C(c, a) * exp(-(c*mu - lam) * t)`` and hence a closed-form
  p99 of response time.  Overloaded (``rho >= 1``) or zero-capacity periods
  have infinite p99; idle periods have zero.
* **cost per million requests** — dollars billed over requests served, the
  paper's application-centric "what did a request cost" lens.

All scoring is *shared post-processing*: both engine backends record the
same raw per-period arrays and :func:`summarize` folds them identically, so
SLO metrics inherit the backends' bit-identical parity for free.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["p99_latency", "summarize", "ServingResult"]

#: Tail mass defining the latency quantile (0.01 -> p99).
_TAIL = 0.01


def p99_latency(rate, cap, mu: float) -> np.ndarray:
    """Per-period p99 response time (s) of an M/M/c tier, elementwise.

    ``rate`` and ``cap`` are broadcast-compatible arrays of offered rps and
    capacity rps; ``mu`` is one reference replica's service rate.  The
    Erlang-B blocking recurrence runs vectorized with each element frozen
    once ``k`` passes its own server count, so the result is bit-identical
    whether called per cell or on a whole grid.
    """
    lam = np.asarray(rate, dtype=np.float64)
    capacity = np.asarray(cap, dtype=np.float64)
    lam, capacity = np.broadcast_arrays(lam, capacity)
    c = np.where(capacity > 0.0, np.maximum(np.rint(capacity / mu), 1.0), 0.0)
    a = lam / mu

    # Erlang-B recurrence B(k) = a B(k-1) / (k + a B(k-1)), B(0) = 1.
    B = np.ones_like(a)
    kmax = int(c.max()) if c.size else 0
    for k in range(1, kmax + 1):
        Bn = a * B / (k + a * B)
        B = np.where(k <= c, Bn, B)

    with np.errstate(divide="ignore", invalid="ignore"):
        rho = lam / (c * mu)
        # Erlang C (probability an arrival waits) from Erlang B.
        C = B / (1.0 - rho + rho * B)
        t_wait = np.where(
            C > _TAIL, np.log(C / _TAIL) / (c * mu - lam), 0.0
        )
        p99 = 1.0 / mu + t_wait

    p99 = np.where(rho >= 1.0, np.inf, p99)          # unstable queue
    p99 = np.where((c == 0.0) & (lam > 0.0), np.inf, p99)  # no capacity at all
    return np.where(lam == 0.0, 0.0, p99)            # idle period


def summarize(scenario, rates: np.ndarray, capacity_rps: np.ndarray,
              served: np.ndarray, offered: np.ndarray, cost: np.ndarray):
    """Fold raw per-period arrays into per-cell SLO metrics.

    ``rates``/``capacity_rps`` are ``(..., P)``; ``served``/``offered``/
    ``cost`` are the matching ``(...)`` totals the engine accumulated.
    Returns ``(availability, p99_mean_s, slo_violation_s, cost_per_mreq)``.
    """
    availability = np.where(
        offered > 0.0, served / np.where(offered > 0.0, offered, 1.0), 1.0
    )

    p99 = p99_latency(rates, capacity_rps, scenario.rps_capacity_ref)
    busy = rates > 0.0
    finite = busy & np.isfinite(p99)
    n_finite = finite.sum(axis=-1)
    p99_mean = np.where(
        n_finite > 0,
        np.where(finite, p99, 0.0).sum(axis=-1) / np.maximum(n_finite, 1),
        0.0,
    )
    violated = busy & ~(p99 <= scenario.slo_p99_s)
    slo_violation_s = violated.sum(axis=-1) * scenario.control_period_s

    with np.errstate(divide="ignore", invalid="ignore"):
        cost_per_mreq = np.where(served > 0.0, cost / (served / 1e6), np.nan)
    return availability, p99_mean, slo_violation_s, cost_per_mreq


@dataclasses.dataclass
class ServingResult:
    """Everything a serving run produced, per (policy, margin, seed) cell.

    Summary arrays are shaped ``(n_policies, n_margins, n_seeds)``; the
    per-period detail keeps ``capacity_rps`` ``(..., P)`` and ``spot_price``
    ``(..., T, P)`` so figures (and the zero-traffic market anchor) can be
    derived without re-simulation.  Round-trips bit-for-bit through the
    suite :class:`repro_torch.suite.RunStore`.
    """

    policies: tuple[str, ...]
    bid_margins: tuple[float, ...]
    seeds: tuple[int, ...]
    spot_types: tuple[str, ...]
    engine: str
    wall_s: float
    # summary, (Pl, M, S)
    availability: np.ndarray
    p99_latency_s: np.ndarray
    slo_violation_s: np.ndarray
    cost: np.ndarray
    served_requests: np.ndarray
    offered_requests: np.ndarray
    cost_per_mreq: np.ndarray
    n_preempted: np.ndarray
    n_scale_out: np.ndarray
    n_scale_in: np.ndarray
    n_boot_lost: np.ndarray
    # detail
    capacity_rps: np.ndarray  # (Pl, M, S, P)
    spot_price: np.ndarray    # (Pl, M, S, T, P)
    rates: np.ndarray         # (S, P)

    @property
    def n_cells(self) -> int:
        return len(self.policies) * len(self.bid_margins) * len(self.seeds)
