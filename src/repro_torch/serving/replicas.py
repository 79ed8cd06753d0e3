"""The replica tier: heterogeneous throughput, boot/drain pipelines, billing.

The port's copy of :mod:`repro.serving.replicas`, in two forms: the NumPy
helpers (the reference engine's, unchanged) and their ``*_torch`` twins on
tensors (the batch engine's, on its device), which perform the same
operations in the same order and so give the same bits.  Every divisor of a
twin is a tensor on the operands' device (:func:`device_scalar`): CUDA
divides by a host scalar through its reciprocal, which is not the IEEE
quotient.  No twin uses a fused operation (``addcmul`` and the like).

A serving fleet mixes a fixed **on-demand floor** (always up, billed at the
on-demand price) with an elastic **spot tier** of one or more instance
types.  Per-replica throughput derives from the same reference-ECU scaling
that :mod:`repro_torch.fleet.workload` uses for batch jobs — the paper's m1.xlarge
(8 ECU) is the reference, so a c1.xlarge (20 ECU) replica serves 2.5x the
requests of the reference replica.

Everything here is *shared arithmetic*: small elementwise helpers that both
serving backends call with the same operand order — the scalar reference
engine passes per-cell scalars / ``(T,)`` vectors, the lockstep batch engine
passes ``(n_cells, T)`` arrays — so per-period capacity, billing, and target
counts are bit-identical across backends by construction (the same
structural trick :mod:`repro_torch.engine.kernels` uses for survival math).

Boot and drain delays are modeled as integer-period shift registers: a
scale-out lands in the last stage of the boot pipe and joins the running
set ``boot periods`` later (booting replicas neither serve, nor bid, nor
bill — billing starts in service); a scale-in first cancels not-yet-booted
replicas (latest stage first), then schedules connection-draining removals
that take effect ``drain periods`` later (draining replicas keep serving,
bidding, and billing until removed).  A preemption may beat a scheduled
drain to the replica; the matured drain then removes ``min(pending,
running)`` — deterministic, and identical in both backends.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.market import InstanceType

__all__ = [
    "REFERENCE_ECU",
    "replica_rps",
    "advance_pipe",
    "cancel_latest",
    "tier_capacity",
    "period_cost",
    "target_counts",
    "advance_pipe_torch",
    "cancel_latest_torch",
    "tier_capacity_torch",
    "period_cost_torch",
    "target_counts_torch",
    "device_scalar",
]

#: The paper's reference instance (m1.xlarge) throughput in ECU; work and
#: request throughput both scale as ``compute_units / REFERENCE_ECU``
#: (cf. ``repro_torch.fleet.workload`` and ``repro_torch.core.provision.algorithm1``).
REFERENCE_ECU = 8.0


def replica_rps(it: InstanceType, rps_capacity_ref: float) -> float:
    """Steady-state requests/s one replica of ``it`` can serve.

    ``rps_capacity_ref`` is the throughput of one reference (8-ECU) replica;
    heterogeneous types scale linearly in ECU, the same first-order model
    the paper applies to batch work.
    """
    return rps_capacity_ref * it.compute_units / REFERENCE_ECU


def advance_pipe(pipe: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Advance a ``(..., K)`` shift register one period.

    Returns ``(matured, shifted)``: stage 0 pops out (matured), everything
    else moves one stage closer, and the freshly vacated last stage is zero
    (new entries land there via ``shifted[..., -1] += n``).
    """
    matured = pipe[..., 0].copy()
    shifted = np.concatenate([pipe[..., 1:], np.zeros_like(pipe[..., :1])], axis=-1)
    return matured, shifted


def cancel_latest(pipe: np.ndarray, n: np.ndarray) -> np.ndarray:
    """Cancel up to ``n`` in-flight entries from ``pipe``, latest stage first.

    Mutates ``pipe`` in place and returns how many were cancelled (the
    remainder of a scale-in must be drained from the running set instead).
    Latest-first means a scale-out immediately followed by a scale-in is a
    no-op, not a boot-then-drain churn.
    """
    cancelled = np.zeros_like(n)
    for k in range(pipe.shape[-1] - 1, -1, -1):
        take = np.minimum(pipe[..., k], n - cancelled)
        pipe[..., k] -= take
        cancelled = cancelled + take
    return cancelled


def tier_capacity(od_rps, n_run: np.ndarray, rps: np.ndarray):
    """Serving capacity in rps: on-demand floor + running spot replicas.

    ``n_run`` is ``(..., T)`` integer counts, ``rps`` the ``(T,)``
    per-replica throughputs.  Accumulated type by type in index order so
    every backend performs the identical float64 addition sequence.
    """
    cap = od_rps + np.zeros(n_run.shape[:-1])
    for t in range(len(rps)):
        cap = cap + n_run[..., t] * rps[t]
    return cap


def period_cost(n_od: int, od_price: float, n_spot: np.ndarray, prices: np.ndarray, period_h: float):
    """Dollars billed over one control period.

    On-demand replicas pay the on-demand price; each *running* spot replica
    pays its type's cleared spot price (booting replicas are not billed —
    see the module docstring).  Type-ordered accumulation, as in
    :func:`tier_capacity`.
    """
    cost = n_od * od_price * period_h
    for t in range(n_spot.shape[-1]):
        cost = cost + n_spot[..., t] * prices[..., t] * period_h
    return cost


def target_counts(
    desired_rps, rps: np.ndarray, factor: np.ndarray, max_spot: int
) -> np.ndarray:
    """Per-type replica targets for a desired total spot capacity.

    The desired rps is split evenly across the spot types (a diversification
    baseline: correlated price spikes cannot take out the whole tier), then
    converted to replica counts with ``ceil``; ``factor`` (``(..., T)``,
    ``>= 1``) over-provisions hazard-aware policies by the expected
    preemption loss.  Counts are clamped to ``[0, max_spot]`` per type.
    """
    share = desired_rps / len(rps)
    out = np.empty(np.shape(factor), dtype=np.int64)
    for t in range(len(rps)):
        n = np.ceil(share * factor[..., t] / rps[t])
        out[..., t] = np.clip(n, 0, max_spot).astype(np.int64)
    return out


# ---------------------------------------------------------------------------
# The torch twins: the batch engine's per-period waves, on its device
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def device_scalar(value: float, device: torch.device) -> torch.Tensor:
    """A 0-d float64 tensor holding ``value`` on ``device``, made once.

    Dividing a CUDA tensor by a host scalar multiplies by the scalar's
    reciprocal; dividing by a tensor on the device rounds the IEEE quotient,
    as NumPy does.  Cached, so a period loop copies nothing to the device.
    """
    return torch.tensor(float(value), dtype=torch.float64, device=device)


def advance_pipe_torch(pipe: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`advance_pipe` on a tensor."""
    matured = pipe[..., 0].clone()
    shifted = torch.cat([pipe[..., 1:], torch.zeros_like(pipe[..., :1])], dim=-1)
    return matured, shifted


def cancel_latest_torch(pipe: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """:func:`cancel_latest` on tensors (``pipe`` changes in place)."""
    cancelled = torch.zeros_like(n)
    for k in range(pipe.shape[-1] - 1, -1, -1):
        take = torch.minimum(pipe[..., k], n - cancelled)
        pipe[..., k] -= take
        cancelled = cancelled + take
    return cancelled


def tier_capacity_torch(od_rps: float, n_run: torch.Tensor, rps: torch.Tensor) -> torch.Tensor:
    """:func:`tier_capacity` on tensors: ``rps`` is the ``(T,)`` float64
    tensor on ``n_run``'s device; the same type-ordered additions."""
    cap = od_rps + torch.zeros(n_run.shape[:-1], dtype=torch.float64, device=n_run.device)
    for t in range(rps.shape[0]):
        cap = cap + n_run[..., t].to(torch.float64) * rps[t]
    return cap


def period_cost_torch(n_od: int, od_price: float, n_spot: torch.Tensor, prices: torch.Tensor,
                      period_h: float) -> torch.Tensor:
    """:func:`period_cost` on tensors: the on-demand term in host floats,
    then each type's ``(n * price) * period_h`` in type order."""
    cost = n_od * od_price * period_h
    for t in range(n_spot.shape[-1]):
        cost = cost + n_spot[..., t].to(torch.float64) * prices[..., t] * period_h
    return cost


def target_counts_torch(desired_rps: torch.Tensor, rps: torch.Tensor, factor: torch.Tensor,
                        max_spot: int) -> torch.Tensor:
    """:func:`target_counts` on tensors: ``share * factor / rps`` rounded
    as NumPy rounds it (every divisor on the device), ``ceil``, clipped to
    ``[0, max_spot]``, int64."""
    dev = desired_rps.device
    share = desired_rps / device_scalar(rps.shape[0], dev)
    out = torch.empty(factor.shape, dtype=torch.int64, device=dev)
    for t in range(rps.shape[0]):
        n = torch.ceil(share * factor[..., t] / rps[t])
        out[..., t] = torch.clamp(n, 0, max_spot).to(torch.int64)
    return out
