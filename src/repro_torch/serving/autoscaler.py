"""Pluggable autoscaler policies for the serving tier.

The port's copy of :mod:`repro.serving.autoscaler`.  A policy here takes
host scalars (the reference engine) or tensors on the batch engine's device
and gives the same bits for both: on tensors every divisor and every
constant is a tensor on that device
(:func:`repro_torch.serving.replicas.device_scalar`), since CUDA divides by
a host scalar through its reciprocal.

A policy answers one question each control period: *how much total spot
capacity (rps) should be in service?*  The engine turns the answer into
per-type replica counts (:func:`repro_torch.serving.replicas.target_counts`),
diffs against committed capacity, and pushes deltas through the boot/drain
pipelines — policies never see replicas, only rates, which is what keeps
them trivially vectorizable (the batch backend calls the same
``desired_spot_rps`` with ``(n_cells,)`` arrays that the reference engine
calls with scalars; here the batch engine's arrays are tensors on its
device).

Baselines mirror Qu, Calheiros & Buyya (arxiv 1509.05197):

=================  =============================================================
``target``         Target tracking: size the tier so utilization sits at
                   ``target_utilization`` (EC2 "target tracking" semantics).
``threshold``      Step scaling: current utilization above ``threshold_hi``
                   adds a fixed rps step, below ``threshold_lo`` removes one
                   (classic CloudWatch alarm pairs).
``hazard``         Spot-aware target tracking: same target rule, but flagged
                   ``hazard_aware`` so the engine over-provisions each type by
                   ``1 / (1 - h)`` where ``h`` is the preemption hazard over
                   the next ``hazard_window_s`` from
                   :meth:`repro_torch.core.schemes.FailurePdf.hazard` — capacity
                   expected to be outbid away is bought up front.
=================  =============================================================

Custom policies are first-class: pass any object implementing
:class:`AutoscalerPolicy` to ``run_serving(..., policies={...})``.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.serving.replicas import device_scalar

__all__ = [
    "AutoscalerPolicy",
    "TargetTracking",
    "ThresholdStep",
    "policy_registry",
]


@runtime_checkable
class AutoscalerPolicy(Protocol):
    """Duck type the engine scales with.

    ``name`` labels result axes and cache keys; ``hazard_aware`` asks the
    engine to apply the preemption over-provisioning factor.
    ``desired_spot_rps`` must be elementwise (scalar in -> scalar out,
    array in -> array out) and a pure function of its arguments.  The
    reference engine calls it with host scalars; the batch engine with
    ``(n_cells,)`` float64 tensors on its device for ``rate`` and
    ``spot_run_rps`` (``od_rps`` stays a host float), and the result must
    be such a tensor.  A policy that divides a tensor must divide by a
    tensor on the same device to round as NumPy does.
    """

    name: str
    hazard_aware: bool

    def desired_spot_rps(self, rate, od_rps, spot_run_rps): ...


@dataclasses.dataclass(frozen=True)
class TargetTracking:
    """Hold fleet utilization at ``target_utilization``.

    Desired total capacity is ``rate / target``; the on-demand floor serves
    first, spot covers the remainder.  With ``hazard_aware=True`` this is
    the paper's spot-aware variant ("hazard" in the registry).
    """

    target_utilization: float = 0.7
    hazard_aware: bool = False
    name: str = "target"

    def __post_init__(self):
        if not 0.0 < self.target_utilization <= 1.0:
            raise ValueError(
                f"target_utilization must be in (0, 1], got {self.target_utilization}"
            )

    def desired_spot_rps(self, rate, od_rps, spot_run_rps):
        if isinstance(rate, torch.Tensor):
            dev = rate.device
            x = rate / device_scalar(self.target_utilization, dev) - od_rps
            return torch.maximum(x, device_scalar(0.0, dev))
        return np.maximum(rate / self.target_utilization - od_rps, 0.0)


@dataclasses.dataclass(frozen=True)
class ThresholdStep:
    """Step scaling on utilization alarms.

    Utilization above ``hi`` adds ``step_rps`` of spot capacity, below
    ``lo`` removes ``step_rps``; in the dead band the tier coasts.  Spot
    capacity never goes below zero (the on-demand floor is not scalable).
    """

    hi: float = 0.85
    lo: float = 0.5
    step_rps: float = 100.0
    hazard_aware: bool = False
    name: str = "threshold"

    def __post_init__(self):
        if not 0.0 <= self.lo < self.hi:
            raise ValueError(f"need 0 <= lo < hi, got lo={self.lo} hi={self.hi}")
        if self.step_rps <= 0:
            raise ValueError(f"step_rps must be positive, got {self.step_rps}")

    def desired_spot_rps(self, rate, od_rps, spot_run_rps):
        cap = od_rps + spot_run_rps
        if isinstance(rate, torch.Tensor):
            dev = rate.device
            util = rate / torch.maximum(cap, device_scalar(1e-9, dev))
            step = torch.where(
                util > self.hi,
                device_scalar(self.step_rps, dev),
                torch.where(util < self.lo, device_scalar(-self.step_rps, dev), device_scalar(0.0, dev)),
            )
            return torch.maximum(spot_run_rps + step, device_scalar(0.0, dev))
        util = rate / np.maximum(cap, 1e-9)
        step = np.where(util > self.hi, self.step_rps, np.where(util < self.lo, -self.step_rps, 0.0))
        return np.maximum(spot_run_rps + step, 0.0)


def policy_registry(scenario) -> dict:
    """The built-in policies, parameterized by a :class:`ServingScenario`.

    Keys are the names accepted in ``ServingScenario.policies``; the engine
    selects ``scenario.policies`` from this dict (overridable via
    ``run_serving(..., policies=...)``).
    """
    step_rps = scenario.threshold_step * scenario.rps_capacity_ref
    return {
        "target": TargetTracking(scenario.target_utilization),
        "threshold": ThresholdStep(
            scenario.threshold_hi, scenario.threshold_lo, step_rps
        ),
        "hazard": TargetTracking(
            scenario.target_utilization, hazard_aware=True, name="hazard"
        ),
    }
