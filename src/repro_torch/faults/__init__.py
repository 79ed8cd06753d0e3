"""Fault injection: deterministic, ambient, replayable failure schedules.

A copy of :mod:`repro.faults`: a LIFO-activated :class:`FaultPlan` (the no-op
:data:`NULL` when nothing is active) fires seeded failures at named sites --
the checkpoint manager's ``ckpt.save`` and ``ckpt.restore`` -- so the
trainer's degraded recovery is tested under the paper's "may become
unavailable at any time without any notice" regime.
"""

from repro_torch.faults.plan import (
    ENV_VAR,
    NULL,
    SITES,
    FaultAction,
    FaultPlan,
    FaultRule,
    InjectedFault,
    activate,
    current,
    load_plan,
    plan_from_env,
    register_site,
)

__all__ = [
    "ENV_VAR",
    "NULL",
    "SITES",
    "FaultAction",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "activate",
    "current",
    "load_plan",
    "plan_from_env",
    "register_site",
]
