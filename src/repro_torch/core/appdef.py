"""Unified application definition (paper Eq. 1-2 and the spot template Eq. 5-6).

    A = (T, R, R_m, P, U, M)          M = (E, W, E_m, W_m)

Tiers, resources, resource->tier mapping, policies, users, and a monitoring
subsystem of events, workflows and their mappings.  Workflows are ordered
action lists executed by the Controller through a pluggable action registry
(a live registry launches instances, mounts checkpoint volumes and
saves/restores state; tests use recording stubs).  The port of
:mod:`repro.core.appdef`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.events import EventKind


@dataclasses.dataclass(frozen=True)
class Tier:
    name: str


@dataclasses.dataclass(frozen=True)
class Resource:
    name: str
    provider: str  # "ec2" in the paper; "tpu" here
    type: str  # "spot_instance" | "EBS" | "pod_slice" | "ckpt_volume"
    size: str


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    spec: dict


@dataclasses.dataclass(frozen=True)
class Workflow:
    name: str
    actions: tuple[str, ...]  # action names resolved via the Controller registry


@dataclasses.dataclass(frozen=True)
class Monitoring:
    """M = (E, W, E_m, W_m)."""

    events: tuple[EventKind, ...]
    workflows: tuple[Workflow, ...]
    event_map: dict[EventKind, str]  # E_m : E -> resource name (or tier name)
    workflow_map: dict[str, EventKind]  # W_m : workflow name -> event

    def workflow_for(self, kind: EventKind) -> Workflow:
        for wf in self.workflows:
            if self.workflow_map.get(wf.name) == kind:
                return wf
        raise KeyError(f"no workflow mapped to {kind}")


@dataclasses.dataclass(frozen=True)
class Application:
    """A = (T, R, R_m, P, U, M)."""

    name: str
    tiers: tuple[Tier, ...]
    resources: tuple[Resource, ...]
    resource_map: dict[str, str]  # resource name -> tier name
    policies: tuple[Policy, ...]
    users: tuple[str, ...]
    monitoring: Monitoring

    def validate(self) -> None:
        tier_names = {t.name for t in self.tiers}
        res_names = {r.name for r in self.resources}
        for r, t in self.resource_map.items():
            if r not in res_names:
                raise ValueError(f"R_m maps unknown resource {r}")
            if t not in tier_names:
                raise ValueError(f"R_m maps to unknown tier {t}")
        wf_names = {w.name for w in self.monitoring.workflows}
        for wf, ev in self.monitoring.workflow_map.items():
            if wf not in wf_names:
                raise ValueError(f"W_m maps unknown workflow {wf}")
            if ev not in self.monitoring.events:
                raise ValueError(f"W_m maps {wf} to unregistered event {ev}")
        for ev, target in self.monitoring.event_map.items():
            if target not in res_names and target not in tier_names:
                raise ValueError(f"E_m maps {ev} to unknown target {target}")


def spot_application(
    name: str,
    instance_type: str,
    a_bid: float,
    s_bid: float,
    sla: dict | None = None,
    ckpt_volume_size: str = "1GB",
) -> Application:
    """The paper's Eq. 5-6 template: single tier, spot instance + EBS volume,
    the three spot events, and the four workflows W_start/W_ckpt/W_terminate/
    W_launch."""
    t1 = Tier("t1")
    r1 = Resource("r1", provider="ec2", type="spot_instance", size=instance_type)
    r2 = Resource("r2", provider="ec2", type="EBS", size=ckpt_volume_size)
    w_start = Workflow("W_start", ("launch_spot", "mount_volume", "copy_job", "start_job"))
    w_ckpt = Workflow("W_ckpt", ("save_results",))
    w_term = Workflow("W_terminate", ("terminate_spot",))
    w_launch = Workflow("W_launch", ("launch_spot", "mount_volume", "resume_tasks"))
    mon = Monitoring(
        events=(EventKind.CKPT, EventKind.TERMINATE, EventKind.LAUNCH),
        workflows=(w_start, w_ckpt, w_term, w_launch),
        event_map={
            EventKind.CKPT: "r1",
            EventKind.TERMINATE: "r1",
            EventKind.LAUNCH: "r1",
        },
        workflow_map={
            "W_ckpt": EventKind.CKPT,
            "W_terminate": EventKind.TERMINATE,
            "W_launch": EventKind.LAUNCH,
        },
    )
    app = Application(
        name=name,
        tiers=(t1,),
        resources=(r1, r2),
        resource_map={"r1": "t1", "r2": "t1"},
        policies=(
            Policy("sla", sla or {}),
            Policy("bids", {"A_bid": a_bid, "S_bid": s_bid}),
        ),
        users=("owner",),
        monitoring=mon,
    )
    app.validate()
    return app


class Controller:
    """Executes workflows through a registry of action handlers."""

    def __init__(self, registry: dict[str, Callable[..., None]]):
        self.registry = dict(registry)
        self.log: list[str] = []

    def execute(self, wf: Workflow, **ctx) -> None:
        for action in wf.actions:
            handler = self.registry.get(action)
            if handler is None:
                raise KeyError(f"no handler registered for action '{action}'")
            handler(**ctx)
            self.log.append(f"{wf.name}:{action}")
