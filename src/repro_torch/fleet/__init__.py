"""Fleet provisioning subsystem: multi-job scheduling, cross-type migration,
and vectorized sweeps over the 64-type catalog.

The port of :mod:`repro.fleet`.  The controller, policies, workloads and
sweep helpers are host code, copied; :mod:`~repro_torch.fleet.batch` runs its
placement and attempt waves as torch ops on the engine's device.

The paper's Algorithm 1 provisions one instance for one job; this package
provisions a *fleet* of heterogeneous spot instances serving a stream of
jobs, in the direction named by Qu et al. and Voorsluys et al. (PAPERS.md):

  * :mod:`~repro_torch.fleet.workload`   — job streams (arrivals, work, deadlines, SLAs)
  * :mod:`~repro_torch.fleet.policies`   — Algorithm1 / cost-greedy / EET-greedy /
                                     diversified placement
  * :mod:`~repro_torch.fleet.controller` — discrete-event loop over concurrent jobs,
                                     corrected billing, checkpoint-preserving
                                     cross-type migration on out-of-bid kills
                                     and ACC self-terminations
  * :mod:`~repro_torch.fleet.sweep`      — batched trace generation and sweep value
                                     objects; declare studies as a
                                     :class:`repro_torch.engine.FleetScenario` and
                                     run them with :func:`repro_torch.engine.run_fleet`

Capacity-constrained fleets: pass ``capacity=`` (and optionally a
``BidPolicy`` such as :class:`~repro_torch.fleet.policies.ClearingRebid`) to
:class:`FleetController` or set the knobs on a ``FleetScenario`` — placements
then compete in the per-type auctions of :mod:`repro_torch.market`.
"""

from repro_torch.fleet.controller import AttemptRecord, FleetController, FleetResult, JobOutcome
from repro_torch.fleet.policies import (
    Algorithm1Policy,
    BidPolicy,
    ClearingRebid,
    CostGreedyPolicy,
    DiversifiedPolicy,
    EETGreedyPolicy,
    FixedMarginBid,
    Placement,
    PlacementContext,
    PlacementPolicy,
    default_policies,
)
from repro_torch.fleet.sweep import (
    SweepCell,
    SweepConfig,
    batched_fleet_traces,
    select_types,
    summarize,
)
from repro_torch.fleet.workload import Job, Workload, poisson_arrivals, rate_arrivals

__all__ = [
    "Algorithm1Policy",
    "AttemptRecord",
    "BidPolicy",
    "ClearingRebid",
    "CostGreedyPolicy",
    "DiversifiedPolicy",
    "EETGreedyPolicy",
    "FixedMarginBid",
    "FleetController",
    "FleetResult",
    "Job",
    "JobOutcome",
    "Placement",
    "PlacementContext",
    "PlacementPolicy",
    "SweepCell",
    "SweepConfig",
    "Workload",
    "batched_fleet_traces",
    "default_policies",
    "poisson_arrivals",
    "rate_arrivals",
    "select_types",
    "summarize",
]
