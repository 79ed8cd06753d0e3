"""Fleet studies on the declarative surface: run a FleetScenario.

The port of :mod:`repro.engine.fleetgrid`.  Two engines evaluate the
(policy × bid_margin × seed) grid:

  * ``engine="controller"`` — the scalar
    :class:`~repro_torch.fleet.controller.FleetController` event loop, one
    cell at a time, host Python (it takes no device, like the scalar
    ``ReferenceEngine``).  Always correct; required for capacity-constrained
    markets (``capacity`` set) and online re-bidding (``bid_policy="rebid"``),
    whose cross-job coupling is inherently sequential.
  * ``engine="batch"`` (the default) — the vectorized fleet engine
    (:mod:`repro_torch.fleet.batch`): every uncontended cell advances in
    lockstep waves of torch ops on the engine's device, the GPU unless
    ``device="cpu"``.  Results equal the controller's per cell (``cost``
    within a few ulp: the controller's compensated ``sum()``); contended /
    re-bidding scenarios are delegated to the controller loop automatically.

The JAX package's third engine, ``"jax"`` (batch with jitted EET scoring),
has no counterpart here: ``"batch"`` already scores on the device.

Trace generation is one batched
:func:`repro_torch.core.market.sample_traces_batch` call per role
(evaluation traces, policy histories) covering the whole (type × seed) grid,
with histories drawn from a disjoint stream block so no policy observes the
future of the traces it is judged on.  The per-scenario inputs (types,
traces, workloads, and the batch engine's derived-input memo) are cached in
a small keyed pool, so repeated runs of one scenario skip regeneration.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from repro_torch.core.market import HOUR
from repro_torch.fleet.controller import FleetController, FleetResult
from repro_torch.fleet.policies import (
    Algorithm1Policy,
    BidPolicy,
    ClearingRebid,
    CostGreedyPolicy,
    DiversifiedPolicy,
    EETGreedyPolicy,
    PlacementPolicy,
)
from repro_torch.fleet.sweep import SweepCell, batched_fleet_traces, select_types, summarize
from repro_torch.fleet.workload import Workload
from repro_torch.engine.scenario import FleetScenario
from repro_torch.obs import telemetry as obs

#: engines run_fleet accepts
FLEET_ENGINES = ("controller", "batch")


def policy_registry(n_replicas: int) -> dict[str, PlacementPolicy]:
    """Named placement policies a FleetScenario can refer to."""
    div = DiversifiedPolicy(n_replicas=n_replicas)
    return {
        "algorithm1": Algorithm1Policy(),
        "cost_greedy": CostGreedyPolicy(),
        "eet_greedy": EETGreedyPolicy(),
        "diversified": div,
        div.name: div,  # e.g. "diversified2"
    }


def resolve_policies(scenario: FleetScenario) -> list[PlacementPolicy]:
    registry = policy_registry(scenario.n_replicas)
    out = []
    for name in scenario.policies:
        if name not in registry:
            raise KeyError(f"unknown policy {name!r}; known: {sorted(registry)}")
        out.append(registry[name])
    return out


def resolve_bid_policy(scenario: FleetScenario, margin: float) -> BidPolicy | None:
    """The per-cell bid hook: ``None`` keeps the historical fixed-margin rule
    (bit-identical), ``"rebid"`` tracks the cleared quote at ``margin`` floor."""
    if scenario.bid_policy == "rebid":
        return ClearingRebid(margin=margin, markup=scenario.rebid_markup)
    return None


@dataclasses.dataclass
class _FleetInputs:
    """Everything a fleet engine needs that is a pure function of the
    scenario's generative fields: catalog slice, trace/history grids, per-seed
    workloads, and the batch engine's derived-input memo."""

    types: list
    traces_by_seed: dict
    hist_by_seed: dict
    workloads: dict
    memo: object  # repro_torch.fleet.batch._Memo


_INPUTS_CACHE: dict[tuple, _FleetInputs] = {}
_INPUTS_CACHE_MAX = 4


def fleet_inputs(scenario: FleetScenario) -> _FleetInputs:
    """Build (or fetch) the cached inputs for a scenario.

    Keyed only on the fields that determine traces and workloads, so scheme /
    margin / policy variations of one study share a single trace grid and
    memo — and benchmark repeats of the same scenario are pure cache hits.
    """
    key = (
        scenario.sla, scenario.n_types, tuple(scenario.seeds), scenario.horizon_days,
        scenario.n_jobs, scenario.mean_interarrival_s, scenario.mean_work_h,
        scenario.deadline_slack,
    )
    inp = _INPUTS_CACHE.get(key)
    if inp is None:
        from repro_torch.fleet.batch import _Memo

        types = select_types(scenario.sla, scenario.n_types)
        traces_by_seed = batched_fleet_traces(types, scenario.seeds, scenario.horizon_days)
        hist_by_seed = batched_fleet_traces(
            types, scenario.seeds, scenario.horizon_days, history=True
        )
        workloads = {
            seed: Workload.poisson(
                scenario.n_jobs,
                scenario.mean_interarrival_s,
                scenario.mean_work_h * HOUR,
                seed=seed,
                sla=scenario.sla,
                deadline_slack=scenario.deadline_slack,
            )
            for seed in scenario.seeds
        }
        inp = _FleetInputs(types, traces_by_seed, hist_by_seed, workloads,
                           _Memo(traces_by_seed, hist_by_seed))
        while len(_INPUTS_CACHE) >= _INPUTS_CACHE_MAX:
            _INPUTS_CACHE.pop(next(iter(_INPUTS_CACHE)))
        _INPUTS_CACHE[key] = inp
    return inp


@dataclasses.dataclass
class FleetGridResult:
    """Outcome of one FleetScenario: per-cell summaries plus full results."""

    scenario: FleetScenario
    cells: list[SweepCell]
    results: dict[tuple[str, float, int], FleetResult]
    wall_s: float
    engine: str = "controller"

    def summary(self) -> str:
        return summarize(self.cells)


def _sweep_cell(policy_name: str, margin: float, seed: int, res: FleetResult,
                wall: float) -> SweepCell:
    return SweepCell(
        policy=policy_name,
        bid_margin=margin,
        seed=seed,
        total_cost=res.total_cost,
        makespan_h=res.makespan / HOUR,
        mean_completion_h=res.mean_completion_s() / HOUR,
        kill_rate=res.kill_rate,
        n_kills=res.n_kills,
        n_migrations=res.n_migrations,
        n_completed=res.n_completed,
        n_jobs=len(res.outcomes),
        n_outages=len(res.outage_intervals()),
        wall_s=wall,
    )


def run_fleet(
    scenario: FleetScenario,
    policies: Sequence[PlacementPolicy] | None = None,
    engine: str = "batch",
    device=None,
) -> FleetGridResult:
    """Evaluate every (policy, bid_margin, seed) cell of a fleet scenario.

    ``engine`` selects the evaluator: ``"batch"`` (vectorized lockstep waves
    on ``device``: the GPU unless ``device="cpu"``, raising when there is no
    GPU) or ``"controller"`` (the scalar event loop on the host; it takes no
    device).  Contended scenarios (``capacity`` set) and online re-bidding
    (``bid_policy="rebid"``) couple cells' jobs through the market and always
    run on the controller loop, whatever ``engine`` says.  The batch engine
    reports ``wall_s`` per cell as the grid's wall time divided evenly across
    cells (lockstep work has no per-cell attribution).
    """
    if engine not in FLEET_ENGINES:
        raise ValueError(f"unknown fleet engine {engine!r}; known: {FLEET_ENGINES}")
    if engine == "controller" and device is not None and torch.device(device).type != "cpu":
        raise ValueError("the controller runs on the host; it takes no device")
    t0 = time.perf_counter()
    policies = list(policies) if policies is not None else resolve_policies(scenario)
    inp = fleet_inputs(scenario)
    delegate = scenario.capacity is not None or scenario.bid_policy == "rebid"
    if engine == "batch" and not delegate:
        from repro_torch.engine.base import resolve_device

        device = resolve_device(device)

    cells: list[SweepCell] = []
    results: dict[tuple[str, float, int], FleetResult] = {}
    if engine == "controller" or delegate:
        for seed in scenario.seeds:
            workload = inp.workloads[seed]
            for margin in scenario.bid_margins:
                for policy in policies:
                    c0 = time.perf_counter()
                    with obs.current().span(
                        "fleet.cell", policy=policy.name, margin=margin, seed=seed
                    ):
                        controller = FleetController(
                            inp.types,
                            inp.traces_by_seed[seed],
                            policy,
                            histories=inp.hist_by_seed[seed],
                            scheme=scenario.scheme,
                            bid_margin=margin,
                            capacity=scenario.capacity,
                            market_params=scenario.market,
                            bid_policy=resolve_bid_policy(scenario, margin),
                        )
                        res = controller.run(workload)
                    wall = time.perf_counter() - c0
                    results[(policy.name, margin, seed)] = res
                    cells.append(_sweep_cell(policy.name, margin, seed, res, wall))
    else:
        from repro_torch.fleet.batch import run_fleet_batch

        results = run_fleet_batch(
            scenario,
            policies,
            inp.types,
            inp.traces_by_seed,
            inp.hist_by_seed,
            inp.workloads,
            memo=inp.memo,
            device=device,
        )
        per_cell = (time.perf_counter() - t0) / max(1, len(results))
        cells = [
            _sweep_cell(name, margin, seed, res, per_cell)
            for (name, margin, seed), res in results.items()
        ]
    return FleetGridResult(
        scenario=scenario, cells=cells, results=results,
        wall_s=time.perf_counter() - t0, engine=engine,
    )
