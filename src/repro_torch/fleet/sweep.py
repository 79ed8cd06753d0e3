"""Fleet-sweep building blocks: type selection and batched trace generation.

The port's copy of :mod:`repro.fleet.sweep` (host NumPy, the same traces).

The sweep loop itself lives in :mod:`repro_torch.engine.fleetgrid` (declare a
:class:`repro_torch.engine.FleetScenario`, call :func:`repro_torch.engine.run_fleet`);
this module keeps the pieces it shares with the engine — type selection and
the NumPy-batched, :func:`repro_torch.core.market.ensemble_seed`-decorrelated trace
generation (policy histories from a disjoint seed block so no policy sees the
future of the traces it is evaluated on) — plus the :class:`SweepConfig` /
:class:`SweepCell` value objects and the :func:`summarize` table.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.market import HOUR, InstanceType, PriceTrace, catalog, ensemble_seed, sample_traces_batch, TraceModel
from repro_torch.core.provision import SLA
from repro_torch.core.schemes import Scheme

_HISTORY_SEED_OFFSET = 7_654_321  # disjoint stream block for policy histories


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    n_jobs: int = 50
    mean_interarrival_s: float = 0.5 * HOUR
    mean_work_h: float = 4.0
    horizon_days: float = 10.0
    n_types: int = 16
    seeds: tuple[int, ...] = (0, 1, 2, 3)
    bid_margins: tuple[float, ...] = (0.56,)
    scheme: Scheme = Scheme.HOUR
    sla: SLA = dataclasses.field(default_factory=lambda: SLA(min_compute_units=4.0, os="linux"))
    n_replicas: int = 2
    deadline_slack: float | None = 4.0


@dataclasses.dataclass(frozen=True)
class SweepCell:
    policy: str
    bid_margin: float
    seed: int
    total_cost: float
    makespan_h: float
    mean_completion_h: float
    kill_rate: float
    n_kills: int
    n_migrations: int
    n_completed: int
    n_jobs: int
    n_outages: int
    wall_s: float


def select_types(sla: SLA, n_types: int) -> list[InstanceType]:
    """SLA-feasible slice of the 64-type catalog, spread across regions: types
    are taken cheapest-first per region round-robin so small slices still
    cross regions (diversification needs somewhere to go)."""
    feasible = [it for it in catalog() if sla.admits(it)]
    by_region: dict[str, list[InstanceType]] = {}
    for it in sorted(feasible, key=lambda x: (x.on_demand, x.name)):
        by_region.setdefault(it.region, []).append(it)
    out: list[InstanceType] = []
    while len(out) < min(n_types, len(feasible)):
        for region in sorted(by_region):
            if by_region[region] and len(out) < n_types:
                out.append(by_region[region].pop(0))
    return out


def batched_fleet_traces(
    types: Sequence[InstanceType],
    seeds: Sequence[int],
    horizon_days: float,
    history: bool = False,
) -> dict[int, dict[str, PriceTrace]]:
    """One batched generation call for the whole (type x seed) grid.

    Returns ``{seed: {type_name: trace}}``.  With ``history=True`` the rng
    streams come from a disjoint block, so histories and evaluation traces of
    the same nominal seed are independent.
    """
    offset = _HISTORY_SEED_OFFSET if history else 0
    models, stream_seeds = [], []
    for it in types:
        m = TraceModel.for_instance(it)
        for s in seeds:
            models.append(m)
            stream_seeds.append(ensemble_seed(it, s + offset))
    traces = sample_traces_batch(models, horizon_days * 24 * HOUR, stream_seeds)
    out: dict[int, dict[str, PriceTrace]] = {s: {} for s in seeds}
    k = 0
    for it in types:
        for s in seeds:
            out[s][it.name] = traces[k]
            k += 1
    return out



def summarize(cells: Sequence[SweepCell]) -> str:
    """Seed-averaged table: one row per (policy, bid_margin)."""
    groups: dict[tuple[str, float], list[SweepCell]] = {}
    for c in cells:
        groups.setdefault((c.policy, c.bid_margin), []).append(c)

    def mean(xs):
        finite = [x for x in xs if x < float("inf")]
        return sum(finite) / len(finite) if finite else float("inf")

    header = (
        f"{'policy':<14} {'margin':>6} {'cost_$':>9} {'mean_done_h':>11} "
        f"{'kill_rate':>9} {'migr':>5} {'done':>9} {'outages':>7} {'wall_s':>7}"
    )
    lines = [header, "-" * len(header)]
    for (policy, margin), cs in sorted(groups.items()):
        done = sum(c.n_completed for c in cs)
        total = sum(c.n_jobs for c in cs)
        lines.append(
            f"{policy:<14} {margin:>6.2f} {mean([c.total_cost for c in cs]):>9.2f} "
            f"{mean([c.mean_completion_h for c in cs]):>11.2f} "
            f"{mean([c.kill_rate for c in cs]):>9.3f} "
            f"{sum(c.n_migrations for c in cs):>5d} "
            f"{done:>4d}/{total:<4d} "
            f"{sum(c.n_outages for c in cs):>7d} "
            f"{mean([c.wall_s for c in cs]):>7.2f}"
        )
    return "\n".join(lines)
