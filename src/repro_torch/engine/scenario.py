"""Declarative simulation surface: what to simulate, not how.

A :class:`Scenario` pins down one cell grid of the paper's §VII study —
market (explicit traces or a generated slice of the 64-type catalog),
workload (``work_s`` reference-ECU seconds), checkpointing schemes, bid grid,
:class:`~repro_torch.core.schemes.SimParams`, and seeds — as a frozen value
object.  Engines (:mod:`repro_torch.engine.base`) consume a Scenario and
return a structure-of-arrays :class:`~repro_torch.engine.base.EngineResult`.

The fields and their meaning are those of :class:`repro.engine.Scenario`,
so a study moves between the two packages as its :meth:`Scenario.canonical`
dict (:meth:`Scenario.from_reference`).

:class:`FleetScenario` is the fleet-study analogue: a declarative
``(policy × bid-margin × seed)`` grid over a workload stream, consumed by
:func:`repro_torch.engine.fleetgrid.run_fleet`.

Capacity-constrained markets plug in at materialization (see
:mod:`repro_torch.market`): ``capacity`` bounds the per-type pool,
``demand`` is the depth of the co-located foreground block a cell's job is
the marginal replica of, and each exogenous trace is replaced by its
auction-cleared view — so the sweep honors preemption-by-outbid through the
one out-of-bid rule it already implements, bit-identically.
``capacity=None`` (the default) keeps the infinitely deep market.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np

from repro_torch.core.market import (
    HOUR,
    InstanceType,
    PriceTrace,
    TraceModel,
    catalog,
    ensemble_seed,
    sample_traces_batch,
)
from repro_torch.core.provision import SLA
from repro_torch.core.schemes import Scheme, SimParams
from repro_torch.market import MarketParams, effective_trace

#: The bid-limited schemes (an instance lives until its spot price exceeds
#: the bid): everything except ACC, whose instances are never provider-killed.
BID_LIMITED_SCHEMES = (Scheme.NONE, Scheme.OPT, Scheme.HOUR, Scheme.EDGE, Scheme.ADAPT)

#: Every scheme the engine evaluates on the cell grid: the bid-limited five
#: through the fused sweep, ACC through its own lockstep seek / lease walk.
BATCHED_SCHEMES = BID_LIMITED_SCHEMES + (Scheme.ACC,)


def _trace_digest(trace: PriceTrace) -> dict:
    """Content digest of a piecewise-constant trace for canonical hashing:
    the exact bytes of both arrays enter through sha256."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(trace.times, dtype=np.float64).tobytes())
    h.update(np.ascontiguousarray(trace.prices, dtype=np.float64).tobytes())
    return {
        "n_segments": len(trace.prices),
        "horizon": float(trace.horizon),
        "sha256": h.hexdigest(),
    }


@dataclasses.dataclass(frozen=True)
class MarketCell:
    """One materialized (instance/trace label, seed, trace) market point.

    ``on_demand`` is the owning instance type's on-demand $/h (0.0 for
    explicit traces, which have no catalog entry) — the base that
    ``Scenario.bid_fractions`` bids are scaled by.
    """

    label: str
    seed: int
    trace: PriceTrace
    on_demand: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class Scenario:
    """One declarative simulation study: market × workload × schemes × bids.

    Exactly one of ``traces`` (explicit market) or ``instances`` (generated
    market) must be set.  With ``instances``, one calibrated synthetic trace
    is generated per (instance, seed) with :func:`ensemble_seed`-decorrelated
    streams; with ``traces``, ``seeds`` is ignored and each trace is one
    market cell.

    ``bids`` are absolute $/h values, or fractions of each instance's
    on-demand price when ``bid_fractions`` is set.
    """

    work_s: float
    bids: tuple[float, ...]
    schemes: tuple[Scheme, ...] = BID_LIMITED_SCHEMES
    params: SimParams = dataclasses.field(default_factory=SimParams)
    # -- market: explicit ...
    traces: tuple[PriceTrace, ...] | None = None
    labels: tuple[str, ...] | None = None
    # -- ... or generated
    instances: tuple[InstanceType, ...] | None = None
    horizon_days: float = 30.0
    seeds: tuple[int, ...] = (0,)
    # -- workload knobs
    initial_saved_work: float = 0.0
    sla: SLA | None = None  # admission filter applied to ``instances``
    bid_fractions: bool = False
    # -- capacity-constrained market (None = the infinitely deep pool)
    #: per-type supply: how many instances of each market cell's type exist
    capacity: int | None = None
    #: foreground block depth: the cell's job is the marginal replica of
    #: ``demand`` co-located lockstep units, so it runs only when the whole
    #: block clears the auction and pays the block's uniform clearing price
    demand: int = 1
    #: background-occupancy / displacement-ladder calibration
    market: MarketParams = dataclasses.field(default_factory=MarketParams)

    def __post_init__(self):
        if self.work_s <= 0:
            raise ValueError(f"work_s must be positive, got {self.work_s}")
        if not self.bids:
            raise ValueError("bids must be non-empty")
        if not self.schemes:
            raise ValueError("schemes must be non-empty")
        if (self.traces is None) == (self.instances is None):
            raise ValueError("set exactly one of traces= or instances=")
        if self.traces is not None and self.labels is not None:
            if len(self.labels) != len(self.traces):
                raise ValueError("labels must parallel traces")
        if self.instances is not None and not self.seeds:
            raise ValueError("seeds must be non-empty for a generated market")
        if not 0.0 <= self.initial_saved_work <= self.work_s:
            raise ValueError(
                f"initial_saved_work {self.initial_saved_work} outside [0, {self.work_s}]"
            )
        if self.bid_fractions and self.instances is None:
            raise ValueError("bid_fractions needs instances= (explicit traces have no on-demand)")
        if self.capacity is not None and self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.demand < 1:
            raise ValueError(f"demand must be >= 1, got {self.demand}")
        if self.demand > 1 and self.capacity is None:
            raise ValueError("demand > 1 needs capacity= (an infinitely deep market never clears)")

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_trace(
        trace: PriceTrace,
        work_s: float,
        bids: Sequence[float],
        schemes: Sequence[Scheme] = tuple(Scheme),
        params: SimParams | None = None,
        label: str = "trace0",
        initial_saved_work: float = 0.0,
        capacity: int | None = None,
        demand: int = 1,
        market: MarketParams | None = None,
    ) -> "Scenario":
        """Single explicit-trace study over every scheme by default (ACC
        included), as :meth:`repro.engine.Scenario.from_trace`."""
        return Scenario(
            work_s=work_s,
            bids=tuple(float(b) for b in bids),
            schemes=tuple(schemes),
            params=params or SimParams(),
            traces=(trace,),
            labels=(label,),
            initial_saved_work=initial_saved_work,
            capacity=capacity,
            demand=demand,
            market=market or MarketParams(),
        )

    @staticmethod
    def grid(
        work_s: float,
        bids: Sequence[float],
        instances: Sequence[InstanceType] | None = None,
        schemes: Sequence[Scheme] = BID_LIMITED_SCHEMES,
        params: SimParams | None = None,
        horizon_days: float = 30.0,
        seeds: Sequence[int] = (0,),
        sla: SLA | None = None,
        bid_fractions: bool = False,
        capacity: int | None = None,
        demand: int = 1,
        market: MarketParams | None = None,
    ) -> "Scenario":
        """The §VII grid: (instance type × bid × seed × scheme) cells over
        generated traces.  ``instances`` defaults to the full 64-type catalog
        (filtered by ``sla`` if given).  With ``bid_fractions=True`` each bid
        is scaled by the instance's own on-demand price."""
        if instances is None:
            instances = catalog()
        if sla is not None:
            instances = [it for it in instances if sla.admits(it)]
        if not instances:
            raise ValueError("no instances left after SLA filter")
        return Scenario(
            work_s=work_s,
            bids=tuple(float(b) for b in bids),
            schemes=tuple(schemes),
            params=params or SimParams(),
            instances=tuple(instances),
            horizon_days=horizon_days,
            seeds=tuple(int(s) for s in seeds),
            sla=sla,
            bid_fractions=bid_fractions,
            capacity=capacity,
            demand=demand,
            market=market or MarketParams(),
        )

    @staticmethod
    def from_reference(
        canonical: dict, traces: Sequence[tuple[np.ndarray, np.ndarray]] | None = None
    ) -> "Scenario":
        """Rebuild a study from the plain dict of :meth:`canonical` (also the
        form :meth:`repro.engine.Scenario.canonical` returns).

        A canonical dict holds explicit traces only as content digests, so
        an explicit-trace study needs its ``traces`` as ``(times, prices)``
        array pairs; each pair must match its digest.  A contended market
        carries its ``capacity``, ``demand`` and ``market`` calibration.
        """
        if canonical.get("kind") != "scenario":
            raise ValueError(f"not a scenario canonical dict: kind={canonical.get('kind')!r}")
        explicit = None
        if canonical["traces"] is not None:
            if traces is None or len(traces) != len(canonical["traces"]):
                raise ValueError("an explicit-trace scenario needs one (times, prices) pair per trace")
            explicit = []
            for i, ((times, prices), digest) in enumerate(zip(traces, canonical["traces"])):
                tr = PriceTrace(
                    times=np.asarray(times, dtype=np.float64),
                    prices=np.asarray(prices, dtype=np.float64),
                )
                if _trace_digest(tr) != digest:
                    raise ValueError(f"trace {i} does not match its canonical digest")
                explicit.append(tr)
            explicit = tuple(explicit)
        elif traces is not None:
            raise ValueError("traces= given for a generated-market scenario")
        sla = canonical["sla"]
        return Scenario(
            work_s=float(canonical["work_s"]),
            bids=tuple(float(b) for b in canonical["bids"]),
            schemes=tuple(Scheme(v) for v in canonical["schemes"]),
            params=SimParams(**{k: float(v) for k, v in canonical["params"].items()}),
            traces=explicit,
            labels=None if canonical["labels"] is None else tuple(canonical["labels"]),
            instances=None
            if canonical["instances"] is None
            else tuple(InstanceType(**it) for it in canonical["instances"]),
            horizon_days=float(canonical["horizon_days"]),
            seeds=tuple(int(s) for s in canonical["seeds"]),
            initial_saved_work=float(canonical["initial_saved_work"]),
            sla=None
            if sla is None
            else SLA(
                min_compute_units=float(sla["min_compute_units"]),
                regions=tuple(sla["regions"]),
                os=sla["os"],
            ),
            bid_fractions=bool(canonical["bid_fractions"]),
            capacity=None if canonical["capacity"] is None else int(canonical["capacity"]),
            demand=int(canonical["demand"]),
            market=MarketParams(**canonical["market"]),
        )

    # -- materialization ----------------------------------------------------

    @property
    def n_markets(self) -> int:
        if self.traces is not None:
            return len(self.traces)
        return len(self.instances) * len(self.seeds)

    @property
    def n_cells(self) -> int:
        """Total (market, bid, scheme) simulation cells."""
        return self.n_markets * len(self.bids) * len(self.schemes)

    def _clear_cell(self, cell: MarketCell) -> MarketCell:
        """Replace a cell's exogenous trace with its auction-cleared view.

        With ``capacity=None`` the cell passes through untouched (the same
        trace object); otherwise the cleared trace shares the exogenous
        segment boundaries and prices every segment at the marginal cost of
        the ``demand``-th foreground unit, so out-of-bid preemption in the
        sweep *is* auction preemption.
        """
        if self.capacity is None:
            return cell
        cleared = effective_trace(
            cell.trace, self.capacity, self.demand, self.market, on_demand=cell.on_demand
        )
        return dataclasses.replace(cell, trace=cleared)

    def materialize(self) -> list[MarketCell]:
        """Resolve the market into concrete ``(label, seed, trace)`` cells.

        Deterministic in the scenario's fields; generated traces come from one
        batched :func:`sample_traces_batch` call with decorrelated
        :func:`ensemble_seed` streams.  With ``capacity`` set, every cell's
        trace is the auction-cleared view (:meth:`_clear_cell`) — the single
        point where contention enters.
        """
        if self.traces is not None:
            labels = self.labels or tuple(f"trace{i}" for i in range(len(self.traces)))
            return [self._clear_cell(MarketCell(lbl, 0, tr)) for lbl, tr in zip(labels, self.traces)]
        models, streams = [], []
        for it in self.instances:
            m = TraceModel.for_instance(it)
            for s in self.seeds:
                models.append(m)
                streams.append(ensemble_seed(it, s))
        traces = sample_traces_batch(models, self.horizon_days * 24 * HOUR, streams)
        cells: list[MarketCell] = []
        k = 0
        for it in self.instances:
            for s in self.seeds:
                cells.append(self._clear_cell(MarketCell(it.name, s, traces[k], it.on_demand)))
                k += 1
        return cells

    def materialize_cell(self, market: int) -> MarketCell:
        """Resolve one market cell without generating the whole grid.

        Equal to ``materialize()[market]``: generated traces come from the
        same :func:`sample_traces_batch` streams, which are deterministic per
        (model, seed) whatever the batch holds.  Feeds one live run
        (``SpotTrainer.from_scenario``).
        """
        if self.traces is not None:
            labels = self.labels or tuple(f"trace{i}" for i in range(len(self.traces)))
            return self._clear_cell(MarketCell(labels[market], 0, self.traces[market]))
        it = self.instances[market // len(self.seeds)]
        seed = self.seeds[market % len(self.seeds)]
        trace = sample_traces_batch(
            [TraceModel.for_instance(it)], self.horizon_days * 24 * HOUR, [ensemble_seed(it, seed)]
        )[0]
        return self._clear_cell(MarketCell(it.name, seed, trace, it.on_demand))

    def market_bids(self, market: MarketCell) -> tuple[float, ...]:
        """Absolute $/h bids for one market cell (scaled when
        ``bid_fractions`` is set; the $0.001 grid rounding matches the
        catalog's price grid)."""
        if not self.bid_fractions:
            return self.bids
        return tuple(round(f * market.on_demand, 3) for f in self.bids)

    def canonical(self) -> dict:
        """Stable plain-dict form of every engine-visible field.

        The same form as :meth:`repro.engine.Scenario.canonical`: two
        scenarios are equal as simulations iff their canonical dicts are
        equal.  Explicit traces enter as content digests; every numeric field
        is normalized to ``float``/``int``.
        """
        return {
            "kind": "scenario",
            "work_s": float(self.work_s),
            "bids": [float(b) for b in self.bids],
            "schemes": [s.value for s in self.schemes],
            "params": {k: float(v) for k, v in dataclasses.asdict(self.params).items()},
            "traces": None
            if self.traces is None
            else [_trace_digest(t) for t in self.traces],
            "labels": None if self.labels is None else [str(x) for x in self.labels],
            "instances": None
            if self.instances is None
            else [
                {
                    "name": it.name,
                    "hardware": it.hardware,
                    "region": it.region,
                    "os": it.os,
                    "on_demand": float(it.on_demand),
                    "compute_units": float(it.compute_units),
                }
                for it in self.instances
            ],
            "horizon_days": float(self.horizon_days),
            "seeds": [int(s) for s in self.seeds],
            "initial_saved_work": float(self.initial_saved_work),
            "sla": None
            if self.sla is None
            else {
                "min_compute_units": float(self.sla.min_compute_units),
                "regions": [str(r) for r in self.sla.regions],
                "os": self.sla.os,
            },
            "bid_fractions": bool(self.bid_fractions),
            "capacity": None if self.capacity is None else int(self.capacity),
            "demand": int(self.demand),
            "market": _canonical_market_params(self.market),
        }


def _canonical_market_params(params: MarketParams) -> dict:
    d = dataclasses.asdict(params)
    return {k: (None if v is None else float(v)) for k, v in d.items()}


@dataclasses.dataclass(frozen=True, eq=False)
class FleetScenario:
    """Declarative fleet study: (policy × bid-margin × seed) over a job stream.

    The fields and their meaning are those of
    :class:`repro.engine.FleetScenario`.  ``policies`` names placement
    policies from :func:`repro_torch.engine.fleetgrid.policy_registry`; pass
    policy *objects* directly to :func:`repro_torch.engine.fleetgrid.run_fleet`
    to override.
    """

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
    policies: tuple[str, ...] = ("algorithm1", "cost_greedy", "eet_greedy", "diversified")
    # -- capacity-constrained market (None = the infinitely deep pools)
    #: per-type supply; with it set the controller registers every placement
    #: as demand, so large fleets move prices against themselves and each
    #: other, and rising clearing prices preempt outbid replicas
    capacity: int | None = None
    #: background/displacement calibration shared by every type's pool
    market: MarketParams = dataclasses.field(default_factory=MarketParams)
    #: online bid policy: ``"fixed"`` = ``bid_margin × on-demand``;
    #: ``"rebid"`` re-bids from the currently cleared spot quote on every
    #: (re-)placement (see :class:`repro_torch.fleet.policies.ClearingRebid`)
    bid_policy: str = "fixed"
    #: markup over the cleared quote used by ``bid_policy="rebid"``
    rebid_markup: float = 0.10

    def __post_init__(self):
        if self.n_jobs <= 0 or self.n_types <= 0:
            raise ValueError("n_jobs and n_types must be positive")
        if not self.seeds or not self.bid_margins or not self.policies:
            raise ValueError("seeds, bid_margins and policies must be non-empty")
        if self.capacity is not None and self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.bid_policy not in ("fixed", "rebid"):
            raise ValueError(f"unknown bid_policy {self.bid_policy!r}; expected fixed|rebid")

    @staticmethod
    def from_sweep_config(cfg, policies: Sequence[str] | None = None) -> "FleetScenario":
        """Lift a :class:`~repro_torch.fleet.sweep.SweepConfig` into the
        declarative surface."""
        kwargs = {}
        if policies is not None:
            kwargs["policies"] = tuple(policies)
        return FleetScenario(
            n_jobs=cfg.n_jobs,
            mean_interarrival_s=cfg.mean_interarrival_s,
            mean_work_h=cfg.mean_work_h,
            horizon_days=cfg.horizon_days,
            n_types=cfg.n_types,
            seeds=tuple(cfg.seeds),
            bid_margins=tuple(cfg.bid_margins),
            scheme=cfg.scheme,
            sla=cfg.sla,
            n_replicas=cfg.n_replicas,
            deadline_slack=cfg.deadline_slack,
            **kwargs,
        )

    def canonical(self) -> dict:
        """Stable plain-dict form for content hashing, the same form as
        :meth:`repro.engine.FleetScenario.canonical`."""
        return {
            "kind": "fleet",
            "n_jobs": int(self.n_jobs),
            "mean_interarrival_s": float(self.mean_interarrival_s),
            "mean_work_h": float(self.mean_work_h),
            "horizon_days": float(self.horizon_days),
            "n_types": int(self.n_types),
            "seeds": [int(s) for s in self.seeds],
            "bid_margins": [float(m) for m in self.bid_margins],
            "scheme": self.scheme.value,
            "sla": {
                "min_compute_units": float(self.sla.min_compute_units),
                "regions": [str(r) for r in self.sla.regions],
                "os": self.sla.os,
            },
            "n_replicas": int(self.n_replicas),
            "deadline_slack": None if self.deadline_slack is None else float(self.deadline_slack),
            "policies": [str(p) for p in self.policies],
            "capacity": None if self.capacity is None else int(self.capacity),
            "market": _canonical_market_params(self.market),
            "bid_policy": str(self.bid_policy),
            "rebid_markup": float(self.rebid_markup),
        }
