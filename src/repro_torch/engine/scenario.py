"""Declarative simulation surface: what to simulate, not how.

A :class:`Scenario` pins down one cell grid of the paper's §VII study —
market (explicit traces or a generated slice of the 64-type catalog),
workload (``work_s`` reference-ECU seconds), checkpointing schemes, bid grid,
:class:`~repro_torch.core.schemes.SimParams`, and seeds — as a frozen value
object.  Engines (:mod:`repro_torch.engine.base`) consume a Scenario and
return a structure-of-arrays :class:`~repro_torch.engine.base.EngineResult`.

The fields and their meaning are those of :class:`repro.engine.Scenario`,
so a study moves between the two packages as its :meth:`Scenario.canonical`
dict (:meth:`Scenario.from_reference`).  Capacity-constrained markets
(``capacity=`` / ``demand=``) are not part of this package yet and raise
:class:`NotImplementedError`.
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

#: The bid-limited schemes (an instance lives until its spot price exceeds
#: the bid): everything except ACC, whose instances are never provider-killed.
BID_LIMITED_SCHEMES = (Scheme.NONE, Scheme.OPT, Scheme.HOUR, Scheme.EDGE, Scheme.ADAPT)


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
    # -- capacity-constrained market: not ported, must stay at the defaults
    capacity: int | None = None
    demand: int = 1

    def __post_init__(self):
        if self.capacity is not None or self.demand != 1:
            raise NotImplementedError(
                "capacity-constrained markets (capacity= / demand=) are not ported yet"
            )
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
    ) -> "Scenario":
        """Single explicit-trace study.  The default scheme set includes ACC,
        which this package does not run yet: pass ``BID_LIMITED_SCHEMES``."""
        return Scenario(
            work_s=work_s,
            bids=tuple(float(b) for b in bids),
            schemes=tuple(schemes),
            params=params or SimParams(),
            traces=(trace,),
            labels=(label,),
            initial_saved_work=initial_saved_work,
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
        (``capacity`` set) raises :class:`NotImplementedError`.
        """
        if canonical.get("kind") != "scenario":
            raise ValueError(f"not a scenario canonical dict: kind={canonical.get('kind')!r}")
        if canonical["capacity"] is not None or canonical["demand"] != 1:
            raise NotImplementedError(
                "capacity-constrained markets (capacity= / demand=) are not ported yet"
            )
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

    def materialize(self) -> list[MarketCell]:
        """Resolve the market into concrete ``(label, seed, trace)`` cells.

        Deterministic in the scenario's fields; generated traces come from one
        batched :func:`sample_traces_batch` call with decorrelated
        :func:`ensemble_seed` streams.
        """
        if self.traces is not None:
            labels = self.labels or tuple(f"trace{i}" for i in range(len(self.traces)))
            return [MarketCell(lbl, 0, tr) for lbl, tr in zip(labels, self.traces)]
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
                cells.append(MarketCell(it.name, s, traces[k], it.on_demand))
                k += 1
        return cells

    def market_bids(self, market: MarketCell) -> tuple[float, ...]:
        """Absolute $/h bids for one market cell (scaled when
        ``bid_fractions`` is set; the $0.001 grid rounding matches the
        catalog's price grid)."""
        if not self.bid_fractions:
            return self.bids
        return tuple(round(f * market.on_demand, 3) for f in self.bids)

    def canonical(self) -> dict:
        """Stable plain-dict form of every engine-visible field.

        The same form as :meth:`repro.engine.Scenario.canonical` without its
        ``market`` entry (the calibration of contended markets, which this
        package does not model).  Explicit traces enter as content digests;
        every numeric field is normalized to ``float``/``int``.
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
            "capacity": None,
            "demand": 1,
        }
