"""Placement policies: which instance type (and bid) serves a job.

Four policies span the design space the paper's Algorithm 1 opens up:

  * :class:`Algorithm1Policy` — the paper baseline: A_bid is the minimum
    on-demand price over the feasible list (Eq. 7) and the type minimizes
    Expected Execution Time (Eq. 8) under that single shared bid.
  * :class:`CostGreedyPolicy` — cheapest compute: minimize on-demand $/ECU,
    bidding a fixed margin of the chosen type's own on-demand price.
  * :class:`EETGreedyPolicy` — like Algorithm 1's EET ranking but with
    *per-type* bids (margin x that type's on-demand), decoupling bid from the
    cheapest feasible type.
  * :class:`DiversifiedPolicy` — EET-ranked replicas spread across distinct
    regions (then distinct hardware), so a single regional price spike cannot
    take the whole fleet down at once.

Policies see price *history* (for failure pdfs) and the current spot price,
never the future of the simulation traces.

How a non-paper policy *bids* is itself a pluggable hook (:class:`BidPolicy`):
the default :class:`FixedMarginBid` reproduces the historical
``bid_margin × on-demand`` rule bit for bit, while :class:`ClearingRebid`
re-bids from the currently cleared spot quote on every placement and
migration — the online bid adaptation that matters once capacity-constrained
markets (:mod:`repro_torch.market`) make quotes move with fleet demand.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.core.market import InstanceType, PriceTrace
from repro_torch.core.provision import algorithm1 as provision_algorithm1
from repro_torch.core.provision import expected_execution_time
from repro_torch.core.schemes import FailurePdf, SimParams
from repro_torch.fleet.workload import Job


@dataclasses.dataclass(frozen=True)
class Placement:
    """One (instance type, bid) assignment for a job replica."""

    instance: InstanceType
    bid: float


class BidPolicy:
    """How much to bid for a chosen type: the online-rebid hook.

    Called on every placement *and* every migration, so a policy that reads
    the current quote adapts its bid as the market moves.
    """

    name: str = "base"

    def bid(self, it: InstanceType, ctx: "PlacementContext") -> float:
        raise NotImplementedError


class FixedMarginBid(BidPolicy):
    """The historical rule: ``margin × the type's on-demand price``, always.

    The floats are exactly the old ``ctx.bid_margin * it.on_demand``
    expression, so fleets without a market (or with ``bid_policy`` unset)
    reproduce pre-hook results bit for bit.
    """

    name = "fixed"

    def __init__(self, margin: float = 0.56):
        self.margin = margin

    def bid(self, it: InstanceType, ctx: "PlacementContext") -> float:
        return self.margin * it.on_demand


class ClearingRebid(BidPolicy):
    """Re-bid from the current clearing price.

    Bids ``(1 + markup) × quote`` (on the $0.001 grid), floored at the fixed
    margin and capped at the type's on-demand price — the same cap Eq. 7 puts
    on A_bid, since above on-demand the spot market is pointless.  In a
    capacity-constrained market the quote already includes every competing
    registration, so a re-bidding fleet climbs over contenders until the
    on-demand ceiling stops it.
    """

    name = "rebid"

    def __init__(self, margin: float = 0.56, markup: float = 0.10):
        if markup < 0:
            raise ValueError(f"markup must be >= 0, got {markup}")
        self.margin = margin
        self.markup = markup

    def bid(self, it: InstanceType, ctx: "PlacementContext") -> float:
        floor = self.margin * it.on_demand
        quote = ctx.spot_prices_now.get(it.name)
        if quote is None:
            return floor
        tracked = round((1.0 + self.markup) * quote, 3)
        return min(it.on_demand, max(floor, tracked))


@dataclasses.dataclass
class PlacementContext:
    """What a policy may observe when placing a job.

    ``histories`` is per-type price *history* (the paper's published 3-month
    record), used for failure pdfs; ``spot_prices_now`` is the currently
    quoted spot price per type.  Failure pdfs are cached per (type, bid).
    """

    histories: Mapping[str, PriceTrace]
    params: SimParams
    reference_ecu: float = 8.0
    bid_margin: float = 0.56  # per-type bid = margin * on_demand (non-paper policies)
    spot_prices_now: Mapping[str, float] = dataclasses.field(default_factory=dict)
    #: how non-paper policies bid; None keeps the historical fixed-margin rule
    bid_policy: BidPolicy | None = None
    _pdf_cache: dict[tuple[str, float], FailurePdf] = dataclasses.field(default_factory=dict)

    def bid_for(self, it: InstanceType) -> float:
        """The bid a non-paper policy places on ``it`` right now — routed
        through :attr:`bid_policy` when set (online re-bid), else the
        historical ``bid_margin × on-demand`` (same floats)."""
        if self.bid_policy is not None:
            return self.bid_policy.bid(it, self)
        return self.bid_margin * it.on_demand

    def pdf(self, name: str, bid: float) -> FailurePdf | None:
        hist = self.histories.get(name)
        if hist is None:
            return None
        key = (name, round(bid, 6))
        if key not in self._pdf_cache:
            self._pdf_cache[key] = FailurePdf.from_trace(hist, bid)
        return self._pdf_cache[key]

    def eet(self, it: InstanceType, bid: float, work_s: float) -> float:
        """Eq. 8 for ``work_s`` reference-ECU seconds on ``it`` under ``bid``.

        A history that was *never* below ``bid`` yields an empty (all-censored)
        failure pdf which Eq. 8 would misread as "never fails"; such types are
        infeasible (inf), matching :func:`repro_torch.core.provision.algorithm1`.
        """
        hist = self.histories.get(it.name)
        if hist is None or hist.next_available(bid, 0.0) is None:
            return math.inf
        pdf = self.pdf(it.name, bid)
        w_scaled = work_s * (self.reference_ecu / it.compute_units)
        return expected_execution_time(pdf, w_scaled, self.params.t_r)


class PlacementPolicy:
    """Interface: rank the feasible types and return one or more placements."""

    name: str = "base"

    def place(
        self,
        job: Job,
        now: float,
        remaining_work_s: float,
        feasible: Sequence[InstanceType],
        ctx: PlacementContext,
        k: int | None = None,
    ) -> list[Placement]:
        raise NotImplementedError


class Algorithm1Policy(PlacementPolicy):
    """Paper Algorithm 1 per job: Eq. 7 bid, Eq. 8 type selection.

    Delegates to :func:`repro_torch.core.provision.algorithm1` (sharing the
    context's pdf cache) so the fleet baseline can never drift from the
    paper's implementation.
    """

    name = "algorithm1"

    def place(self, job, now, remaining_work_s, feasible, ctx, k=None):
        decision = provision_algorithm1(
            remaining_work_s,
            job.sla,
            list(feasible),
            ctx.histories,
            recovery_s=ctx.params.t_r,
            reference_ecu=ctx.reference_ecu,
            pdf_cache=ctx._pdf_cache,
        )
        return [Placement(decision.instance, decision.a_bid)]


class CostGreedyPolicy(PlacementPolicy):
    """Cheapest feasible compute: min on-demand $/ECU, per-type margin bid."""

    name = "cost_greedy"

    def place(self, job, now, remaining_work_s, feasible, ctx, k=None):
        def rate(it: InstanceType) -> float:
            return it.on_demand / it.compute_units

        ranked = sorted(feasible, key=rate)
        # prefer a type that is available right now at its bid
        for it in ranked:
            bid = ctx.bid_for(it)
            price = ctx.spot_prices_now.get(it.name)
            if price is None or price <= bid:
                return [Placement(it, bid)]
        it = ranked[0]
        return [Placement(it, ctx.bid_for(it))]


class EETGreedyPolicy(PlacementPolicy):
    """Min-EET with per-type bids (margin x each type's own on-demand)."""

    name = "eet_greedy"

    def place(self, job, now, remaining_work_s, feasible, ctx, k=None):
        ranked = self._ranked(remaining_work_s, feasible, ctx)
        # among currently-available types take the best; else overall best
        for eet, it, bid in ranked:
            price = ctx.spot_prices_now.get(it.name)
            if price is None or price <= bid:
                return [Placement(it, bid)]
        _, it, bid = ranked[0]
        return [Placement(it, bid)]

    @staticmethod
    def _ranked(work_s, feasible, ctx) -> list[tuple[float, InstanceType, float]]:
        out = []
        for it in feasible:
            bid = ctx.bid_for(it)
            out.append((ctx.eet(it, bid, work_s), it, bid))
        out.sort(key=lambda t: (t[0], t[1].on_demand, t[1].name))
        return out


class DiversifiedPolicy(PlacementPolicy):
    """EET-ranked replicas spread across regions (then hardware).

    ``n_replicas`` replicas run the job concurrently; the fleet controller
    keeps the first to finish and cancels the rest.  Spreading replicas over
    distinct regions decorrelates out-of-bid kills: one regional spike leaves
    the other replicas computing, so whole-fleet outages need simultaneous
    spikes everywhere.
    """

    name = "diversified"

    def __init__(self, n_replicas: int = 2):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.n_replicas = n_replicas
        self.name = f"diversified{n_replicas}"

    def place(self, job, now, remaining_work_s, feasible, ctx, k=None):
        k = self.n_replicas if k is None else k
        ranked = EETGreedyPolicy._ranked(remaining_work_s, feasible, ctx)
        placements: list[Placement] = []
        used_regions: set[str] = set()
        used_hardware: set[str] = set()
        # pass 1: distinct regions; pass 2: distinct hardware; pass 3: anything
        for distinct in ("region", "hardware", None):
            for _, it, bid in ranked:
                if len(placements) >= k:
                    return placements
                if any(p.instance.name == it.name for p in placements):
                    continue
                if distinct == "region" and it.region in used_regions:
                    continue
                if distinct == "hardware" and it.hardware in used_hardware:
                    continue
                placements.append(Placement(it, bid))
                used_regions.add(it.region)
                used_hardware.add(it.hardware)
        return placements


def default_policies(n_replicas: int = 2) -> list[PlacementPolicy]:
    """The four policies of the fleet study, in presentation order."""
    return [
        Algorithm1Policy(),
        CostGreedyPolicy(),
        EETGreedyPolicy(),
        DiversifiedPolicy(n_replicas=n_replicas),
    ]
