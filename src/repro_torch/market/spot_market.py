"""Capacity-constrained spot markets with a live foreground-demand ledger.

:class:`SpotMarket` wraps one instance type's exogenous trace with a capacity
and the reconstructed background occupancy; live simulations register their
placements as demand (:class:`Registration` intervals), and every view of the
market — a replica's availability, the price it pays, the quote a placement
policy sees — comes out of the uniform-price auction of
:mod:`repro_torch.market.auction` over the background stack plus the ledger.

:class:`FleetMarket` is the per-catalog bundle the fleet controller holds.

Clearing semantics (documented approximations, all deterministic):

  * the ledger is **append-only over time**: a registration's demand counts
    for exactly the interval its attempt was last simulated over, and
    truncations (preemption, sibling cancellation) only shorten the tail —
    history never changes, so re-simulating an attempt from its original
    start always reproduces the past it already lived through;
  * clearing is **first-order**: a new registration re-prices the attempts it
    overlaps (the controller re-simulates them), but demand that *shrinks*
    never re-extends previously preempted attempts — a displaced spot
    instance does not come back, it migrates;
  * ties between equal bids break towards the earlier registration, and an
    unregistered query (a placement being priced before it commits) ranks
    after every equal registered bid — the conservative marginal view.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.market import InstanceType, PriceTrace
from repro_torch.market.auction import clear_periods, clear_stack, marginal_price
from repro_torch.market.background import MarketParams, free_depth, resolve_ref_price
from repro_torch.obs.telemetry import current as _obs_current


@dataclasses.dataclass
class Registration:
    """One replica's registered demand: ``[start, end)`` at ``bid``."""

    id: int
    start: float
    end: float
    bid: float

    @property
    def active_span(self) -> bool:
        return self.end > self.start


class SpotMarket:
    """One instance type's capacity-limited pool and its demand ledger."""

    def __init__(
        self,
        trace: PriceTrace,
        capacity: int,
        params: MarketParams | None = None,
        on_demand: float = 0.0,
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.trace = trace
        self.capacity = int(capacity)
        self.params = params or MarketParams()
        self.ref_price = resolve_ref_price(self.params, on_demand, trace)
        #: background-free slots per exogenous segment
        self.free = free_depth(trace.prices, self.capacity, self.ref_price, self.params)
        self.ledger: list[Registration] = []
        self._next_id = 0

    # -- ledger -------------------------------------------------------------

    def register(self, start: float, end: float, bid: float) -> Registration:
        """Append one replica's demand interval; returns the handle used for
        later truncation / re-pricing."""
        reg = Registration(self._next_id, float(start), float(end), float(bid))
        self._next_id += 1
        self.ledger.append(reg)
        return reg

    def update(self, reg: Registration, start: float, end: float) -> None:
        """Move a registration to the attempt's re-simulated interval."""
        reg.start = float(start)
        reg.end = float(end)

    def truncate(self, reg: Registration, end: float) -> None:
        """Shorten a registration's tail (preemption, cancellation)."""
        reg.end = min(reg.end, float(end))

    # -- views --------------------------------------------------------------

    def _segments(self, regs: Sequence[Registration]):
        """Refine the exogenous segmentation by registration boundaries.

        Returns ``(times, base, free, active)``: refined boundary times
        (first is 0, last the horizon), per-refined-segment exogenous price
        and free depth, and the ``(n_regs, n_segments)`` participation mask.
        """
        tr = self.trace
        cuts = [tr.times]
        for r in regs:
            cuts.append((r.start, r.end))
        times = np.unique(np.clip(np.concatenate(cuts), 0.0, tr.horizon))
        left = times[:-1]
        seg = np.clip(np.searchsorted(tr.times, left, side="right") - 1, 0, len(tr.prices) - 1)
        base = tr.prices[seg]
        free = self.free[seg]
        active = np.zeros((len(regs), len(left)), dtype=bool)
        for i, r in enumerate(regs):
            k0 = int(np.searchsorted(times, r.start))
            k1 = int(np.searchsorted(times, r.end))
            active[i, k0:k1] = True
        return times, base, free, active

    def cleared_view(self, own_bid: float, own_reg: Registration | None = None) -> PriceTrace:
        """The market as one replica sees it: a :class:`PriceTrace` whose
        price is the uniform clearing price wherever the replica is served
        and its own (unmet) marginal price wherever it is not — so
        ``price <= bid`` in the view is *exactly* the auction's served set,
        and the existing out-of-bid simulator machinery needs no changes.

        The replica's own unit participates in every segment (it is demand
        wherever it would want to run); competing demand comes from the
        ledger, ``own_reg`` excluded so a re-simulated attempt does not
        compete with its own stale registration.
        """
        tel = _obs_current()
        if tel.enabled:
            tel.count("market.cleared_views")
        regs = [r for r in self.ledger if r.active_span and r is not own_reg]
        tr = self.trace
        if not regs:
            # alone in the market: rank 1 everywhere, clearing == required
            prices = marginal_price(tr.prices, self.free, 1, self.capacity, self.params)
            return PriceTrace(times=tr.times, prices=prices)

        times, base, free, active = self._segments(regs)
        bids = np.asarray([r.bid for r in regs])
        ids = np.asarray([r.id for r in regs])
        own_id = own_reg.id if own_reg is not None else np.inf

        # own rank: strictly higher bids, plus equal bids registered earlier
        higher = (bids > own_bid) | ((bids == own_bid) & (ids < own_id))
        rank = 1 + (active & higher[:, None]).sum(axis=0)
        required = marginal_price(base, free, rank, self.capacity, self.params)
        served = own_bid >= required

        # uniform clearing price over the full stack (own unit in every segment)
        stack_bids = np.concatenate([bids, [own_bid]])
        stack_active = np.vstack([active, np.ones((1, len(base)), dtype=bool)])
        _, clearing = clear_periods(
            stack_bids, stack_active, base, free, self.capacity, self.params
        )
        return PriceTrace(times=times, prices=np.where(served, clearing, required))

    def clear_at(self, t: float):
        """Auction of the currently registered demand at instant ``t`` (the
        quote placement policies and re-bid hooks observe)."""
        i = self.trace.segment_index(t)
        regs = [r for r in self.ledger if r.active_span and r.start <= t < r.end]
        return clear_stack(
            [r.bid for r in regs],
            float(self.trace.prices[i]),
            int(self.free[i]),
            self.capacity,
            self.params,
        )

    def price_at(self, t: float) -> float:
        """Cleared spot quote at ``t`` (exogenous price when nothing runs)."""
        return self.clear_at(t).price


class FleetMarket:
    """Per-type :class:`SpotMarket` bundle for a fleet controller."""

    def __init__(self, markets: Mapping[str, SpotMarket]):
        self.markets = dict(markets)

    @staticmethod
    def build(
        types: Sequence[InstanceType],
        traces: Mapping[str, PriceTrace],
        capacity: int,
        params: MarketParams | None = None,
    ) -> "FleetMarket":
        return FleetMarket(
            {
                it.name: SpotMarket(traces[it.name], capacity, params, on_demand=it.on_demand)
                for it in types
            }
        )

    def __getitem__(self, name: str) -> SpotMarket:
        return self.markets[name]

    def __contains__(self, name: str) -> bool:
        return name in self.markets

    def price_at(self, name: str, t: float) -> float:
        return self.markets[name].price_at(t)
