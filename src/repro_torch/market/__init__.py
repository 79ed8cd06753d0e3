"""Capacity-constrained spot market: endogenous prices and auction clearing.

The port's copy of :mod:`repro.market`: host NumPy, the same floats.  The
exogenous traces of :mod:`repro_torch.core.market` model the *price* half of
the paper's "supply and demand" premise; this package adds the *quantity*
half, so a 1,000-replica fleet no longer pays the same price as one instance
and competing simulations can outbid each other:

  * :mod:`~repro_torch.market.background` — per-type capacity and the background
    occupancy reconstructed from the trace generator's calibration
    (:class:`MarketParams`); with zero foreground demand the cleared price
    path is bit-identical to the exogenous trace — the backward-compat
    anchor.
  * :mod:`~repro_torch.market.auction` — uniform-price clearing: the geometric
    displacement ladder (:func:`marginal_price`), single-segment
    (:func:`clear_stack`) and per-period vectorized (:func:`clear_periods`)
    auctions, and the engine-facing :func:`effective_trace` collapse that
    lets every Scenario backend honor contention as a plain trace transform.
  * :mod:`~repro_torch.market.spot_market` — :class:`SpotMarket` /
    :class:`FleetMarket` with the live demand ledger the fleet controller
    registers placements into (cleared views, preemption re-pricing, spot
    quotes for online re-bidding).

See ``docs/market.md`` for the model, the calibration, and the
backward-compatibility contract.
"""

from repro_torch.market.auction import (
    ClearingResult,
    clear_periods,
    clear_periods_torch,
    clear_stack,
    effective_prices,
    effective_trace,
    marginal_price,
    round_to_grid,
)
from repro_torch.market.background import (
    MarketParams,
    free_depth,
    resolve_ref_price,
    utilization,
)
from repro_torch.market.spot_market import FleetMarket, Registration, SpotMarket

__all__ = [
    "ClearingResult",
    "FleetMarket",
    "MarketParams",
    "Registration",
    "SpotMarket",
    "clear_periods",
    "clear_periods_torch",
    "clear_stack",
    "effective_prices",
    "effective_trace",
    "free_depth",
    "marginal_price",
    "resolve_ref_price",
    "round_to_grid",
    "utilization",
]
