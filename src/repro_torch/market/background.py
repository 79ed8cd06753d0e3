"""Background demand: what occupies a capacity-limited spot pool.

The paper's premise is that "the spot price changes periodically based on
supply and demand" — the exogenous regime-switching traces of
:mod:`repro_torch.core.market` are the *price* half of that story.  This module
supplies the *quantity* half: given a price path and a per-type capacity, it
reconstructs how much of the pool the (unobserved) background customers were
holding at each instant, so that foreground demand registered by live
simulations competes for the remainder.

The inversion is calibrated against the same anchors the trace generator uses
(:meth:`repro_torch.core.market.TraceModel.for_instance` puts the base band at
``0.53 x on-demand`` and full-price excursions at/above on-demand):

  * at (or below) the base band, the pool runs at ``util_base`` occupancy —
    spot capacity is the provider's *slack*, never empty;
  * occupancy rises linearly with price until ``full_frac x ref_price``
    (on-demand by default), where the pool is sold out — spike segments are
    exactly the demand-exceeds-supply events the generator models.

The backward-compat anchor is structural: background demand only *occupies*
slots, it never re-prices them — with zero foreground demand the cleared
price of every segment is the exogenous trace price, bit for bit (see
:func:`repro_torch.market.auction.effective_prices` with ``demand=0`` and the
anchor tests in ``tests/market/``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.market import PriceTrace


@dataclasses.dataclass(frozen=True)
class MarketParams:
    """Knobs of the capacity-constrained market model.

    ``price_impact`` is the multiplicative premium per displaced background
    unit: serving one foreground unit beyond the free depth means outbidding
    the cheapest background holder, whose reservation price sits
    ``(1 + price_impact)`` above the current price, the next one another step
    up, and so on — a geometric supply ladder on the $``grid`` price grid.

    ``util_base`` / ``base_frac`` / ``full_frac`` calibrate the background
    occupancy inversion (see module docstring); ``base_frac = 0.53`` matches
    ``TraceModel.for_instance``'s base band at ``0.530 x on-demand``.

    ``ref_price`` overrides the price that counts as "sold out" (defaults to
    the owning instance type's on-demand price; explicit traces without a
    catalog entry fall back to their own maximum price).
    """

    price_impact: float = 0.05
    util_base: float = 0.55
    base_frac: float = 0.53
    full_frac: float = 1.0
    grid: float = 0.001
    ref_price: float | None = None

    def __post_init__(self):
        if self.price_impact <= 0.0:
            raise ValueError(f"price_impact must be positive, got {self.price_impact}")
        if not 0.0 <= self.util_base <= 1.0:
            raise ValueError(f"util_base must be in [0, 1], got {self.util_base}")
        if not self.base_frac < self.full_frac:
            raise ValueError("base_frac must be below full_frac")
        if self.grid <= 0.0:
            raise ValueError(f"grid must be positive, got {self.grid}")
        if self.ref_price is not None and self.ref_price <= 0.0:
            raise ValueError(f"ref_price must be positive, got {self.ref_price}")


def resolve_ref_price(
    params: MarketParams, on_demand: float = 0.0, trace: PriceTrace | None = None
) -> float:
    """The sold-out reference price: explicit knob, else the type's on-demand
    price, else (for explicit traces with no catalog entry) the trace's own
    maximum price."""
    if params.ref_price is not None:
        return params.ref_price
    if on_demand > 0.0:
        return on_demand
    if trace is not None:
        return float(np.max(trace.prices))
    raise ValueError("cannot resolve ref_price: no knob, no on-demand, no trace")


def utilization(prices: np.ndarray, ref_price: float, params: MarketParams) -> np.ndarray:
    """Background pool occupancy in [util_base, 1] for each price segment.

    Piecewise-linear in ``price / ref_price`` through the generator's
    calibration anchors: ``util_base`` at the base band (``base_frac``),
    sold out at ``full_frac`` and above.
    """
    frac = np.asarray(prices, dtype=np.float64) / float(ref_price)
    x = np.clip((frac - params.base_frac) / (params.full_frac - params.base_frac), 0.0, 1.0)
    return params.util_base + (1.0 - params.util_base) * x


def free_depth(
    prices: np.ndarray, capacity: int, ref_price: float, params: MarketParams
) -> np.ndarray:
    """Slots per segment not held by background demand (int64, in [0, capacity]).

    Foreground demand up to the free depth runs at the exogenous price;
    beyond it, every extra unit must displace a background holder (see
    :func:`repro_torch.market.auction.marginal_price`).
    """
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    used = np.minimum(capacity, np.round(capacity * utilization(prices, ref_price, params)))
    return (capacity - used).astype(np.int64)
