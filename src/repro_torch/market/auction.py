"""Uniform-price auction clearing over a capacity-limited spot pool.

Each price segment holds one auction: the supply side is the exogenous price
plus the background stack reconstructed by :mod:`repro_torch.market.background`
(``free`` slots at the trace price, then displaced background holders at a
geometric premium ladder, nothing at all beyond ``capacity``); the demand
side is the stack of foreground bids registered by live simulations.

The clearing rule is the standard uniform-price prefix: sort bids descending,
serve the longest prefix whose ``n``-th bid still meets the marginal price of
the ``n``-th unit, and charge every served unit the marginal price of the
last one.  Because bids are non-increasing and the ladder is non-decreasing,
the met/unmet indicator is a prefix — which is what makes the whole thing one
vectorized sort + comparison per period (:func:`clear_periods`) and keeps the
lockstep engine grid a single program.

Key invariants (fuzzed in ``tests/market/test_auction_properties.py``):

  * **anchor** — with zero foreground demand the cleared price is the
    exogenous trace price, bit for bit;
  * **monotone** — adding a bid never lowers the clearing price;
  * **conservation** — served foreground + retained background == capacity
    whenever anything is displaced, and served foreground never exceeds
    capacity;
  * **preemption** — a bidder is unserved iff its bid is below the marginal
    price of its own rank (for a homogeneous stack: iff bid < clearing
    price — exactly the out-of-bid rule the simulator already implements).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.market import PriceTrace
from repro_torch.market.background import MarketParams, free_depth, resolve_ref_price
from repro_torch.obs.telemetry import current as _obs_current


def round_to_grid(x: np.ndarray, grid: float) -> np.ndarray:
    """Snap prices onto the market's $grid (same rounding as the generator)."""
    return np.maximum(grid, np.round(np.asarray(x, dtype=np.float64) / grid) * grid)


def marginal_price(
    base: np.ndarray,
    free: np.ndarray,
    n,
    capacity: int,
    params: MarketParams,
) -> np.ndarray:
    """Price of serving the ``n``-th foreground unit of a segment.

    ``base`` / ``free`` / ``n`` broadcast together; ``n <= free`` units cost
    the exogenous price unchanged (bit-identical — no arithmetic touches
    them), each unit beyond the free depth displaces one background holder at
    a ``(1 + price_impact)`` premium per rung (grid-rounded), and nothing is
    for sale beyond ``capacity``.
    """
    base = np.asarray(base, dtype=np.float64)
    n_arr = np.asarray(n)
    over = np.maximum(0, n_arr - np.asarray(free))
    bumped = round_to_grid(base * (1.0 + params.price_impact) ** over, params.grid)
    out = np.where(over > 0, bumped, base)
    return np.where(n_arr > capacity, np.inf, out)


def effective_prices(
    prices: np.ndarray,
    capacity: int,
    demand: int,
    ref_price: float,
    params: MarketParams,
) -> np.ndarray:
    """Cleared price path for a block of ``demand`` lockstep foreground units.

    This is the engine-facing collapse of the auction: a Scenario cell's job
    is the *marginal* replica of a ``demand``-deep co-located block, so it
    runs exactly when the whole block clears and pays the block's uniform
    clearing price — the marginal price of the ``demand``-th unit.  With
    ``demand=0`` this returns the exogenous prices bitwise (the
    backward-compat anchor).
    """
    if demand < 0:
        raise ValueError(f"demand must be >= 0, got {demand}")
    free = free_depth(prices, capacity, ref_price, params)
    return marginal_price(prices, free, demand, capacity, params)


def effective_trace(
    trace: PriceTrace,
    capacity: int,
    demand: int,
    params: MarketParams,
    on_demand: float = 0.0,
) -> PriceTrace:
    """The cleared :class:`PriceTrace` seen by a ``demand``-deep block.

    Segment boundaries are shared with the exogenous trace (the transform is
    pointwise per segment), so availability periods, rising edges, billing
    hours and failure pdfs all read the cleared path consistently.
    """
    ref = resolve_ref_price(params, on_demand, trace)
    q = effective_prices(trace.prices, capacity, demand, ref, params)
    return PriceTrace(times=trace.times, prices=q)


@dataclasses.dataclass(frozen=True)
class ClearingResult:
    """Outcome of one segment's auction over an explicit bid stack.

    ``served`` parallels the input bid order; ``required`` is the marginal
    price of each bidder's own rank (its personal out-of-bid threshold:
    unserved iff ``bid < required``); ``price`` is the uniform clearing price
    every served unit pays (the exogenous base price when nothing is served).
    """

    n_served: int
    price: float
    served: np.ndarray
    required: np.ndarray


def clear_stack(
    bids,
    base_price: float,
    free: int,
    capacity: int,
    params: MarketParams,
) -> ClearingResult:
    """Clear one segment: uniform-price auction of ``bids`` against the
    background stack.  Ties between equal bids break towards earlier stack
    position (first registered wins), deterministically.
    """
    b = np.asarray(bids, dtype=np.float64)
    if b.size == 0:
        return ClearingResult(0, float(base_price), np.zeros(0, dtype=bool), np.zeros(0))
    order = np.argsort(-b, kind="stable")  # desc; ties in input order
    ranks = np.arange(1, b.size + 1)
    ladder = marginal_price(base_price, free, ranks, capacity, params)
    met = b[order] >= ladder  # non-increasing bids vs non-decreasing ladder: a prefix
    n_served = int(met.sum())
    served = np.zeros(b.size, dtype=bool)
    served[order[:n_served]] = True
    required = np.empty(b.size)
    required[order] = ladder
    price = float(ladder[n_served - 1]) if n_served else float(base_price)
    return ClearingResult(n_served, price, served, required)


def clear_periods(
    bids: np.ndarray,
    active: np.ndarray,
    base: np.ndarray,
    free: np.ndarray,
    capacity: int,
    params: MarketParams,
    ladder: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized :func:`clear_stack` over every period at once.

    ``bids`` is the ``(n_bidders,)`` stack, ``active`` a ``(n_bidders,
    n_periods)`` participation mask, ``base`` / ``free`` the per-period
    background state.  Returns ``(n_served, clearing_price)`` per period —
    one masked sort along the bidder axis plus one ladder comparison, the
    "sort/cumsum over the bid stack per period" that keeps batch clearing a
    single program.

    ``ladder`` optionally supplies the ``(n_bidders, n_periods)`` marginal
    price ladder precomputed by the caller.  It must hold exactly
    ``marginal_price(base, free, rank)`` for every rank a bidder can clear
    at — callers that know their active depth is bounded (the serving grid:
    at most ``max_spot`` homogeneous lanes per period) may fill deeper rungs
    with ``+inf``, since an inactive ``-inf`` lane can never meet any rung.
    The ladder depends only on the background state, not the bids, so one
    vectorized :func:`marginal_price` over a whole horizon can feed every
    per-period call — this is what keeps lockstep serving clearing off the
    ladder-recomputation hot path.
    """
    n, P = active.shape
    tel = _obs_current()
    if tel.enabled:
        tel.count("market.clear_periods")
        tel.count("market.cleared_period_cells", P)
    stack = np.where(active, np.asarray(bids, dtype=np.float64)[:, None], -np.inf)
    b_sorted = -np.sort(-stack, axis=0)  # (n, P) descending per period
    if ladder is None:
        ranks = np.arange(1, n + 1)[:, None]
        ladder = marginal_price(base[None, :], free[None, :], ranks, capacity, params)
    n_served = (b_sorted >= ladder).sum(axis=0)
    price = np.where(
        n_served > 0,
        np.take_along_axis(ladder, np.maximum(n_served - 1, 0)[None, :], axis=0)[0],
        base,
    )
    return n_served.astype(np.int64), price


def clear_periods_torch(
    bids: torch.Tensor,
    active: torch.Tensor,
    base: torch.Tensor,
    ladder: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`clear_periods` on tensors, on whatever device they lie.

    ``bids`` is ``(..., n_bidders)``, ``active`` and ``ladder`` are
    ``(..., n_bidders, n_periods)``, ``base`` is ``(..., n_periods)``; the
    leading axes batch independent clearings (the serving engine clears
    every spot type of a period in one call).  The ladder is required: it
    holds :func:`marginal_price` computed on the host, since a device
    ``pow`` and ``round`` do not give NumPy's bits.  The same masked sort
    (``torch.sort`` descending in place of ``-np.sort(-x)``: the same
    values), the same comparison and the same gather as the NumPy version,
    so ``n_served`` (int64) and the price are ``==`` to it.
    """
    tel = _obs_current()
    if tel.enabled:
        n_calls = int(np.prod(active.shape[:-2], dtype=np.int64))
        tel.count("market.clear_periods", n_calls)
        tel.count("market.cleared_period_cells", n_calls * active.shape[-1])
    stack = torch.where(active, bids.to(torch.float64)[..., :, None], float("-inf"))
    b_sorted = torch.sort(stack, dim=-2, descending=True).values
    n_served = (b_sorted >= ladder).sum(dim=-2)
    rank = torch.clamp(n_served - 1, min=0)
    at_rank = torch.gather(ladder, -2, rank.unsqueeze(-2)).squeeze(-2)
    price = torch.where(n_served > 0, at_rank, base)
    return n_served.to(torch.int64), price
