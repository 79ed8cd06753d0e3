"""The port's contended spot market, on the CPU, against ``repro.market``.

``repro_torch.market`` is host NumPy, a copy of the JAX package's: every
function must give the same floats.  Each case feeds the same inputs — the
cases of ``tests/market/`` plus seeded random prices, bid stacks and demand
ledgers drawn with numpy — through both packages and compares with ``==``
(``np.array_equal`` on arrays, dtypes included).
"""

import numpy as np
import pytest

from repro import obs as ref_obs
from repro.core import PriceTrace as RefPriceTrace
from repro.core import get_instance as ref_get_instance
from repro.core import synthetic_trace as ref_synthetic_trace
from repro import market as R

from repro_torch import obs
from repro_torch.core import PriceTrace, get_instance
from repro_torch import market as M

H = 48 * 3600.0
PARAMS = (
    {},
    {"price_impact": 0.12, "util_base": 0.3, "base_frac": 0.4, "full_frac": 0.9, "grid": 0.0005},
    {"ref_price": 0.5},
)


def both_params(kw):
    return R.MarketParams(**kw), M.MarketParams(**kw)


def both_traces(times, prices):
    times, prices = np.asarray(times, dtype=np.float64), np.asarray(prices, dtype=np.float64)
    return (RefPriceTrace(times=times.copy(), prices=prices.copy()),
            PriceTrace(times=times.copy(), prices=prices.copy()))


def random_trace(seed, n=60, horizon=H):
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, int(horizon // 60)), n - 1, replace=False)) * 60.0
    prices = np.round(rng.uniform(0.2, 0.9, n), 3)
    return np.concatenate(([0.0], cuts, [horizon])), prices


def assert_same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want, equal_nan=True)


def assert_same_trace(got, want):
    assert_same(got.times, want.times)
    assert_same(got.prices, want.prices)


@pytest.mark.parametrize("kw", PARAMS)
def test_market_params_fields_and_validation(kw):
    ref, port = both_params(kw)
    assert M.MarketParams.__dataclass_fields__.keys() == R.MarketParams.__dataclass_fields__.keys()
    assert vars(port) == vars(ref)
    for bad in ({"price_impact": 0.0}, {"util_base": 1.5}, {"base_frac": 1.0, "full_frac": 0.5},
                {"grid": -0.001}, {"ref_price": 0.0}):
        with pytest.raises(ValueError):
            R.MarketParams(**bad)
        with pytest.raises(ValueError):
            M.MarketParams(**bad)


@pytest.mark.parametrize("seed", range(4))
def test_marginal_price_and_grid_rounding(seed):
    rng = np.random.default_rng(seed)
    base = np.round(rng.uniform(0.01, 2.0, 50), 3)
    free = rng.integers(0, 6, 50)
    n = rng.integers(0, 9, 50)
    capacity = int(rng.integers(1, 8))
    for kw in PARAMS:
        ref, port = both_params(kw)
        assert_same(M.marginal_price(base, free, n, capacity, port), R.marginal_price(base, free, n, capacity, ref))
        assert_same(M.round_to_grid(base * 1.0371, port.grid), R.round_to_grid(base * 1.0371, ref.grid))
    ranks = np.arange(0, 7)
    assert_same(M.marginal_price(0.36, 2, ranks, 4, M.MarketParams()),
                R.marginal_price(0.36, 2, ranks, 4, R.MarketParams()))


@pytest.mark.parametrize("kw", PARAMS)
@pytest.mark.parametrize("capacity", [1, 3, 4, 16, 64])
def test_utilization_free_depth_effective_prices(kw, capacity):
    ref, port = both_params(kw)
    rt = ref_synthetic_trace(ref_get_instance("m1.xlarge"), 30, seed=capacity)
    od = ref_get_instance("m1.xlarge").on_demand
    prices = np.concatenate((rt.prices, np.linspace(0.3, 1.2, 40) * od))
    assert_same(M.utilization(prices, od, port), R.utilization(prices, od, ref))
    assert_same(M.free_depth(prices, capacity, od, port), R.free_depth(prices, capacity, od, ref))
    for demand in range(0, capacity + 2):
        assert_same(M.effective_prices(prices, capacity, demand, od, port),
                    R.effective_prices(prices, capacity, demand, od, ref))
    # the backward-compat anchor holds in the port too
    assert_same(M.effective_prices(prices, capacity, 0, od, port), prices)


@pytest.mark.parametrize("kw", PARAMS)
def test_effective_trace_and_ref_price(kw):
    ref, port = both_params(kw)
    it = get_instance("m1.xlarge")
    for seed in (2, 5):
        rt, pt = both_traces(*random_trace(seed))
        assert M.resolve_ref_price(port, it.on_demand, pt) == R.resolve_ref_price(ref, it.on_demand, rt)
        assert M.resolve_ref_price(port, 0.0, pt) == R.resolve_ref_price(ref, 0.0, rt)
        for capacity, demand in ((4, 1), (4, 2), (3, 3), (4, 5), (8, 2)):
            for od in (it.on_demand, 0.0):
                got = M.effective_trace(pt, capacity, demand, port, on_demand=od)
                want = R.effective_trace(rt, capacity, demand, ref, on_demand=od)
                assert_same_trace(got, want)
                assert got.times is pt.times
    with pytest.raises(ValueError):
        M.resolve_ref_price(M.MarketParams(), 0.0, None)
    with pytest.raises(ValueError):
        M.effective_prices(np.array([0.4]), 4, -1, 1.0, port)
    with pytest.raises(ValueError):
        M.free_depth(np.array([0.4]), 0, 1.0, port)


CLEAR_CASES = [
    ([0.3808] * 3, 0.36, 2, 4),
    ([0.3808] * 4, 0.36, 2, 4),
    ([0.3808, 0.3808, 0.3808, 0.416], 0.36, 2, 4),
    ([], 0.40, 1, 2),
    ([0.01], 0.40, 0, 2),
    ([0.5, 0.2, 0.5, 0.9, 0.41, 0.41], 0.40, 1, 5),
]


def assert_same_clearing(got, want):
    assert got.n_served == want.n_served and got.price == want.price
    assert_same(got.served, want.served)
    assert_same(got.required, want.required)


@pytest.mark.parametrize("case", range(len(CLEAR_CASES) + 4))
def test_clear_stack(case):
    if case < len(CLEAR_CASES):
        bids, base, free, capacity = CLEAR_CASES[case]
    else:
        rng = np.random.default_rng(case)
        capacity = int(rng.integers(1, 8))
        bids = np.round(rng.uniform(0.2, 0.9, int(rng.integers(0, 10))), 3)
        bids[rng.random(bids.size) < 0.3] = 0.5  # ties
        base, free = float(np.round(rng.uniform(0.2, 0.8), 3)), int(rng.integers(0, capacity + 1))
    for kw in PARAMS:
        ref, port = both_params(kw)
        assert_same_clearing(M.clear_stack(bids, base, free, capacity, port),
                             R.clear_stack(bids, base, free, capacity, ref))


@pytest.mark.parametrize("seed", range(4))
def test_clear_periods_and_counters(seed):
    rng = np.random.default_rng(seed)
    n, periods, K = int(rng.integers(1, 9)), 40, int(rng.integers(1, 7))
    bids = np.round(rng.uniform(0.2, 0.9, n), 3)
    active = rng.random((n, periods)) < 0.6
    base = np.round(rng.uniform(0.2, 0.8, periods), 3)
    free = rng.integers(0, K + 1, periods)
    ref, port = both_params(PARAMS[seed % len(PARAMS)])
    with obs.Telemetry() as tel, ref_obs.Telemetry() as rtel:
        got = M.clear_periods(bids, active, base, free, K, port)
        want = R.clear_periods(bids, active, base, free, K, ref)
    for g, w in zip(got, want):
        assert_same(g, w)
    # the caller-supplied ladder gives the same clearing
    ladder = R.marginal_price(base[None, :], free[None, :], np.arange(1, n + 1)[:, None], K, ref)
    for g, w in zip(M.clear_periods(bids, active, base, free, K, port, ladder=ladder), want):
        assert_same(g, w)
    assert tel.counters == rtel.counters == {"market.clear_periods": 1, "market.cleared_period_cells": periods}


def random_ledger(seed):
    """The same random sequence of registrations, moves and truncations on a
    market of each package; returns both markets and both handle lists."""
    rng = np.random.default_rng(100 + seed)
    times, prices = random_trace(seed, n=12)
    rt, pt = both_traces(times, prices)
    capacity = int(rng.integers(1, 6))
    kw = PARAMS[seed % len(PARAMS)]
    ref, port = both_params(kw)
    od = float(rng.choice([0.0, 0.68]))
    rm, pm = R.SpotMarket(rt, capacity, ref, on_demand=od), M.SpotMarket(pt, capacity, port, on_demand=od)
    rregs, pregs = [], []
    for _ in range(int(rng.integers(0, 9))):
        a, b = np.sort(rng.uniform(0, H, 2))
        bid = float(rng.choice([0.3, 0.45, 0.5, 0.62, float(np.round(rng.uniform(0.2, 0.9), 3))]))
        rregs.append(rm.register(a, b, bid))
        pregs.append(pm.register(a, b, bid))
        op = rng.integers(0, 3)
        if op == 1 and rregs:
            i = int(rng.integers(0, len(rregs)))
            end = float(rng.uniform(0, H))
            rm.truncate(rregs[i], end)
            pm.truncate(pregs[i], end)
        elif op == 2 and rregs:
            i = int(rng.integers(0, len(rregs)))
            a, b = np.sort(rng.uniform(0, H, 2))
            rm.update(rregs[i], a, b)
            pm.update(pregs[i], a, b)
    return rng, rm, pm, rregs, pregs


@pytest.mark.parametrize("seed", range(8))
def test_spot_market_views_on_random_ledgers(seed):
    rng, rm, pm, rregs, pregs = random_ledger(seed)
    assert pm.capacity == rm.capacity and pm.ref_price == rm.ref_price
    assert_same(pm.free, rm.free)
    assert [vars(r) for r in pm.ledger] == [vars(r) for r in rm.ledger]
    with obs.Telemetry() as tel, ref_obs.Telemetry() as rtel:
        for own_bid in (0.3, 0.5, 0.62, float(np.round(rng.uniform(0.2, 0.9), 3))):
            assert_same_trace(pm.cleared_view(own_bid), rm.cleared_view(own_bid))
            for rr, pr in zip(rregs, pregs):
                assert_same_trace(pm.cleared_view(own_bid, pr), rm.cleared_view(own_bid, rr))
        for t in rng.uniform(0, H, 6):
            assert_same_clearing(pm.clear_at(float(t)), rm.clear_at(float(t)))
            assert pm.price_at(float(t)) == rm.price_at(float(t))
    assert tel.counters == rtel.counters


def test_spot_market_cases_and_fleet_market():
    """The hand-built cases of ``tests/market/test_spot_market.py``, and a
    FleetMarket over two types."""
    kw = {}
    ref, port = both_params(kw)
    rt, pt = both_traces([0.0, 6 * 3600.0, H], [0.36, 0.55])
    rm, pm = R.SpotMarket(rt, 4, ref, on_demand=0.68), M.SpotMarket(pt, 4, port, on_demand=0.68)
    assert list(pm.free) == list(rm.free) == [2, 1]
    for m in (rm, pm):
        m.register(0.0, H, 0.6)
        m.register(0.0, H, 0.3808)
        m.register(4 * 3600.0, 10 * 3600.0, 0.3808)
    for bid in (0.38, 0.3808, 0.6):
        assert_same_trace(pm.cleared_view(bid), rm.cleared_view(bid))
    with pytest.raises(ValueError):
        M.SpotMarket(pt, 0, port, on_demand=0.68)

    from repro.core import catalog as ref_catalog
    from repro_torch.core import catalog

    rtypes, ptypes = ref_catalog()[:2], catalog()[:2]
    times, prices = random_trace(9)
    rtr, ptr = {}, {}
    for it in rtypes:
        rtr[it.name], ptr[it.name] = both_traces(times, prices)
    rfm = R.FleetMarket.build(rtypes, rtr, 3, ref)
    pfm = M.FleetMarket.build(ptypes, ptr, 3, port)
    for it in ptypes:
        assert it.name in pfm
        assert pfm[it.name].ref_price == rfm[it.name].ref_price
        assert_same(pfm[it.name].free, rfm[it.name].free)
        for t in (0.0, 1e4, 1e5):
            assert pfm.price_at(it.name, t) == rfm.price_at(it.name, t)
