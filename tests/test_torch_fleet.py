"""The port's fleet subsystem, on the CPU, against ``repro.fleet``.

Small grids only (``tests/fleet/test_batch_parity.py``'s ``small_scenario``:
12 jobs, 8 types, 2 seeds, 4 days).  The gates:

  * workloads, policies and the host ``FleetController`` are copies of the
    JAX package's: every ``AttemptRecord`` field, ``cost`` included (both
    fold with the same compensated ``sum()``), every ``JobOutcome`` and the
    ``fleet.*`` counters ``==`` — for every scheme including ACC, contended
    (``capacity=2-4``) and re-bidding fleets;
  * the batch engine with ``device="cpu"`` (its waves as torch ops) ``==``
    ``repro.fleet.batch.run_fleet_batch`` on every field, and ``==`` the
    port's controller on every field but ``cost``, which stays within 1e-12
    relative (the batch biller folds left to right);
  * ``eet_scores`` ``==`` ``eet_scores_numpy``, the ``inf`` lanes included;
    the attempt walks (``_kernel_windows``, ``_kernel_adapt``, the ACC
    lease core) ``==`` their NumPy counterparts lane for lane.

No test here sorts jobs by deadline: a ``None`` deadline does not order
against a float.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core import SLA as RefSLA
from repro.core import HOUR
from repro.core import PriceTrace as RefPriceTrace
from repro.core import Scheme as RefScheme
from repro.core import SimParams as RefSimParams
from repro.core import catalog as ref_catalog
from repro.core import simulate_acc_attempt as ref_simulate_acc_attempt
from repro.core import step_trace as ref_step_trace
from repro.core import synthetic_traces_batch as ref_synthetic_traces_batch
from repro.engine import FleetScenario as RefFleetScenario
from repro.engine import run_fleet as ref_run_fleet
from repro.engine.kernels import AdaptTables as RefAdaptTables
from repro.engine.kernels import _kernel_adapt as ref_kernel_adapt
from repro.engine.kernels import _kernel_windows as ref_kernel_windows
from repro.fleet import batch as ref_batch
from repro import fleet as RF
from repro.kernels.fleet_step.ref import eet_scores_numpy as ref_eet_scores_numpy
from repro.market import MarketParams as RefMarketParams

from repro_torch import obs
from repro_torch.core import SLA, PriceTrace, Scheme, SimParams, catalog, simulate_acc_attempt
from repro_torch.engine import FleetScenario, run_fleet
from repro_torch.engine.fleetgrid import FLEET_ENGINES, fleet_inputs
from repro_torch.engine.kernels import AdaptTables, _kernel_adapt, _kernel_windows
from repro_torch.fleet import batch
from repro_torch import fleet as F
from repro_torch.kernels.fleet_step.ops import eet_scores
from repro_torch.kernels.fleet_step.ref import eet_scores_numpy
from repro_torch.market import MarketParams

SCHEMES = ("none", "opt", "hour", "edge", "adapt", "acc")
CPU = torch.device("cpu")


def small(pkg, **kw):
    """``small_scenario`` of ``tests/fleet/test_batch_parity.py`` in either
    package (``pkg`` is ``"ref"`` or ``"port"``)."""
    scheme = kw.pop("scheme", "hour")
    base = dict(n_jobs=12, mean_interarrival_s=1800.0, mean_work_h=3.0, horizon_days=4.0, n_types=8,
                seeds=(0, 1), bid_margins=(0.56,))
    base.update(kw)
    if pkg == "ref":
        if "market" in base:
            base["market"] = RefMarketParams(**base["market"])
        return RefFleetScenario(scheme=RefScheme(scheme), **base)
    if "market" in base:
        base["market"] = MarketParams(**base["market"])
    return FleetScenario(scheme=Scheme(scheme), **base)


def rec(r) -> tuple:
    d = dataclasses.asdict(r)
    d["termination"] = d["termination"].value
    return tuple(d.items())


def job(j) -> dict:
    return dataclasses.asdict(j)


def fleet_counters(tel) -> dict:
    return {k: v for k, v in tel.counters.items() if k.startswith("fleet.")}


def assert_fleet_equal(got, want, cost_rtol=None):
    """Two FleetResults (either package): every field ``==``; ``cost`` within
    ``cost_rtol`` relative when given."""
    assert got.policy == want.policy and got.scheme.value == want.scheme.value
    assert got.horizon == want.horizon
    g, w = [rec(r) for r in got.records], [rec(r) for r in want.records]
    if cost_rtol is None:
        assert g == w
    else:
        assert [[kv for kv in r if kv[0] != "cost"] for r in g] == [[kv for kv in r if kv[0] != "cost"] for r in w]
        for rg, rw in zip(got.records, want.records):
            assert rg.cost == pytest.approx(rw.cost, rel=cost_rtol, abs=0.0)
    assert list(got.outcomes) == list(want.outcomes)
    for job_id, ow in want.outcomes.items():
        og = got.outcomes[job_id]
        assert job(og.job) == job(ow.job)
        assert (og.completed, og.completion_time, og.n_kills, og.n_migrations) == (
            ow.completed, ow.completion_time, ow.n_kills, ow.n_migrations)
        if cost_rtol is None:
            assert og.cost == ow.cost
        else:
            assert og.cost == pytest.approx(ow.cost, rel=cost_rtol, abs=0.0)
        assert [rec(r)[:7] for r in og.attempts] == [rec(r)[:7] for r in ow.attempts]


def assert_grid_equal(got, want, cost_rtol=None):
    assert list(got.results) == list(want.results)
    for key, res in want.results.items():
        assert_fleet_equal(got.results[key], res, cost_rtol)
    for cg, cw in zip(got.cells, want.cells):
        a, b = dataclasses.asdict(cg), dataclasses.asdict(cw)
        a.pop("wall_s"), b.pop("wall_s")
        if cost_rtol is not None:
            assert a.pop("total_cost") == pytest.approx(b.pop("total_cost"), rel=cost_rtol, abs=0.0)
        assert a == b


# -- workloads -----------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_arrivals_and_workloads(seed):
    np.testing.assert_array_equal(F.poisson_arrivals(40, 900.0, seed), RF.poisson_arrivals(40, 900.0, seed))
    rates = np.abs(np.sin(np.arange(48) / 7.0)) * 0.01
    np.testing.assert_array_equal(F.rate_arrivals(rates, 300.0, seed), RF.rate_arrivals(rates, 300.0, seed))
    assert F.rate_arrivals(np.zeros(4), 300.0, seed).size == RF.rate_arrivals(np.zeros(4), 300.0, seed).size == 0
    sla, rsla = SLA(min_compute_units=4.0, os="linux"), RefSLA(min_compute_units=4.0, os="linux")
    pairs = [
        (F.Workload.poisson(30, 1800.0, 3 * 3600.0, seed=seed, sla=sla, deadline_slack=4.0),
         RF.Workload.poisson(30, 1800.0, 3 * 3600.0, seed=seed, sla=rsla, deadline_slack=4.0)),
        (F.Workload.from_arrivals(F.rate_arrivals(rates, 300.0, seed), 2 * 3600.0, seed=seed),
         RF.Workload.from_arrivals(RF.rate_arrivals(rates, 300.0, seed), 2 * 3600.0, seed=seed)),
        (F.Workload.batch(5, 3600.0, sla=sla, arrival_s=10.0, deadline_s=1e5),
         RF.Workload.batch(5, 3600.0, sla=rsla, arrival_s=10.0, deadline_s=1e5)),
        (F.Workload.from_sizes([1.0, 2.5, 0.5], interarrival_s=600.0),
         RF.Workload.from_sizes([1.0, 2.5, 0.5], interarrival_s=600.0)),
    ]
    pairs.append((pairs[0][0].merge(pairs[2][0], pairs[3][0]), pairs[0][1].merge(pairs[2][1], pairs[3][1])))
    for got, want in pairs:
        assert [job(j) for j in got] == [job(j) for j in want]
        assert got.total_work_s == want.total_work_s
    with pytest.raises(ValueError):
        F.Job(id=0, arrival_s=5.0, work_s=10.0, deadline_s=1.0)
    with pytest.raises(ValueError):
        F.poisson_arrivals(3, 0.0)


def test_sweep_helpers():
    for n in (4, 16, 64):
        sla, rsla = SLA(min_compute_units=4.0, os="linux"), RefSLA(min_compute_units=4.0, os="linux")
        assert [it.name for it in F.select_types(sla, n)] == [it.name for it in RF.select_types(rsla, n)]
    types, rtypes = F.select_types(SLA(), 6), RF.select_types(RefSLA(), 6)
    for history in (False, True):
        got = F.batched_fleet_traces(types, (0, 2), 3.0, history=history)
        want = RF.batched_fleet_traces(rtypes, (0, 2), 3.0, history=history)
        for s in (0, 2):
            assert list(got[s]) == list(want[s])
            for name in got[s]:
                np.testing.assert_array_equal(got[s][name].prices, want[s][name].prices)
                np.testing.assert_array_equal(got[s][name].times, want[s][name].times)
    cells = [F.SweepCell("a1", 0.56, s, 1.0 + s, 2.0, 3.0, 0.1, 1, 2, 3, 4, 0, 0.5) for s in range(3)]
    rcells = [RF.SweepCell("a1", 0.56, s, 1.0 + s, 2.0, 3.0, 0.1, 1, 2, 3, 4, 0, 0.5) for s in range(3)]
    assert F.summarize(cells) == RF.summarize(rcells)


# -- policies ------------------------------------------------------------------


def policy_setup(n_types=12):
    sla, rsla = SLA(min_compute_units=4.0, os="linux"), RefSLA(min_compute_units=4.0, os="linux")
    rfeas = [it for it in ref_catalog() if rsla.admits(it)][:n_types]
    feas = [it for it in catalog() if sla.admits(it)][:n_types]
    rhist = {name: trs[0] for name, trs in ref_synthetic_traces_batch(rfeas, 10.0, 5).items()}
    hist = {name: PriceTrace(times=t.times.copy(), prices=t.prices.copy()) for name, t in rhist.items()}
    return (feas, hist, sla), (rfeas, rhist, rsla)


@pytest.mark.parametrize("name", ["algorithm1", "cost_greedy", "eet_greedy", "diversified2", "diversified3"])
@pytest.mark.parametrize("bid_policy", [None, "fixed", "rebid"])
def test_policy_placements(name, bid_policy):
    (feas, hist, sla), (rfeas, rhist, rsla) = policy_setup()

    def make(pkg):
        mod = F if pkg == "port" else RF
        h = hist if pkg == "port" else rhist
        sp = SimParams() if pkg == "port" else RefSimParams()
        bp = {None: None, "fixed": mod.FixedMarginBid(0.58), "rebid": mod.ClearingRebid(0.54, 0.07)}[bid_policy]
        ctx = mod.PlacementContext(histories=h, params=sp, bid_margin=0.56, bid_policy=bp)
        pol = {"algorithm1": mod.Algorithm1Policy(), "cost_greedy": mod.CostGreedyPolicy(),
               "eet_greedy": mod.EETGreedyPolicy(), "diversified2": mod.DiversifiedPolicy(2),
               "diversified3": mod.DiversifiedPolicy(3)}[name]
        return ctx, pol

    (ctx, pol), (rctx, rpol) = make("port"), make("ref")
    assert pol.name == rpol.name
    jobs, rjobs = F.Workload.batch(1, 4 * 3600.0, sla=sla).jobs, RF.Workload.batch(1, 4 * 3600.0, sla=rsla).jobs
    rng = np.random.default_rng(7)
    for step in range(4):
        quotes = {it.name: float(np.round(rng.uniform(0.1, 1.2), 3)) for it in feas} if step else {}
        ctx.spot_prices_now, rctx.spot_prices_now = dict(quotes), dict(quotes)
        work = float(rng.uniform(600.0, 30 * 3600.0))
        got = pol.place(jobs[0], 0.0, work, feas, ctx)
        want = rpol.place(rjobs[0], 0.0, work, rfeas, rctx)
        assert [(p.instance.name, p.bid) for p in got] == [(p.instance.name, p.bid) for p in want]
        for it, rit in zip(feas, rfeas):
            assert ctx.bid_for(it) == rctx.bid_for(rit)
            assert ctx.eet(it, ctx.bid_for(it), work) == rctx.eet(rit, rctx.bid_for(rit), work)
    with pytest.raises(ValueError):
        F.ClearingRebid(markup=-0.1)
    with pytest.raises(ValueError):
        F.DiversifiedPolicy(0)


# -- the controller --------------------------------------------------------------


CONTROLLER_CASES = [(s, {}) for s in SCHEMES] + [
    ("hour", {"capacity": 2}),
    ("hour", {"capacity": 3, "market": {"price_impact": 0.1}}),
    ("edge", {"capacity": 4}),
    ("acc", {"capacity": 3}),
    ("adapt", {"capacity": 2, "bid_policy": "rebid"}),
    ("hour", {"bid_policy": "rebid", "rebid_markup": 0.2}),
    ("hour", {"capacity": 4, "bid_policy": "rebid", "bid_margins": (0.54, 0.6)}),
]


@pytest.mark.parametrize("scheme, kw", CONTROLLER_CASES,
                         ids=[f"{s}-{'-'.join(map(str, kw.values())) or 'plain'}" for s, kw in CONTROLLER_CASES])
def test_controller_matches_reference_controller(scheme, kw):
    sc, rsc = small("port", scheme=scheme, **kw), small("ref", scheme=scheme, **kw)
    assert sc.canonical() == rsc.canonical()
    with obs.Telemetry() as tel:
        got = run_fleet(sc, engine="controller")
    with ref_obs.Telemetry() as rtel:
        want = ref_run_fleet(rsc, engine="controller")
    assert_grid_equal(got, want)
    assert fleet_counters(tel) == fleet_counters(rtel)
    market = {k: v for k, v in tel.counters.items() if k.startswith("market.")}
    assert market == {k: v for k, v in rtel.counters.items() if k.startswith("market.")}
    assert any(r.records for r in got.results.values())
    if sc.capacity is not None:
        assert market.get("market.cleared_views", 0) > 0


def test_market_contention_replay_matches_example():
    """``launch/market_contention.py``'s fleet replay: the example's three
    controllers, record for record (one outbid kill under re-bidding)."""
    from repro.core import constant_trace as ref_constant_trace
    from repro.core import get_instance as ref_get_instance

    from repro_torch.launch import market_contention as mc

    got = mc.fleet_replay()
    it = ref_get_instance("m1.xlarge", region="us-east-1")
    traces = {it.name: ref_constant_trace(0.36, 60 * HOUR)}
    wl = RF.Workload.from_sizes([6.0] * 4, interarrival_s=0.5 * HOUR)
    for label, kwargs in (("infinite depth", {}), ("capacity-limited", {"capacity": 4}),
                          ("capacity + re-bid", {"capacity": 4, "bid_policy": RF.ClearingRebid(0.56, 0.10)})):
        want = RF.FleetController([it], traces, RF.CostGreedyPolicy(), scheme=RefScheme.HOUR, bid_margin=0.56,
                                  **kwargs).run(wl)
        assert_fleet_equal(got[label], want)
    assert got["capacity + re-bid"].n_kills == 1


# -- the batch engine ----------------------------------------------------------


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("margins, policies", [
    ((0.56,), ("algorithm1", "cost_greedy", "eet_greedy", "diversified")),
    ((0.54, 0.6), ("eet_greedy", "diversified3")),
])
def test_batch_engine_matches_reference_batch_and_controller(scheme, margins, policies):
    kw = dict(scheme=scheme, bid_margins=margins, policies=policies, n_replicas=2 if "diversified" in policies else 3)
    sc, rsc = small("port", **kw), small("ref", **kw)
    with obs.Telemetry() as tel:
        got = run_fleet(sc, engine="batch", device="cpu")
    with ref_obs.Telemetry() as rtel:
        want = ref_run_fleet(rsc, engine="batch")
    assert got.engine == "batch"
    assert_grid_equal(got, want)  # cost included
    assert fleet_counters(tel) == fleet_counters(rtel)
    assert tel.counter("fleet_batch.eet_waves") + tel.counter("fleet_batch.attempt_waves") > 0
    with obs.Telemetry() as ctel:
        ctl = run_fleet(sc, engine="controller")
    assert_grid_equal(got, ctl, cost_rtol=1e-12)
    assert fleet_counters(tel).keys() == fleet_counters(ctel).keys()
    for k, v in fleet_counters(ctel).items():
        assert fleet_counters(tel)[k] == pytest.approx(v, rel=1e-12)


def test_run_fleet_delegation_and_engines(monkeypatch):
    """Contended and re-bidding scenarios run on the controller whatever the
    engine; the JAX package's ``"jax"`` engine has no counterpart; the batch
    engine raises without a GPU unless it is given the CPU."""
    assert FLEET_ENGINES == ("controller", "batch")
    for kw in ({"capacity": 3}, {"bid_policy": "rebid"}):
        sc = small("port", **kw)
        got = run_fleet(sc, engine="batch")  # no device needed: the controller runs
        assert_grid_equal(got, run_fleet(sc, engine="controller"))
        assert_grid_equal(got, ref_run_fleet(small("ref", **kw), engine="batch"))
    sc = small("port")
    with pytest.raises(ValueError, match="known"):
        run_fleet(sc, engine="jax", device="cpu")
    with pytest.raises(ValueError, match="host"):
        run_fleet(sc, engine="controller", device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_fleet(sc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eet_scores(np.zeros((1, 1)), np.zeros((1, 1)), np.zeros((1, 1)), np.ones((1, 1), dtype=bool))
    with pytest.raises(ValueError):
        FleetScenario(capacity=0)
    with pytest.raises(ValueError):
        FleetScenario(bid_policy="auction")
    legacy = F.SweepConfig(n_jobs=7, seeds=(4,), bid_margins=(0.5,))
    assert (FleetScenario.from_sweep_config(legacy, ["cost_greedy"]).canonical()
            == RefFleetScenario.from_sweep_config(RF.SweepConfig(n_jobs=7, seeds=(4,), bid_margins=(0.5,)),
                                                  ["cost_greedy"]).canonical())


# -- the device ops: EET scores and the attempt walks ----------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_eet_scores_match_reference(seed):
    rng = np.random.default_rng(seed)
    L, T = int(rng.integers(1, 40)), int(rng.integers(1, 70))
    p_fail = rng.uniform(0, 1, (L, T))
    p_fail[rng.random((L, T)) < 0.1] = 1.0  # p_succeed == 0: inf
    p_fail[rng.random((L, T)) < 0.05] = 1.0 + 1e-12  # p_succeed < 0: inf
    p_fail[rng.random((L, T)) < 0.1] = 0.0
    wasted = rng.uniform(0, 5e4, (L, T)) * (1.0 - p_fail)
    w_scaled = rng.uniform(60.0, 2e5, (L, T))
    avail = rng.random((L, T)) < 0.8
    want = ref_eet_scores_numpy(p_fail, wasted, w_scaled, avail)
    np.testing.assert_array_equal(eet_scores_numpy(p_fail, wasted, w_scaled, avail), want)
    got = eet_scores(p_fail, wasted, w_scaled, avail, device="cpu")
    assert got.dtype == torch.float64 and got.device == CPU
    assert np.array_equal(got.numpy(), want)
    assert np.isinf(want).any() and np.isfinite(want).any()
    again = eet_scores(*(torch.from_numpy(x) for x in (p_fail, wasted, w_scaled, avail)))
    assert np.array_equal(again.numpy(), want)


def walk_lanes(seed, n=300):
    """Random attempt lanes of the fleet engine's shape: launch a, kill b,
    start of work, saved work, per-lane work."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 5e5, n)
    b = a + rng.uniform(0, 3e5, n)
    sw = a + rng.choice([0.0, 300.0, 900.0], n)
    ws = rng.uniform(600.0, 2e5, n)
    sv = np.where(rng.random(n) < 0.5, 0.0, ws * rng.uniform(0, 0.9, n))
    return a, b, sw, sv, ws


def as_t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def assert_walk_equal(got, want):
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.dtype == np.asarray(w).dtype
        assert np.array_equal(g, w, equal_nan=True)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("t_c", [300.0, 1200.0])
def test_kernel_windows_matches_reference(seed, t_c):
    a, b, sw, sv, ws = walk_lanes(seed)
    assert_walk_equal(_kernel_windows(*as_t(a, b, sw, sv, ws), t_c, hour_delta=3600.0),
                      ref_kernel_windows(np, a, b, sw, sv, ws, t_c, hour_delta=3600.0))
    # EDGE: per-lane views into inf-padded edge rows, as the fleet engine builds them
    rng = np.random.default_rng(50 + seed)
    rows = [np.sort(rng.uniform(0, 8e5, int(rng.integers(0, 400)))) for _ in range(5)]
    width = max(1, max(len(r) for r in rows))
    E = np.full((len(rows), width), np.inf)
    for i, r in enumerate(rows):
        E[i, : len(r)] = r
    g = rng.integers(0, len(rows), len(a))
    flat = np.concatenate(rows + [np.zeros(1)])
    base = np.concatenate(([0], np.cumsum([len(r) for r in rows])))[g]
    n_edges = np.asarray([len(r) for r in rows])[g]
    ptr = np.asarray([np.searchsorted(rows[gi], s, side="right") for gi, s in zip(g, sw)])
    want = ref_kernel_windows(np, a, b, sw, sv, ws, t_c, edge_state=(flat, base, n_edges, ptr))
    Et, gt, swt = torch.from_numpy(E), torch.from_numpy(g), torch.from_numpy(sw)
    ptr_t = torch.searchsorted(Et[gt], swt.unsqueeze(1), right=True).squeeze(1)
    assert np.array_equal(ptr_t.numpy(), ptr)
    got = _kernel_windows(*as_t(a, b, sw, sv, ws), t_c,
                          edge_state=(Et.reshape(-1), gt * width, torch.from_numpy(n_edges), ptr_t))
    assert_walk_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_kernel_adapt_matches_reference(seed):
    a, b, sw, sv, ws = walk_lanes(10 + seed)
    rng = np.random.default_rng(seed)
    hist = ref_synthetic_traces_batch(ref_catalog()[:3], 10.0, 2)
    from repro.core import FailurePdf as RefFailurePdf

    vals, tops = [], []
    for trs in hist.values():
        for tr in trs:
            for bid in (0.05, 0.3, 0.6):
                v, tp = RefFailurePdf.from_trace(tr, bid).compact_survival()
                vals.append(v)
                tops.append(tp)
    lens = np.asarray([len(v) for v in vals])
    rt = RefAdaptTables(flat=np.concatenate(vals), off=np.concatenate(([0], np.cumsum(lens)[:-1])),
                        top=np.asarray(tops), bin_s=float(RefFailurePdf.DEFAULT_BIN_S),
                        n_bins=int(RefFailurePdf.DEFAULT_MAX_BINS))
    pt = AdaptTables(flat=rt.flat.copy(), off=rt.off.copy(), top=rt.top.copy(), bin_s=rt.bin_s, n_bins=rt.n_bins)
    cells = rng.integers(0, len(vals), len(a))
    for t_c, t_r, interval in ((300.0, 300.0, 600.0), (900.0, 0.0, 1200.0)):
        want = ref_kernel_adapt(np, a, b, sw, sv, ws, t_c, t_r, interval, rt, cells)
        got = _kernel_adapt(*as_t(a, b, sw, sv, ws), t_c, t_r, interval, pt, cells)
        assert_walk_equal(got, want)
        assert want[0].any() and not want[0].all()


@pytest.mark.parametrize("seed", range(12))
def test_acc_attempts_batched_matches_reference(seed):
    """``tests/fleet/test_acc_fuzz.py``'s case generator: the batched ACC
    lease walk (torch ops) against ``repro``'s batched walk and the port's
    scalar ``simulate_acc_attempt``, lane for lane."""
    rng = np.random.default_rng(seed)
    horizon = float(rng.uniform(1.0, 6.0)) * 24 * HOUR
    n_seg = int(rng.integers(1, 12))
    cuts = np.sort(rng.uniform(0.0, horizon, size=n_seg - 1))
    prices = rng.uniform(0.1, 1.0, size=n_seg)
    segments = [(0.0, float(prices[0]))] + [(float(t), float(p)) for t, p in zip(cuts, prices[1:])]
    rtrace = ref_step_trace(segments, horizon_s=horizon)
    trace = PriceTrace(times=rtrace.times.copy(), prices=rtrace.prices.copy())
    a_bid = float(rng.uniform(0.15, 0.9))
    lanes = int(rng.integers(1, 9))
    work_s = rng.uniform(600.0, 30 * HOUR, size=lanes)
    start_ts = np.where(rng.random(lanes) < 0.3, 0.0, rng.uniform(0.0, horizon * 1.02, size=lanes))
    saved0 = np.where(rng.random(lanes) < 0.5, 0.0, rng.uniform(0.0, work_s * 0.9))
    params, rparams = SimParams(poll_s=float(rng.choice([60.0, 137.0]))), None
    rparams = RefSimParams(**dataclasses.asdict(params))
    got = batch.acc_attempts_batched(trace, work_s, a_bid, start_ts, params, initial_saved_work=saved0,
                                     device="cpu")
    want = ref_batch.acc_attempts_batched(rtrace, work_s, a_bid, start_ts, rparams, initial_saved_work=saved0)
    assert len(got) == len(want) == lanes
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None)
        if g is not None:
            assert dataclasses.astuple(g) == dataclasses.astuple(w)
            scalar = simulate_acc_attempt(trace, float(work_s[i]), a_bid, float(start_ts[i]), params,
                                          initial_saved_work=float(saved0[i]))
            assert dataclasses.astuple(g)[:4] == dataclasses.astuple(scalar)[:4]
            assert dataclasses.astuple(g)[5:] == dataclasses.astuple(scalar)[5:]
            assert g.cost == pytest.approx(scalar.cost, rel=1e-12, abs=0.0)
    assert math.isfinite(sum(g.end for g in got if g is not None))


def test_fleet_inputs_are_the_reference_inputs():
    sc, rsc = small("port"), small("ref")
    from repro.engine.fleetgrid import fleet_inputs as ref_fleet_inputs

    got, want = fleet_inputs(sc), ref_fleet_inputs(rsc)
    assert [it.name for it in got.types] == [it.name for it in want.types]
    for seed in sc.seeds:
        assert [job(j) for j in got.workloads[seed]] == [job(j) for j in want.workloads[seed]]
        for name in got.traces_by_seed[seed]:
            np.testing.assert_array_equal(got.traces_by_seed[seed][name].prices,
                                          want.traces_by_seed[seed][name].prices)
            np.testing.assert_array_equal(got.hist_by_seed[seed][name].prices, want.hist_by_seed[seed][name].prices)
