"""The port's serving subsystem, on the CPU, against ``repro.serving``.

Small grids only (``tests/serving/test_engine.py``'s ``QUICK``: 6 hours of
300 s periods, 2 seeds, 2 bid margins, ``max_spot`` 8; and the example's day
at capacity 12).  The gates:

  * traffic, the NumPy replica helpers, the policies on host scalars and the
    SLO scoring are copies of the JAX package's: ``==``;
  * each ``*_torch`` replica twin and each policy on tensors ``==`` its
    NumPy form; :func:`clear_periods_torch` ``==`` :func:`clear_periods`,
    and clearing at the fixed depth ``max_spot`` ``==`` clearing at the
    deepest live stack, as the JAX package's batch engine does;
  * both port engines (the reference on the host, the batch engine's torch
    waves with ``device="cpu"``) give every array field of
    ``ServingResult`` ``==`` ``repro``'s (``equal_nan``), uncontended and at
    capacity 12, with flash crowds, all three policies, with and without
    ``examples/faults/chaos_serving.json``; and ``batch == reference``;
  * the zero-traffic grid records the exogenous trace bit for bit.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro import faults as ref_faults
from repro.core.market import get_instance as ref_get_instance
from repro.market import MarketParams as RefMarketParams
from repro.market import clear_periods as ref_clear_periods
from repro.serving import ServingScenario as RefServingScenario
from repro.serving import run_serving as ref_run_serving
from repro.serving import replicas as ref_rep
from repro.serving import slo as ref_slo
from repro.serving import traffic as ref_traffic
from repro.serving.autoscaler import policy_registry as ref_policy_registry
from repro.suite import scenario_hash as ref_scenario_hash

from repro_torch import faults, obs
from repro_torch.core.market import TraceModel, ensemble_seed, get_instance, sample_traces_batch
from repro_torch.launch import spot_serving
from repro_torch.market import MarketParams, clear_periods, clear_periods_torch, marginal_price
from repro_torch.serving import (
    SERVING_ENGINES,
    ServingResult,
    ServingScenario,
    TargetTracking,
    ThresholdStep,
    TrafficModel,
    policy_registry,
    rates_batch,
    run_serving,
    traffic_seed,
)
from repro_torch.serving import replicas as rep
from repro_torch.serving import slo
from repro_torch.serving.engine import _serving_inputs
from repro_torch.suite import scenario_hash

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")

QUICK = dict(base_rps=1200.0, flash_crowds=1, horizon_days=0.25, seeds=(0, 1), bid_margins=(0.5, 1.1), max_spot=8)
#: the example's grid (examples/spot_serving.py) at full day length
EXAMPLE = dict(base_rps=1500.0, flash_crowds=1, horizon_days=1.0, seeds=(0, 1), bid_margins=(0.5, 1.1), max_spot=16)


def pair(**kw):
    """One study in both packages: ``(repro's, the port's)`` scenario."""
    ref_kw, port_kw = dict(kw), dict(kw)
    if "market" in kw:
        ref_kw["market"] = RefMarketParams(**kw["market"])
        port_kw["market"] = MarketParams(**kw["market"])
    if "spot_types" in kw:
        ref_kw["spot_types"] = tuple(ref_get_instance(*s.split("/")) for s in kw["spot_types"])
        port_kw["spot_types"] = tuple(get_instance(*s.split("/")) for s in kw["spot_types"])
    return RefServingScenario(**ref_kw), ServingScenario(**port_kw)


def assert_results_equal(a, b):
    """Every field but the engine name and the wall time, ``==`` (NaN == NaN)."""
    for f in dataclasses.fields(ServingResult):
        if f.name in ("engine", "wall_s"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f"{f.name}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}"
            assert np.array_equal(x, y, equal_nan=True), f"mismatch in {f.name}"
        else:
            assert x == y, f"mismatch in {f.name}"


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

TRAFFIC = [
    {},
    {"flash_crowds": 3, "flash_magnitude": 4.0},
    {"base_rps": 0.0, "flash_crowds": 2},
    {"jitter": 0.0, "diurnal_amplitude": 1.0, "diurnal_phase_s": 3600.0},
    {"base_rps": 50.0, "jitter": 3.0, "diurnal_period_s": 7 * 3600.0},
]


@pytest.mark.parametrize("kw", TRAFFIC, ids=lambda kw: ",".join(kw) or "default")
@pytest.mark.parametrize("seed", [0, 1, 17])
def test_rates_equal_the_reference(kw, seed):
    got = TrafficModel(**kw).rates(2 * 86400.0, 300.0, seed)
    want = ref_traffic.TrafficModel(**kw).rates(2 * 86400.0, 300.0, seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_zero_traffic_is_bitwise_zero_and_batches_are_rows():
    z = TrafficModel(base_rps=0.0, flash_crowds=2).rates(86400.0, 300.0, 3)
    assert (z == 0.0).all() and not np.signbit(z).any()
    m = TrafficModel(flash_crowds=1)
    batch = rates_batch(m, 86400.0, 300.0, [0, 5, 9])
    assert np.array_equal(batch, ref_traffic.rates_batch(ref_traffic.TrafficModel(flash_crowds=1), 86400.0, 300.0,
                                                         [0, 5, 9]))
    assert all(np.array_equal(batch[i], m.rates(86400.0, 300.0, s)) for i, s in enumerate([0, 5, 9]))
    assert [traffic_seed(s, i) for s in (0, 3) for i in (0, 2)] == [
        ref_traffic.traffic_seed(s, i) for s in (0, 3) for i in (0, 2)]


@pytest.mark.parametrize("bad", [{"base_rps": -1.0}, {"diurnal_amplitude": 1.5}, {"flash_magnitude": 0.5},
                                 {"flash_duration_s": 0.0}, {"jitter": -0.1}, {"diurnal_period_s": 0.0}])
def test_traffic_validation_matches(bad):
    with pytest.raises(ValueError):
        ref_traffic.TrafficModel(**bad)
    with pytest.raises(ValueError):
        TrafficModel(**bad)
    with pytest.raises(ValueError):
        traffic_seed(-1)


# ---------------------------------------------------------------------------
# replicas: NumPy copies == repro's, torch twins == NumPy
# ---------------------------------------------------------------------------


def random_pipes(seed, shape=(7, 3, 4)):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 5, shape).astype(np.int64), rng.integers(0, 9, shape[:-1]).astype(np.int64)


@pytest.mark.parametrize("seed", range(3))
def test_pipes_equal_reference_and_twins(seed):
    pipe, n = random_pipes(seed)
    for fn, ref_fn in ((rep.advance_pipe, ref_rep.advance_pipe),):
        (a, b), (c, d) = fn(pipe), ref_fn(pipe)
        assert np.array_equal(a, c) and np.array_equal(b, d)
        ta, tb = rep.advance_pipe_torch(torch.from_numpy(pipe))
        assert np.array_equal(ta.numpy(), a) and np.array_equal(tb.numpy(), b)
    p1, p2, p3 = pipe.copy(), pipe.copy(), torch.from_numpy(pipe.copy())
    got = rep.cancel_latest(p1, n)
    want = ref_rep.cancel_latest(p2, n)
    twin = rep.cancel_latest_torch(p3, torch.from_numpy(n))
    assert np.array_equal(got, want) and np.array_equal(p1, p2)
    assert np.array_equal(twin.numpy(), got) and np.array_equal(p3.numpy(), p1)


@pytest.mark.parametrize("seed", range(4))
def test_capacity_cost_and_targets_equal_reference_and_twins(seed):
    rng = np.random.default_rng(seed)
    C, T = 40, 3
    n_run = rng.integers(0, 17, (C, T)).astype(np.int64)
    rps = rng.uniform(50.0, 400.0, T)
    prices = rng.uniform(0.01, 1.0, (C, T))
    od_rps = float(rng.uniform(0, 500))
    desired = rng.uniform(-50.0, 5000.0, C)
    desired[:3] = (0.0, -0.0, 1e-300)
    factor = rng.uniform(1.0, 5.0, (C, T))
    t = torch.from_numpy
    cap = rep.tier_capacity(od_rps, n_run, rps)
    assert np.array_equal(cap, ref_rep.tier_capacity(od_rps, n_run, rps))
    assert np.array_equal(rep.tier_capacity_torch(od_rps, t(n_run), t(rps)).numpy(), cap)
    cost = rep.period_cost(2, 0.68, n_run, prices, 300.0 / 3600.0)
    assert np.array_equal(cost, ref_rep.period_cost(2, 0.68, n_run, prices, 300.0 / 3600.0))
    assert np.array_equal(rep.period_cost_torch(2, 0.68, t(n_run), t(prices), 300.0 / 3600.0).numpy(), cost)
    n = rep.target_counts(desired, rps, factor, 16)
    assert np.array_equal(n, ref_rep.target_counts(desired, rps, factor, 16))
    twin = rep.target_counts_torch(t(desired), t(rps), t(factor), 16)
    assert twin.dtype == torch.int64 and np.array_equal(twin.numpy(), n)
    assert rep.replica_rps(get_instance("c1.xlarge"), 100.0) == ref_rep.replica_rps(
        ref_get_instance("c1.xlarge"), 100.0) == 250.0


def test_device_scalar_is_one_cached_tensor():
    a = rep.device_scalar(0.7, CPU)
    assert a is rep.device_scalar(0.7, CPU) and a.dtype == torch.float64 and a.item() == 0.7


# ---------------------------------------------------------------------------
# autoscaler policies: host scalars == repro's, tensors == NumPy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["target", "threshold", "hazard"])
def test_policies_on_scalars_and_tensors(name):
    ref_sc, sc = pair(**QUICK)
    pol, ref_pol = policy_registry(sc)[name], ref_policy_registry(ref_sc)[name]
    assert (pol.name, pol.hazard_aware) == (ref_pol.name, ref_pol.hazard_aware) == (name, name == "hazard")
    rng = np.random.default_rng(1)
    rate = rng.uniform(0.0, 4000.0, 64)
    rate[:4] = (0.0, 1e-12, 1e5, 850.0)
    spot = rng.uniform(0.0, 3000.0, 64)
    spot[:3] = (0.0, 0.0, -0.0)
    od = 200.0
    for r, s in zip(rate[:8], spot[:8]):  # the reference engine's host scalars
        assert pol.desired_spot_rps(r, od, s) == ref_pol.desired_spot_rps(r, od, s)
    want = ref_pol.desired_spot_rps(rate, od, spot)
    assert np.array_equal(pol.desired_spot_rps(rate, od, spot), want)
    got = pol.desired_spot_rps(torch.from_numpy(rate), od, torch.from_numpy(spot))
    assert isinstance(got, torch.Tensor) and np.array_equal(got.numpy(), want)


def test_policy_validation():
    with pytest.raises(ValueError):
        TargetTracking(target_utilization=0.0)
    with pytest.raises(ValueError):
        ThresholdStep(hi=0.4, lo=0.5)
    with pytest.raises(ValueError):
        ThresholdStep(step_rps=0.0)


# ---------------------------------------------------------------------------
# SLO scoring (host NumPy copies)
# ---------------------------------------------------------------------------


def test_p99_and_summarize_equal_reference():
    rng = np.random.default_rng(5)
    rate = rng.uniform(0.0, 3000.0, (6, 50))
    cap = rng.uniform(0.0, 3500.0, (6, 50))
    rate[0, :5], cap[1, :5] = 0.0, 0.0
    got = slo.p99_latency(rate, cap, 100.0)
    want = ref_slo.p99_latency(rate, cap, 100.0)
    assert np.array_equal(got, want) and np.isinf(got).any() and (got == 0.0).any()
    ref_sc, sc = pair(**QUICK)
    served, offered, cost = rng.uniform(0, 1e6, 6), rng.uniform(0, 1e6, 6), rng.uniform(0, 10, 6)
    served[0] = offered[1] = 0.0
    for a, b in zip(slo.summarize(sc, rate, cap, served, offered, cost),
                    ref_slo.summarize(ref_sc, rate, cap, served, offered, cost)):
        assert np.array_equal(a, b, equal_nan=True)


# ---------------------------------------------------------------------------
# the torch clearing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_clear_periods_torch_equals_numpy(seed):
    rng = np.random.default_rng(seed)
    n, P, cap = 12, 30, 10
    params = MarketParams()
    base = np.round(rng.uniform(0.05, 0.6, P), 3)
    free = rng.integers(0, cap + 1, P).astype(np.int64)
    bids = np.round(rng.uniform(0.04, 0.9, n), 3)
    active = rng.random((n, P)) < 0.6
    ladder = marginal_price(base[None, :], free[None, :], np.arange(1, n + 1)[:, None], cap, params)
    want = clear_periods(bids, active, base, free, cap, params)
    assert all(np.array_equal(a, b) for a, b in zip(want, ref_clear_periods(
        bids, active, base, free, cap, RefMarketParams())))
    t = torch.from_numpy
    got = clear_periods_torch(t(bids), t(active), t(base), t(ladder))
    assert got[0].dtype == torch.int64
    assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])
    # leading axes batch independent clearings
    stacked = clear_periods_torch(t(np.stack([bids, bids[::-1]])), t(np.stack([active, active[::-1]])),
                                  t(np.stack([base, base])), t(np.stack([ladder, ladder])))
    second = clear_periods(bids[::-1], active[::-1], base, free, cap, params)
    assert np.array_equal(stacked[0][0].numpy(), want[0]) and np.array_equal(stacked[1][1].numpy(), second[1])


@pytest.mark.parametrize("seed", range(3))
def test_fixed_depth_clearing_equals_the_live_depth(seed):
    """The JAX package clears each (period, type) with ``Kp`` = the deepest
    live stack lanes a margin; the port at ``K = max_spot``: the same."""
    rng = np.random.default_rng(seed)
    M, S, C, K, cap = 3, 4, 24, 16, 12
    params = MarketParams()
    bids = np.round(rng.uniform(0.1, 1.0, M), 3)
    cell_mi, cell_si = (np.arange(C) // S) % M, np.arange(C) % S
    base = np.round(rng.uniform(0.05, 0.6, S), 3)
    free = rng.integers(0, cap + 1, S).astype(np.int64)
    ladder = marginal_price(base[:, None], free[:, None], np.arange(1, K + 1)[None, :], cap, params)  # (S, K)
    for _ in range(5):
        n_run = rng.integers(0, K + 1, C)
        n_run[rng.random(C) < 0.3] = 0
        Kp = int(n_run.max())
        if Kp == 0:
            continue
        lane_m, lane_r = np.repeat(np.arange(M), Kp), np.tile(np.arange(Kp), M)
        active = (lane_m[:, None] == cell_mi[None, :]) & (lane_r[:, None] < n_run[None, :])
        lad = np.concatenate([ladder[cell_si, :Kp].T, np.full(((M - 1) * Kp, C), np.inf)])
        want = clear_periods(np.repeat(bids, Kp), active, base[cell_si], free[cell_si], cap, params, ladder=lad)
        lane_m, lane_r = np.repeat(np.arange(M), K), np.tile(np.arange(K), M)
        active = (lane_m[:, None] == cell_mi[None, :]) & (lane_r[:, None] < n_run[None, :])
        lad = np.concatenate([ladder[cell_si, :K].T, np.full(((M - 1) * K, C), np.inf)])
        t = torch.from_numpy
        got = clear_periods_torch(t(np.repeat(bids, K)), t(active), t(base[cell_si]), t(lad))
        assert np.array_equal(got[0].numpy(), want[0]) and np.array_equal(got[1].numpy(), want[1])


# ---------------------------------------------------------------------------
# the engines against repro's
# ---------------------------------------------------------------------------

GRIDS = {
    "quick_uncontended": dict(QUICK),
    "quick_capacity_12": dict(QUICK, capacity=12),
    "quick_capacity_4": dict(QUICK, capacity=4),
    "example_capacity_12": dict(EXAMPLE, capacity=12),
    "example_uncontended": dict(EXAMPLE),
    "three_types_market": dict(QUICK, capacity=6, spot_types=("m1.xlarge", "c1.xlarge", "m1.large/us-east-1"),
                               market={"price_impact": 0.2, "util_base": 0.8}, on_demand_replicas=0,
                               boot_delay_s=1200.0, drain_delay_s=0.0, threshold_step=1),
}


@pytest.fixture(scope="module")
def ref_results():
    return {name: ref_run_serving(pair(**kw)[0], engine="batch") for name, kw in GRIDS.items()}


@pytest.mark.parametrize("engine", SERVING_ENGINES)
@pytest.mark.parametrize("name", list(GRIDS))
def test_engines_equal_the_reference_package(ref_results, name, engine):
    _, sc = pair(**GRIDS[name])
    got = run_serving(sc, engine=engine, device="cpu" if engine == "batch" else None)
    assert got.engine == engine
    want = ref_results[name]
    assert_results_equal(got, want)
    assert got.n_scale_out.sum() > 0
    if sc.capacity is not None and sc.capacity < 12:
        assert got.n_preempted.sum() > 0


def test_batch_equals_reference_and_auto_is_batch():
    _, sc = pair(**QUICK, capacity=6)
    a = run_serving(sc, engine="reference")
    b = run_serving(sc, engine="auto", device="cpu")
    assert (a.engine, b.engine) == ("reference", "batch")
    assert_results_equal(a, b)
    assert set(SERVING_ENGINES) == {"reference", "batch"}


@pytest.mark.parametrize("engine", SERVING_ENGINES)
@pytest.mark.parametrize("capacity", [None, 12], ids=["uncontended", "capacity_12"])
def test_committed_chaos_schedule_equals_the_reference(engine, capacity):
    schedule = ROOT / "examples/faults/chaos_serving.json"
    ref_sc, sc = pair(**EXAMPLE, capacity=capacity)
    ref_plan, plan = ref_faults.load_plan(schedule), faults.load_plan(schedule)
    with ref_plan:
        want = ref_run_serving(ref_sc, engine="batch")
    with plan:
        got = run_serving(sc, engine=engine, device="cpu" if engine == "batch" else None)
    assert_results_equal(got, want)
    assert got.n_boot_lost.sum() > 0 and len(plan.log) > 0
    if engine == "batch":  # the same (site, key) in the same order
        assert [a.describe() for a in plan.log] == [a.describe() for a in ref_plan.log]


@pytest.mark.parametrize("capacity", [None, 6], ids=["uncontended", "contended"])
def test_engines_equal_under_a_denser_chaos_plan(capacity):
    rules = [("serving.replica_boot", 0.3), ("serving.scale_decision", 0.2)]
    ref_sc, sc = pair(**QUICK, capacity=capacity)
    with ref_faults.FaultPlan([ref_faults.FaultRule(s, p=p, max_fires=2) for s, p in rules], seed=7):
        want = ref_run_serving(ref_sc, engine="batch")
    results = []
    for engine in SERVING_ENGINES:
        with faults.FaultPlan([faults.FaultRule(s, p=p, max_fires=2) for s, p in rules], seed=7):
            results.append(run_serving(sc, engine=engine, device="cpu" if engine == "batch" else None))
    for got in results:
        assert_results_equal(got, want)
    clean = run_serving(sc, device="cpu")
    assert results[1].n_boot_lost.sum() > clean.n_boot_lost.sum() == 0


def test_fault_sites_are_registered():
    assert {"serving.replica_boot", "serving.scale_decision"} <= set(faults.SITES)
    assert faults.SITES["serving.replica_boot"] == ref_faults.SITES["serving.replica_boot"]


def exogenous_base_prices(sc) -> np.ndarray:
    """(T, S, P) period-start prices rebuilt from the market plane alone."""
    models, streams = [], []
    for it in sc.spot_types:
        m = TraceModel.for_instance(it)
        for s in sc.seeds:
            models.append(m)
            streams.append(ensemble_seed(it, s))
    traces = sample_traces_batch(models, sc.horizon_s, streams)
    starts = np.arange(sc.n_periods, dtype=np.float64) * sc.control_period_s
    S = len(sc.seeds)
    base = np.empty((len(sc.spot_types), S, sc.n_periods))
    for ti in range(len(sc.spot_types)):
        for si in range(S):
            tr = traces[ti * S + si]
            idx = np.clip(np.searchsorted(tr.times, starts, side="right") - 1, 0, len(tr.prices) - 1)
            base[ti, si] = tr.prices[idx]
    return base


@pytest.mark.parametrize("engine", SERVING_ENGINES)
@pytest.mark.parametrize("capacity", [None, 6], ids=["uncontended", "contended"])
def test_zero_traffic_reproduces_exogenous_price_trace(engine, capacity):
    sc = ServingScenario(base_rps=0.0, horizon_days=0.25, seeds=(0, 1), bid_margins=(0.5, 1.1), capacity=capacity)
    res = run_serving(sc, engine=engine, device="cpu" if engine == "batch" else None)
    expected = exogenous_base_prices(sc)
    for pi in range(len(res.policies)):
        for mi in range(len(res.bid_margins)):
            for si in range(len(res.seeds)):
                assert np.array_equal(res.spot_price[pi, mi, si], expected[:, si, :])
    assert (res.availability == 1.0).all()
    assert (res.n_scale_out == 0).all() and (res.n_preempted == 0).all()
    od_floor = sc.on_demand_replicas * sc.on_demand_type.on_demand * sc.n_periods * sc.control_period_s / 3600.0
    assert res.cost == pytest.approx(od_floor)


class NeverTensor:
    """A policy written for tensors: never asks for spot capacity."""

    name = "never"
    hazard_aware = False

    def desired_spot_rps(self, rate, od_rps, spot_run_rps):
        return rate * 0.0


def test_custom_policy_override():
    never = NeverTensor()
    _, sc = pair(**QUICK, policies=("target", "never"))
    a = run_serving(sc, engine="reference", policies={"never": never})
    b = run_serving(sc, engine="batch", policies={"never": never}, device="cpu")
    assert_results_equal(a, b)
    assert a.policies == ("target", "never") and (a.n_scale_out[1] == 0).all() and (a.n_scale_out[0] > 0).all()


def test_devices_engines_and_policies_are_checked(monkeypatch):
    _, sc = pair(**QUICK)
    with pytest.raises(ValueError, match="unknown serving engine"):
        run_serving(sc, engine="warp", device="cpu")
    with pytest.raises(ValueError, match="unknown autoscaler policies"):
        run_serving(dataclasses.replace(sc, policies=("target", "nope")), device="cpu")
    with pytest.raises(ValueError, match="host"):
        run_serving(sc, engine="reference", device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving(sc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving(sc, engine="batch", device="cuda")
    assert run_serving(sc, engine="reference").engine == "reference"  # the host engine needs no card


def test_telemetry_span_and_counters():
    _, sc = pair(**QUICK, capacity=6)
    with obs.Telemetry() as tel:
        res = run_serving(sc, device="cpu")
    spans = tel.find_spans("serving.run")
    assert len(spans) == 1
    assert spans[0].attrs["engine"] == "batch" and spans[0].attrs["n_cells"] == sc.n_cells
    assert spans[0].attrs["device"] == "cpu"
    assert tel.counter("serving.scale_out") == res.n_scale_out.sum()
    assert tel.counter("serving.scale_in") == res.n_scale_in.sum()
    assert tel.counter("serving.preempt_outbid") == res.n_preempted.sum()
    assert tel.counter("serving.slo_violation_s") == pytest.approx(res.slo_violation_s.sum())
    assert tel.counter("market.clear_periods") == len(sc.spot_types) * sc.n_periods


def test_scenario_canonical_and_hash_equal_the_reference():
    for kw in (QUICK, dict(QUICK, capacity=12), GRIDS["three_types_market"], {}):
        ref_sc, sc = pair(**kw)
        assert sc.canonical() == ref_sc.canonical()
        assert scenario_hash(sc) == ref_scenario_hash(ref_sc)
        assert np.array_equal(sc.bids(), ref_sc.bids())
        assert (sc.n_periods, sc.n_cells, sc.horizon_s) == (ref_sc.n_periods, ref_sc.n_cells, ref_sc.horizon_s)


@pytest.mark.parametrize("bad", [{"seeds": ()}, {"capacity": 0}, {"max_spot": 0}, {"threshold_step": 0},
                                 {"horizon_days": 0.001}, {"rps_capacity_ref": 0.0}, {"slo_p99_s": 0.0},
                                 {"boot_delay_s": -1.0}, {"spot_types": ()}, {"hazard_window_s": 0.0}])
def test_scenario_validation_matches(bad):
    with pytest.raises(ValueError):
        RefServingScenario(**bad)
    with pytest.raises(ValueError):
        ServingScenario(**bad)


def test_inputs_are_built_once_with_the_ladder():
    _, sc = pair(**QUICK, capacity=6)
    inp = _serving_inputs(sc)
    assert _serving_inputs(sc) is inp
    assert inp.ladder.shape == (2, 2, sc.max_spot, sc.n_periods)
    assert _serving_inputs(ServingScenario(**QUICK)).ladder is None


def test_spot_serving_launcher_prints_the_examples_table(capsys):
    res = spot_serving.main(["--device", "cpu"])
    want = ref_run_serving(RefServingScenario(**EXAMPLE, capacity=12))
    assert_results_equal(res, want)
    out = capsys.readouterr().out.splitlines()
    assert out[1:] == spot_serving.table(want)
    assert len(out) == 2 + 1 + len(res.policies) * len(res.bid_margins) + 1
