"""The port's main path as a whole, on the CPU, against ``repro``'s engines.

One §VII study — three catalog types × five bid fractions × two seeds × the
five bid-limited schemes over ten days — is built in ``repro`` and carried
into the port through ``Scenario.from_reference``.  The port's
``engine.run`` (the plain PyTorch sweep on the CPU) must equal ``repro``'s
``batch`` and ``jax`` engines on every field, and the scalar
``ReferenceEngine`` on every field but ``cost``: the scalar reference sums
a cell's run costs with Python's compensated ``sum()``, the array engines
(and the port) with a plain left-to-right fold.  Every comparison is exact
(``assert_array_equal``): the simulation is IEEE float64 + − × ÷ and
compares, and the billing fold is the same host NumPy code.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import SimParams as RefSimParams
from repro.core import catalog as ref_catalog
from repro.engine import Scenario as RefScenario
from repro.engine import run as ref_run

from repro_torch import obs
from repro_torch.core import HOUR, Scheme, SimParams, get_instance, synthetic_trace
from repro_torch.engine import (
    BID_LIMITED_SCHEMES,
    Scenario,
    TorchEngine,
    get_engine,
    run,
)
from repro_torch.kernels.spot_sweep import kernel

FIELDS = (
    "completed", "completion_time", "cost", "n_checkpoints", "n_kills",
    "n_self_terminations", "work_lost_s",
)


@pytest.fixture(scope="module")
def study():
    rsc = RefScenario.grid(
        work_s=24 * 3600.0,
        bids=[0.50, 0.525, 0.55, 0.575, 0.60],
        instances=[it for it in ref_catalog() if it.os == "linux"][::11],
        horizon_days=10.0,
        seeds=(0, 1),
        bid_fractions=True,
    )
    sc = Scenario.from_reference(rsc.canonical())
    return rsc, sc, run(sc, engine=TorchEngine(device="cpu"))


@pytest.mark.parametrize("engine", ["batch", "jax", "reference"])
def test_slice_matches_reference_engines(study, engine):
    rsc, sc, res = study
    want = ref_run(rsc, engine)
    assert res.shape == want.shape == (6, 5, 5)
    assert res.completed.any() and not res.completed.all()
    for field in FIELDS:
        if field == "cost" and engine == "reference":
            continue  # compensated sum() vs left-to-right fold (see module docstring)
        np.testing.assert_array_equal(getattr(res, field), getattr(want, field), err_msg=field)


def test_generated_traces_equal_reference_traces(study):
    rsc, sc, _ = study
    want, got = rsc.materialize(), sc.materialize()
    assert len(got) == len(want) == 6
    for w, g in zip(want, got):
        assert (g.label, g.seed, g.on_demand) == (w.label, w.seed, w.on_demand)
        assert g.trace.times.dtype == w.trace.times.dtype == np.float64
        np.testing.assert_array_equal(g.trace.times, w.trace.times)
        np.testing.assert_array_equal(g.trace.prices, w.trace.prices)
        np.testing.assert_array_equal(g.trace.rising_edges(), w.trace.rising_edges())


def test_canonical_round_trip(study):
    rsc, sc, _ = study
    want = rsc.canonical()
    assert sc.canonical() == want
    assert Scenario.from_reference(sc.canonical()).canonical() == want


def test_explicit_traces_carry_over_and_are_checked():
    tr = synthetic_trace(get_instance("m1.xlarge"), 3, seed=5)
    sc = Scenario.from_trace(tr, 5 * HOUR, bids=[0.40, 0.45], schemes=BID_LIMITED_SCHEMES)
    canon = sc.canonical()
    back = Scenario.from_reference(canon, [(tr.times, tr.prices)])
    np.testing.assert_array_equal(back.traces[0].prices, tr.prices)
    with pytest.raises(ValueError, match="digest"):
        Scenario.from_reference(canon, [(tr.times, tr.prices + 0.001)])
    with pytest.raises(ValueError, match="pair"):
        Scenario.from_reference(canon)


def test_acc_and_contended_markets_raise():
    """Contended markets run now (their checks follow); what still raises is
    a contended study the JAX package refuses too: a pool of no capacity, a
    block deeper than 1 in an infinitely deep market, a negative demand."""
    tr = synthetic_trace(get_instance("m1.xlarge"), 3, seed=5)
    for kw in ({"capacity": 0}, {"demand": 2}, {"capacity": 4, "demand": 0}):
        with pytest.raises(ValueError):
            Scenario(work_s=5 * HOUR, bids=(0.40,), traces=(tr,), **kw)
        with pytest.raises(ValueError):
            RefScenario(work_s=5 * HOUR, bids=(0.40,), traces=(ref_trace(tr),), **kw)
    sc = Scenario(work_s=5 * HOUR, bids=(0.40,), traces=(tr,), capacity=8)
    assert sc.materialize()[0].trace is not tr
    assert Scenario(work_s=5 * HOUR, bids=(0.40,), traces=(tr,)).materialize()[0].trace is tr


def ref_trace(tr):
    from repro.core import PriceTrace as RefPriceTrace

    return RefPriceTrace(times=tr.times.copy(), prices=tr.prices.copy())


def assert_contended_equal(rsc, sc):
    """The port's contended study == ``repro``'s batch engine on every field,
    ``cost`` included, and its cleared traces are the reference's."""
    assert sc.canonical() == rsc.canonical()
    for g, w in zip(sc.materialize(), rsc.materialize()):
        np.testing.assert_array_equal(g.trace.prices, w.trace.prices)
        np.testing.assert_array_equal(g.trace.times, w.trace.times)
    got, want = run(sc, device="cpu"), ref_run(rsc, "batch")
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    return got


@pytest.mark.parametrize("demand", [1, 2, 3, 4])
def test_contended_engine_sweep_of_market_contention(demand):
    """``examples/market_contention.py``'s engine sweep (HOUR, bid $0.385,
    capacity 4, demand 1-4) through ``launch/market_contention.py``'s study."""
    from repro.core import Scheme as RefScheme
    from repro.core import get_instance as ref_get_instance
    from repro.core import synthetic_trace as ref_synthetic_trace
    from repro.market import MarketParams as RefMarketParams

    from repro_torch.launch import market_contention as mc

    it = ref_get_instance("m1.xlarge", region="us-east-1")
    tr = ref_synthetic_trace(it, 20, seed=3)
    rsc = RefScenario.from_trace(tr, 24 * 3600.0, [0.385], schemes=(RefScheme.HOUR,), capacity=4, demand=demand,
                                 market=RefMarketParams(ref_price=it.on_demand))
    sc = mc.sweep_scenario(demand)
    got = assert_contended_equal(rsc, sc)
    back = Scenario.from_reference(rsc.canonical(), [(tr.times, tr.prices)])
    assert back.canonical() == rsc.canonical()
    np.testing.assert_array_equal(run(back, device="cpu").cost, got.cost)


@pytest.mark.parametrize("demand", [1, 2])
@pytest.mark.parametrize("market", [{}, {"price_impact": 0.12, "util_base": 0.4, "ref_price": 0.3}])
def test_contended_generated_grid_all_schemes(demand, market):
    """A generated grid — 4 types × 5 bid fractions × 2 seeds, all six
    schemes, capacity 3 — carried over from ``repro`` by ``from_reference``
    on its contended canonical dict."""
    from repro.core import Scheme as RefScheme
    from repro.market import MarketParams as RefMarketParams

    rsc = RefScenario.grid(
        work_s=20 * HOUR, bids=[0.50, 0.525, 0.55, 0.575, 0.60],
        instances=[it for it in ref_catalog() if it.os == "linux"][2:40:10], schemes=tuple(RefScheme),
        horizon_days=6.0, seeds=(0, 1), bid_fractions=True, capacity=3, demand=demand,
        market=RefMarketParams(**market),
    )
    sc = Scenario.from_reference(rsc.canonical())
    assert sc.capacity == 3 and sc.demand == demand and sc.market.price_impact == rsc.market.price_impact
    got = assert_contended_equal(rsc, sc)
    assert got.completed.any() and not got.completed.all()
    if demand > 1:  # a block past the free depth changes the result against the open market
        open_ = run(dataclasses.replace(sc, capacity=None, demand=1), device="cpu")
        assert not np.array_equal(open_.cost, got.cost)


def test_no_gpu_raises_instead_of_running_on_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = Scenario.grid(work_s=5 * HOUR, bids=[0.5], instances=[get_instance("m1.small")], horizon_days=2.0)
    for make in (TorchEngine, lambda: get_engine("auto"), lambda: run(sc), lambda: TorchEngine(device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert TorchEngine(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        get_engine("jax", device="cpu")


def test_phase_timings_and_telemetry(study):
    _, sc, res = study
    t = res.timings
    assert t.engine == "torch" and t.impl == "plain"
    assert t.sim_s > 0 and set(t.per_scheme) == {s.value for s in BID_LIMITED_SCHEMES}
    before = kernel.launches
    with obs.Telemetry() as tel:
        again = run(sc, device="cpu")
    assert kernel.launches == before  # the CPU runs the plain version, never the kernel
    assert tel.counter("engine.runs") == 1
    assert tel.counter("engine.cells") == again.n_cells
    assert [s.name for s in tel.spans] == ["engine.run"]
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(again, field), getattr(res, field))


def test_cell_view_and_params_carry_over():
    """Non-default simulation constants and a resumed job reach the sweep."""
    params = SimParams(t_c=450.0, t_r=900.0, adapt_interval_s=900.0)
    rsc = dataclasses.replace(
        RefScenario.grid(
            work_s=30 * HOUR, bids=[0.52, 0.56], instances=ref_catalog()[8:9], horizon_days=8.0,
            seeds=(3,), bid_fractions=True,
            params=RefSimParams(t_c=450.0, t_r=900.0, adapt_interval_s=900.0),
        ),
        initial_saved_work=10 * HOUR,
    )
    sc = Scenario.from_reference(rsc.canonical())
    assert sc.params == params and sc.initial_saved_work == 10 * HOUR
    res = run(sc, device="cpu")
    want = ref_run(rsc, "batch")
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(res, field), getattr(want, field), err_msg=field)
    cell = res.cell(0, 1, Scheme.ADAPT)
    assert cell.bid == sc.market_bids(sc.materialize()[0])[1]
    assert cell.completion_time == res.completion_time[0, 1, 4]


def test_smoke_golden_digest_is_the_reference_result():
    """``chip_smoke.py`` holds the card's results on a small study against a
    pinned digest; that digest must be the digest of ``repro``'s results."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    canon = smoke.golden_study().canonical()
    by_name = {it.name: it for it in ref_catalog()}
    rsc = RefScenario.grid(
        work_s=canon["work_s"], bids=canon["bids"],
        instances=[by_name[it["name"]] for it in canon["instances"]],
        horizon_days=canon["horizon_days"], seeds=canon["seeds"], bid_fractions=canon["bid_fractions"],
    )
    assert rsc.canonical() == canon
    assert smoke.result_digest(ref_run(rsc, "batch")) == smoke.GOLDEN_SHA256
    assert smoke.result_digest(run(Scenario.from_reference(canon), device="cpu")) == smoke.GOLDEN_SHA256
