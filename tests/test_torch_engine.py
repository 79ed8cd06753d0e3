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
    want = {k: v for k, v in rsc.canonical().items() if k != "market"}
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
    """Contended markets are not ported yet and raise; ACC runs now (its
    checks are in ``tests/test_torch_acc.py``), so only the contended half of
    this test is left."""
    tr = synthetic_trace(get_instance("m1.xlarge"), 3, seed=5)
    with pytest.raises(NotImplementedError, match="capacity"):
        Scenario(work_s=5 * HOUR, bids=(0.40,), traces=(tr,), capacity=8)
    rsc = RefScenario.grid(
        work_s=5 * HOUR, bids=[0.5], instances=ref_catalog()[:1], horizon_days=3.0, capacity=8
    )
    with pytest.raises(NotImplementedError, match="capacity"):
        Scenario.from_reference(rsc.canonical())


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
    assert {k: v for k, v in rsc.canonical().items() if k != "market"} == canon
    assert smoke.result_digest(ref_run(rsc, "batch")) == smoke.GOLDEN_SHA256
    assert smoke.result_digest(run(Scenario.from_reference(canon), device="cpu")) == smoke.GOLDEN_SHA256
