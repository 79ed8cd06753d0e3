"""The port's scalar reference, on the CPU, against the JAX package's.

``repro_torch.core.simulator`` is host Python like ``repro.core.simulator``
and must equal it with ``==`` on every field, the billed runs and ``cost``
included (both fold a job's run costs with the builtin ``sum()``), for all
six schemes and from a resumed checkpoint.  The single-attempt chains follow
``tests/core/test_acc_attempt.py`` and ``test_simulator_resume.py``; the
market helpers and the ADAPT rule follow ``test_market_edges.py`` and
``test_provision.py``.  The port's ``ReferenceEngine`` must equal the JAX
package's, and ``parity`` holds the port's torch engine to the port's
reference: ``==`` on every field but ``cost``, which is within
``COST_RTOL`` (the engine folds left to right, the reference compensates).
Last, the paper-claims bands of ``tests/core/test_paper_claims.py`` hold on
the port's engine.
"""

import numpy as np
import pytest

import repro.core as R
from repro.core.schemes import adapt_should_checkpoint as ref_adapt_should_checkpoint
from repro.engine import ReferenceEngine as RefReferenceEngine
from repro.engine import Scenario as RefScenario

from repro_torch.core import (
    ALL_SCHEMES,
    HOUR,
    FailurePdf,
    Scheme,
    SimParams,
    Termination,
    adapt_should_checkpoint,
    catalog,
    constant_trace,
    get_instance,
    shift_trace,
    simulate,
    simulate_acc_attempt,
    simulate_attempt,
    step_trace,
    synthetic_trace,
    synthetic_traces_batch,
    trace_ensemble,
)
from repro_torch.engine import (
    COMPARED,
    COST_RTOL,
    ReferenceEngine,
    Scenario,
    TorchEngine,
    assert_parity,
    compare_engines,
    compare_results,
    get_engine,
    run,
)
from repro_torch.launch import policy_compare

P = SimParams()
IT = get_instance("m1.xlarge")
RIT = R.get_instance("m1.xlarge")
SIM_FIELDS = (
    "scheme", "bid", "work_s", "completed", "completion_time", "cost", "n_checkpoints", "n_kills",
    "n_self_terminations", "work_lost_s",
)


def assert_same_sim(got, want):
    for f in SIM_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if f == "scheme":
            g, w = g.value, w.value
        assert g == w, f
    assert [(r.launch, r.end, r.termination.value, r.cost) for r in got.runs] == [
        (r.launch, r.end, r.termination.value, r.cost) for r in want.runs
    ]
    for prop in ("cost_time_product", "availability_overhead"):  # nan (0 * inf) where unfinished at no cost
        np.testing.assert_array_equal(getattr(got, prop), getattr(want, prop), err_msg=prop)


def assert_same_attempt(got, want):
    if want is None:
        assert got is None
        return
    for f in ("launch", "end", "completed", "killed", "cost", "work_done_s", "saved_work_s", "n_checkpoints",
              "self_terminated"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.termination().value == want.termination().value


# ---------------------------------------------------------------------------
# simulate, every scheme, every field
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ALL_SCHEMES, ids=lambda s: s.value)
@pytest.mark.parametrize("seed", [0, 3])
def test_simulate_matches_jax(scheme, seed):
    tr = synthetic_trace(IT, 20, seed=seed)
    rtr = R.synthetic_trace(RIT, 20, seed=seed)
    np.testing.assert_array_equal(tr.prices, rtr.prices)
    params = SimParams(t_c=450.0, t_r=900.0) if seed else P
    rparams = R.SimParams(t_c=450.0, t_r=900.0) if seed else R.SimParams()
    for bid in (0.30, 0.36, 0.38, 0.40, 0.42, 5.0):
        for saved in (0.0, 7 * HOUR):
            got = simulate(tr, scheme, 20 * HOUR, bid, params, initial_saved_work=saved)
            want = R.simulate(rtr, R.Scheme(scheme.value), 20 * HOUR, bid, rparams, initial_saved_work=saved)
            assert_same_sim(got, want)


def test_simulate_step_trace_edges_match_jax():
    segs = [(0.0, 0.30), (0.4 * 86400, 0.50), (0.45 * 86400, 0.31), (1.3 * 86400, 0.52), (1.35 * 86400, 0.29),
            (2.0 * 86400, 0.55)]
    tr, rtr = step_trace(segs, horizon_s=3 * 86400), R.step_trace(segs, horizon_s=3 * 86400)
    for scheme in ALL_SCHEMES:
        for bid in (0.295, 0.32, 0.51, 0.6):
            assert_same_sim(
                simulate(tr, scheme, 10 * HOUR, bid, P), R.simulate(rtr, R.Scheme(scheme.value), 10 * HOUR, bid)
            )


def test_simulate_rejects_bad_resume():
    tr = synthetic_trace(IT, 5, seed=0)
    for bad in (-1.0, 7200.0):
        with pytest.raises(ValueError):
            simulate(tr, Scheme.HOUR, 3600.0, 0.40, P, initial_saved_work=bad)


# ---------------------------------------------------------------------------
# the single-attempt primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", [Scheme.NONE, Scheme.HOUR, Scheme.EDGE, Scheme.ADAPT, Scheme.OPT],
                         ids=lambda s: s.value)
def test_simulate_attempt_chains_match_jax(scheme):
    tr, rtr = synthetic_trace(IT, 30, seed=5), R.synthetic_trace(RIT, 30, seed=5)
    for bid in (0.37, 0.39, 0.41):
        t, saved = 0.0, 0.0
        for _ in range(200):
            got = simulate_attempt(tr, scheme, 20 * HOUR, bid, t, P, initial_saved_work=saved)
            want = R.simulate_attempt(rtr, R.Scheme(scheme.value), 20 * HOUR, bid, t, initial_saved_work=saved)
            assert_same_attempt(got, want)
            if got is None or got.completed:
                break
            t, saved = got.end, got.saved_work_s
    with pytest.raises(ValueError):
        simulate_attempt(tr, Scheme.ACC, 3600.0, 0.40)


@pytest.mark.parametrize("seed", [0, 1, 3, 5])
@pytest.mark.parametrize("bid", [0.36, 0.37, 0.40])
def test_acc_attempt_chain_reproduces_simulate_and_jax(seed, bid):
    tr, rtr = synthetic_trace(IT, 30, seed=seed), R.synthetic_trace(RIT, 30, seed=seed)
    work = 60 * 3600.0
    full = simulate(tr, Scheme.ACC, work, bid, P)
    assert_same_sim(full, R.simulate(rtr, R.Scheme.ACC, work, bid))
    saved, t, costs, ckpts, terms = 0.0, 0.0, [], 0, 0
    for _ in range(500):
        att = simulate_acc_attempt(tr, work, bid, t, P, initial_saved_work=saved)
        assert_same_attempt(att, R.simulate_acc_attempt(rtr, work, bid, t, initial_saved_work=saved))
        if att is None:
            break
        costs.append(att.cost)
        ckpts += att.n_checkpoints
        assert att.saved_work_s >= saved and not att.killed
        if att.completed:
            assert full.completed and att.end == full.completion_time
            break
        if not att.self_terminated:  # ran off the horizon
            assert not full.completed
            break
        terms += 1
        saved = att.saved_work_s
        t = att.end + 1e-9
    assert sum(costs) == full.cost  # the same runs, folded by the same sum()
    assert ckpts == full.n_checkpoints and terms == full.n_self_terminations


def test_acc_attempt_cases():
    """``tests/core/test_acc_attempt.py``'s hand-built cases, through the port."""
    tr = step_trace([(0.0, 0.30), (0.9 * HOUR, 1.0), (5 * HOUR, 0.30)], horizon_s=40 * HOUR)
    att = simulate_acc_attempt(tr, 100 * 3600.0, 0.40, 0.0, P)
    assert att.self_terminated and not att.completed and not att.killed
    assert att.end == HOUR and att.termination() == Termination.USER and att.cost == 0.30

    tr = step_trace([(0.0, 1.0), (2 * HOUR + 30.0, 0.30)], horizon_s=40 * HOUR)
    att = simulate_acc_attempt(tr, 3600.0, 0.40, 0.0, P)
    assert att.launch == 2 * HOUR + 60.0 and att.completed  # the next 60 s poll tick

    assert simulate_acc_attempt(step_trace([(0.0, 1.0)], horizon_s=10 * HOUR), 3600.0, 0.40, 0.0, P) is None
    tr2 = step_trace([(0.0, 0.30), (HOUR, 1.0)], horizon_s=10 * HOUR)
    assert simulate_acc_attempt(tr2, 3600.0, 0.40, 2 * HOUR, P) is None

    tr = step_trace([(0.0, 0.30)], horizon_s=2.5 * HOUR)  # a lease that runs off the horizon
    att = simulate_acc_attempt(tr, 1000 * 3600.0, 0.40, 0.0, P)
    assert not att.completed and not att.self_terminated and att.end == 2.5 * HOUR
    assert att.cost == 2 * 0.30 and att.termination() == Termination.OUT_OF_BID
    assert simulate(tr, Scheme.ACC, 1000 * 3600.0, 0.40, P).cost == att.cost
    for bad in (-1.0, 7200.0):
        with pytest.raises(ValueError):
            simulate_acc_attempt(tr, 3600.0, 0.40, 0.0, P, initial_saved_work=bad)


# ---------------------------------------------------------------------------
# market helpers and the ADAPT rule
# ---------------------------------------------------------------------------


def test_market_helpers_match_jax():
    assert [it.key for it in catalog()] == [it.key for it in R.catalog()]
    tr, rtr = synthetic_trace(IT, 10, seed=2), R.synthetic_trace(RIT, 10, seed=2)
    for bid in (0.30, 0.38, 0.41, 5.0):
        for t in (0.0, 3599.0, 3600.0, 86400.0 + 17.0, tr.horizon - 1.0, tr.horizon):
            assert tr.next_available(bid, t) == rtr.next_available(bid, t)
            if t < tr.horizon:
                assert tr.next_out_of_bid(bid, t) == rtr.next_out_of_bid(bid, t)
    for off in (0.0, tr.times[3], 0.5 * (tr.times[7] + tr.times[8]), tr.times[-2] + 1.0):
        got, want = shift_trace(tr, off), R.shift_trace(rtr, off)
        np.testing.assert_array_equal(got.times, want.times)
        np.testing.assert_array_equal(got.prices, want.prices)
    with pytest.raises(ValueError):
        shift_trace(tr, tr.horizon)
    c, rc = constant_trace(0.4, 5 * HOUR), R.constant_trace(0.4, 5 * HOUR)
    np.testing.assert_array_equal(c.times, rc.times)
    np.testing.assert_array_equal(c.prices, rc.prices)
    for got, want in zip(trace_ensemble(IT, 3, 5.0, seed=2), R.trace_ensemble(RIT, 3, 5.0, seed=2)):
        np.testing.assert_array_equal(got.prices, want.prices)
    insts = catalog()[::21]
    got = synthetic_traces_batch(insts, 4.0, base_seed=3, n_seeds=2)
    want = R.synthetic_traces_batch(R.catalog()[::21], 4.0, base_seed=3, n_seeds=2)
    assert list(got) == list(want)
    for name in got:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g.times, w.times)
            np.testing.assert_array_equal(g.prices, w.prices)


def test_survival_hazard_and_adapt_rule_match_jax():
    tr, rtr = synthetic_trace(IT, 20, seed=4), R.synthetic_trace(RIT, 20, seed=4)
    for bid in (0.37, 0.40):
        pdf, rpdf = FailurePdf.from_trace(tr, bid), R.FailurePdf.from_trace(rtr, bid)
        for params, rparams in ((P, R.SimParams()), (SimParams(t_c=120.0, t_r=60.0), R.SimParams(t_c=120.0, t_r=60.0))):
            for age in (0.0, 59.0, 600.0, 3600.0, 7 * 3600.0 + 1.0, 40 * 86400.0):
                assert pdf.survival(age) == rpdf.survival(age)
                assert pdf.hazard(age, 600.0) == rpdf.hazard(age, 600.0)
                for unsaved in (0.0, 300.0, 4000.0, 40000.0):
                    assert adapt_should_checkpoint(pdf, age, unsaved, params) == ref_adapt_should_checkpoint(
                        rpdf, age, unsaved, rparams
                    )


# ---------------------------------------------------------------------------
# the reference engine and parity
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def study():
    rsc = RefScenario.grid(
        work_s=20 * HOUR, bids=[0.50, 0.53, 0.56, 0.60], instances=[it for it in R.catalog() if it.os == "linux"][::9],
        schemes=tuple(R.Scheme), horizon_days=8.0, seeds=(0, 1), bid_fractions=True,
    )
    return rsc, Scenario.from_reference(rsc.canonical())


def test_reference_engine_matches_jax(study):
    rsc, sc = study
    got = ReferenceEngine().run(sc)
    want = RefReferenceEngine().run(rsc)
    assert got.shape == want.shape and got.engine == "reference"
    for f in COMPARED:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    for key, r in want.sim_results.items():
        assert_same_sim(got.sim_results[key], r)
    assert got.timings.engine == "reference"


def test_parity_torch_engine_against_the_port_reference(study):
    _, sc = study
    report = assert_parity(sc, TorchEngine(device="cpu"))
    assert report.ok and "parity OK" in str(report)
    # every field but cost is ==; cost differs from the compensated sum() by ulps at most
    ref, cand = report.reference, report.candidate
    for f in COMPARED:
        if f != "cost":
            np.testing.assert_array_equal(getattr(cand, f), getattr(ref, f), err_msg=f)
    assert (np.abs(cand.cost - ref.cost) <= COST_RTOL * np.abs(ref.cost)).all()
    assert compare_engines(sc, "auto", device="cpu").ok


def test_parity_reports_a_mismatch(study):
    _, sc = study
    ref = ReferenceEngine(keep_runs=False).run(sc)
    cand = run(sc, device="cpu")
    cand.n_checkpoints[0, 1, 2] += 1
    report = compare_results(sc, ref, cand)
    assert not report.ok and [m.field for m in report.mismatches] == ["n_checkpoints"]
    assert "parity FAILED" in str(report)
    with pytest.raises(AssertionError, match="parity FAILED"):
        assert_parity(sc, _Fixed(cand))


class _Fixed:
    name = "fixed"

    def __init__(self, res):
        self.res = res

    def run(self, scenario):
        return self.res


def test_get_engine_reference_runs_on_the_host():
    assert isinstance(get_engine("reference"), ReferenceEngine)
    assert isinstance(get_engine("reference", device="cpu"), ReferenceEngine)
    with pytest.raises(ValueError, match="host"):
        get_engine("reference", device="cuda")


# ---------------------------------------------------------------------------
# the paper's claims, through the port's engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ensemble():
    res = run(policy_compare.ensemble_study(), device="cpu")
    return res, policy_compare.summarize(res)


def test_policy_compare_matches_the_scalar_example(ensemble):
    """The engine's ensemble gives the example's means: time exactly, cost
    within COST_RTOL (the example sums each job with ``sum()``)."""
    res, agg = ensemble
    it = R.get_instance("m1.xlarge", "eu-west-1")
    rtraces = [R.shift_trace(R.synthetic_trace(it, horizon_days=45, seed=100 + s), off * 3600.0)
               for s in range(4) for off in (0, 11, 23)]
    for scheme in ALL_SCHEMES:
        cost, t = [], []
        for bid in res.bids:
            for tr in rtraces:
                r = R.simulate(tr, R.Scheme(scheme.value), 500 * 60.0, float(bid))
                if r.completed:
                    cost.append(r.cost)
                    t.append(r.completion_time / 60)
        assert agg[scheme][1] == float(np.mean(t))
        assert abs(agg[scheme][0] - float(np.mean(cost))) <= COST_RTOL * float(np.mean(cost))
    table = policy_compare.table(agg)
    assert "acc" in table and "+5.94%" in table


def test_acc_cost_close_to_opt(ensemble):
    agg = ensemble[1]
    rel = agg[Scheme.ACC][0] / agg[Scheme.OPT][0] - 1.0
    assert 0.0 <= rel < 0.15


def test_acc_faster_than_opt(ensemble):
    agg = ensemble[1]
    assert agg[Scheme.ACC][1] < agg[Scheme.OPT][1]


def test_acc_beats_all_realistic_schemes(ensemble):
    agg = ensemble[1]
    for s in (Scheme.HOUR, Scheme.EDGE, Scheme.ADAPT, Scheme.NONE):
        assert agg[Scheme.ACC][0] < agg[s][0] and agg[Scheme.ACC][1] < agg[s][1], s


def test_acc_cost_time_product_near_or_below_opt(ensemble):
    agg = ensemble[1]
    rel = (agg[Scheme.ACC][0] * agg[Scheme.ACC][1]) / (agg[Scheme.OPT][0] * agg[Scheme.OPT][1]) - 1.0
    assert rel < 0.08


def test_none_is_catastrophic(ensemble):
    agg = ensemble[1]
    assert agg[Scheme.NONE][0] > 2.0 * agg[Scheme.OPT][0] and agg[Scheme.NONE][1] > 2.0 * agg[Scheme.OPT][1]
