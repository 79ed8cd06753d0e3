"""ACC in the port's sweep, on the CPU, against the JAX package.

ACC is the paper's scheme: bid-unlimited leases, hour-boundary checkpoint /
terminate decisions, poll-driven relaunch.  The port walks it as a lockstep
torch loop (``repro_torch.engine.batch._run_acc``) beside the fused sweep of
the other five schemes.  Every comparison here is exact: the step body
against ``repro.engine.kernels.acc_lease_tick``, the cursor and boundary
searches against the reference's loop and count forms, and whole studies
against ``repro``'s batch engine on all 7 compared fields, ``cost``
included (both fold a cell's runs left to right with the same host biller).
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import obs as ref_obs
from repro.core import PriceTrace as RefPriceTrace
from repro.core import Scheme as RefScheme
from repro.core import SimParams as RefSimParams
from repro.core import catalog as ref_catalog
from repro.core import get_instance as ref_get_instance
from repro.core import synthetic_trace as ref_synthetic_trace
from repro.engine import Scenario as RefScenario
from repro.engine import run as ref_run
from repro.engine.kernels import acc_lease_tick as ref_acc_lease_tick

from repro_torch import obs
from repro_torch.core import HOUR, Scheme, SimParams, catalog, get_instance, synthetic_trace
from repro_torch.engine import ALL_SCHEMES, COMPARED, Scenario, run
from repro_torch.engine.batch import _advance_cursor, _boundaries_at_or_before, _run_acc, grid_and_tables
from repro_torch.engine.kernels import acc_lease_tick
from repro_torch.kernels.spot_sweep import kernel, ref

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ref_study(sc: Scenario) -> RefScenario:
    """The JAX package's study of a port study (generated or explicit market)."""
    canon = sc.canonical()
    params = RefSimParams(**canon["params"])
    schemes = tuple(RefScheme(v) for v in canon["schemes"])
    if sc.traces is not None:
        traces = tuple(RefPriceTrace(times=t.times.copy(), prices=t.prices.copy()) for t in sc.traces)
        return RefScenario(
            work_s=sc.work_s, bids=sc.bids, schemes=schemes, params=params, traces=traces, labels=sc.labels,
            initial_saved_work=sc.initial_saved_work,
        )
    by_name = {it.name: it for it in ref_catalog()}
    return dataclasses.replace(
        RefScenario.grid(
            work_s=canon["work_s"], bids=canon["bids"], instances=[by_name[it["name"]] for it in canon["instances"]],
            schemes=schemes, params=params, horizon_days=canon["horizon_days"], seeds=canon["seeds"],
            bid_fractions=canon["bid_fractions"],
        ),
        initial_saved_work=sc.initial_saved_work,
    )


def assert_equal_results(got, want, fields=COMPARED):
    assert got.shape == want.shape
    for field in fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)


def bits(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int64) if x.dtype == np.float64 else x


# ---------------------------------------------------------------------------
# The step body and the two searches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_acc_lease_tick_matches_jax_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    work_s, t_c = float(rng.uniform(3600, 40 * 3600)), float(rng.choice([60.0, 300.0, 450.0]))
    L = rng.uniform(0, 5 * 86400, n)
    t_h = L + rng.integers(1, 30, n) * 3600.0
    t = t_h - rng.choice([3600.0, 1800.0, t_c, t_c / 2, 0.0, -5.0], n)  # includes seg_end <= t lanes
    work = rng.uniform(0, work_s, n)
    # lanes whose remaining work ends exactly at the segment end (the _EPS test's edge)
    edge = rng.random(n) < 0.2
    work = np.where(edge, work_s - (t_h - t), work)
    sv = work * rng.uniform(0, 1, n)
    live = rng.random(n) < 0.8
    take = live & (rng.random(n) < 0.4)
    term_q = live & (rng.random(n) < 0.3)
    want = ref_acc_lease_tick(np, live, t_h, take, term_q, t, work, sv, work_s, t_c)
    T = torch.from_numpy
    got = acc_lease_tick(T(live), T(t_h), T(take), T(term_q), T(t), T(work), T(sv), work_s, t_c)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w))
    assert want[5].any() and want[6].any() and want[7].any()  # fin, ck and term all occur


def random_rows(rng, n_rows, width, pad):
    """``n_rows`` ascending rows of up to ``width`` values, ``pad``-padded."""
    rows = np.full((n_rows, width), pad)
    counts = rng.integers(0, width, n_rows)
    for r, c in enumerate(counts):
        rows[r, :c] = np.sort(rng.choice(np.arange(0.0, 5000.0, 60.0), c, replace=False))
    return rows, counts


@pytest.mark.parametrize("seed", [0, 1])
def test_seek_searchsorted_equals_the_count_form(seed):
    rng = np.random.default_rng(seed)
    M, nb, W = 7, 5, 40
    Tpad, _ = random_rows(rng, M, W, np.inf)
    Tpad[:, -1] = np.inf  # one inf column past the longest row, as the engine pads
    # times on boundaries, between them, -0.0, beyond the last, and inf
    picks = np.concatenate([Tpad[np.isfinite(Tpad)], rng.uniform(-10, 6000, 50), [-0.0, 0.0, np.inf]])
    ts = rng.choice(picks, M * nb)
    want = (Tpad[np.arange(M * nb) // nb] <= ts[:, None]).sum(axis=1)
    got = _boundaries_at_or_before(torch.from_numpy(Tpad), torch.from_numpy(ts)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_period_cursor_equals_the_reference_walk(seed):
    rng = np.random.default_rng(seed)
    C, P = 60, 12
    B, pcnt = random_rows(rng, C, P, np.nan)
    Bs = np.where(np.isnan(B), np.inf, B)
    idx = np.sort(rng.choice(C, 40, replace=False))  # a compacted lane set
    ptr = np.minimum(rng.integers(0, P, 40), pcnt[idx])
    for _ in range(5):  # successive queries, as the engine makes them
        mask = rng.random(40) < 0.7
        tq = rng.choice(np.concatenate([Bs[np.isfinite(Bs)], rng.uniform(0, 6000, 30)]), 40)
        want = ptr.copy()
        while True:  # repro.engine.batch._run_acc's admissible walk
            pc = np.minimum(want, P - 1)
            mv = mask & (want < pcnt[idx]) & (B[idx, pc] <= tq)
            if not mv.any():
                break
            want[mv] += 1
        tq_cells = np.zeros(C)
        tq_cells[idx] = tq
        got = _advance_cursor(
            torch.from_numpy(Bs), torch.from_numpy(idx), torch.from_numpy(ptr), torch.from_numpy(pcnt[idx]),
            torch.from_numpy(mask), torch.from_numpy(tq_cells),
        ).numpy()
        np.testing.assert_array_equal(got, want)
        ptr = got


# ---------------------------------------------------------------------------
# Whole studies against repro's batch engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["synthetic", "resume_extreme_bids", "step_trace_edges", "golden_grid"])
def test_six_scheme_small_studies_match_batch(smoke, name):
    sc = smoke.six_schemes(smoke.small_studies()[name])
    got = run(sc, device="cpu")
    want = ref_run(ref_study(sc), "batch")
    assert_equal_results(got, want)
    assert got.by_scheme(Scheme.ACC)["completed"].any()


def test_golden_six_scheme_digest_is_the_reference_result(smoke):
    """``chip_smoke.py`` holds the card's six-scheme golden study against a
    pinned digest; it must be the digest of ``repro``'s batch engine."""
    sc = smoke.six_schemes(smoke.golden_study())
    assert sc.schemes == ALL_SCHEMES and smoke.ACC_FIELDS == COMPARED
    rsc = ref_study(sc)
    assert rsc.canonical() == sc.canonical()
    assert smoke.result_digest(ref_run(rsc, "batch"), COMPARED) == smoke.GOLDEN_ACC_SHA256
    assert smoke.result_digest(run(sc, device="cpu"), COMPARED) == smoke.GOLDEN_ACC_SHA256


def random_study(k: int) -> Scenario:
    """A seeded random six-scheme study: 1-3 linux types, random bid
    fractions, t_c, t_r, ADAPT interval, poll, work, initial saved work and a
    1-10 day horizon."""
    rng = np.random.default_rng(1000 + k)
    linux = [it for it in catalog() if it.os == "linux"]
    inst = [linux[i] for i in rng.choice(len(linux), rng.integers(1, 4), replace=False)]
    bids = sorted(set(np.round(rng.uniform(0.45, 0.7, rng.integers(1, 6)), 4).tolist()))
    work = float(rng.uniform(1, 40)) * HOUR
    params = SimParams(
        t_c=float(rng.choice([60.0, 300.0, 450.0, 900.0])), t_r=float(rng.choice([0.0, 300.0, 600.0, 900.0])),
        adapt_interval_s=float(rng.choice([600.0, 900.0, 1200.0])), poll_s=float(rng.choice([60.0, 137.0, 300.0])),
    )
    sc = Scenario.grid(
        work_s=work, bids=bids, instances=inst, schemes=ALL_SCHEMES, params=params,
        horizon_days=float(rng.integers(1, 11)), seeds=tuple(int(s) for s in rng.integers(0, 100, rng.integers(1, 3))),
        bid_fractions=True,
    )
    isw = float(rng.uniform(0, 0.5 * work)) if rng.random() < 0.5 else 0.0
    return dataclasses.replace(sc, initial_saved_work=isw)


@pytest.mark.parametrize("k", range(40))
def test_random_studies_match_batch(k):
    sc = random_study(k)
    assert_equal_results(run(sc, device="cpu"), ref_run(ref_study(sc), "batch"))


def test_default_schemes_of_from_trace_run_and_match_batch():
    tr = synthetic_trace(get_instance("m1.xlarge"), 12, seed=3)
    sc = Scenario.from_trace(tr, 20 * HOUR, [0.40, 0.41, 0.42, 0.45, 5.0])
    assert sc.schemes == ALL_SCHEMES
    rsc = RefScenario.from_trace(
        ref_synthetic_trace(ref_get_instance("m1.xlarge"), 12, seed=3), 20 * HOUR, [0.40, 0.41, 0.42, 0.45, 5.0]
    )
    got = run(sc, device="cpu")
    assert_equal_results(got, ref_run(rsc, "batch"))
    acc = got.by_scheme(Scheme.ACC)
    assert acc["n_self_terminations"].sum() > 0 and (acc["n_kills"] == 0).all()


def test_acc_alone_launches_no_sweep(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a scheme set of ACC alone must not reach the sweep")

    monkeypatch.setattr(kernel, "spot_sweep", refuse)
    monkeypatch.setattr(ref, "sweep_plain", refuse)
    sc = Scenario.grid(
        work_s=20 * HOUR, bids=[0.5, 0.55, 0.6], instances=[get_instance("m1.xlarge"), get_instance("c1.medium")],
        schemes=(Scheme.ACC,), horizon_days=6.0, seeds=(0, 1), bid_fractions=True,
    )
    before = kernel.launches
    got = run(sc, device="cpu")
    assert kernel.launches == before
    assert_equal_results(got, ref_run(ref_study(sc), "batch"))
    assert got.timings.impl == "torch" and set(got.timings.per_scheme) == {"acc"}


def test_acc_span_and_compaction_counter_match_the_reference():
    sc = Scenario.grid(
        work_s=24 * HOUR, bids=[round(0.50 + 0.01 * i, 2) for i in range(11)],
        instances=catalog()[::16],
        schemes=ALL_SCHEMES, horizon_days=10.0, seeds=(0, 1), bid_fractions=True,
    )
    with obs.Telemetry() as tel:
        got = run(sc, device="cpu")
    with ref_obs.Telemetry() as rtel:
        want = ref_run(ref_study(sc), "batch")
    assert_equal_results(got, want)
    assert tel.counter("acc.compactions") == rtel.counter("acc.compactions") > 0
    sims = [s for s in tel.spans[0].find("sim")]
    assert [s.attrs for s in sims] == [{"scheme": "acc", "impl": "torch"}, {"impl": "plain"}]
    assert tel.counter("engine.cells") == got.n_cells


def test_run_acc_returns_every_field_and_no_kills():
    sc = Scenario.grid(
        work_s=10 * HOUR, bids=[0.45, 0.55], instances=[get_instance("m1.large")], schemes=(Scheme.ACC,),
        horizon_days=4.0, seeds=(2,), bid_fractions=True,
    )
    grid, _ = grid_and_tables(sc, sc.materialize(), False)
    out = _run_acc(grid, sc, "cpu")
    assert set(out) == {"completed", "completion_time", "cost", "n_checkpoints", "n_kills", "work_lost_s",
                        "n_self_terminations"}
    assert all(isinstance(v, np.ndarray) and v.shape == (2,) for v in out.values())
    assert (out["n_kills"] == 0).all()
