"""The port's step bodies (``repro_torch.engine.kernels``) against ``repro``'s.

Each torch float64 body runs on the CPU on the same random inputs, made from
a numpy seed and including ``inf`` and NaN lanes, as
:mod:`repro.engine.kernels` called with ``xp=numpy``.  Every comparison is
exact (``assert_array_equal``; NaN lanes must be NaN on both sides): all the
arithmetic is IEEE float64 + − × ÷ and compares in the same association
order, so there is nothing to round differently.  The ADAPT survival tables
(host NumPy) are compared the same way.
"""

import numpy as np
import pytest
import torch

from repro.core import catalog as ref_catalog
from repro.engine import Scenario as RefScenario
from repro.engine import kernels as rk
from repro.engine.batch import _PeriodGrid as RefGrid
from repro.core.schemes import Scheme as RefScheme

from repro_torch.core.schemes import Scheme
from repro_torch.engine import Scenario
from repro_torch.engine import kernels as tk
from repro_torch.engine.batch import _PeriodGrid

# the inf / NaN lanes make NumPy warn about the invalid operations they are there for
pytestmark = pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")

N = 257
WORK_S = 20 * 3600.0
T_C, T_R, INTERVAL = 300.0, 600.0, 600.0


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_same(ref, port, name=""):
    if isinstance(ref, tuple):
        assert len(ref) == len(port)
        for i, (r, p) in enumerate(zip(ref, port)):
            assert_same(r, p, f"{name}[{i}]")
        return
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype, name
    np.testing.assert_array_equal(port, ref, err_msg=name)


def with_specials(rng, x):
    """Put ``inf``, ``-inf`` and NaN into a few random lanes of ``x``."""
    x = x.copy()
    lanes = rng.choice(len(x), size=12, replace=False)
    x[lanes[:4]] = np.inf
    x[lanes[4:6]] = -np.inf
    x[lanes[6:]] = np.nan
    return x


def period_inputs(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 2e6, N)
    b = a + rng.choice([rng.uniform(0.0, 500.0), 1.0], N) * rng.uniform(0.0, 3e4, N)
    b = with_specials(rng, b)
    start_work = a + T_R
    saved = with_specials(rng, rng.uniform(0.0, WORK_S, N))
    return rng, a, b, start_work, saved


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_none_and_opt(seed):
    _, _, b, start_work, saved = period_inputs(seed)
    assert_same(
        rk._kernel_none(np, b, start_work, saved, WORK_S),
        tk._kernel_none(T(b), T(start_work), T(saved), WORK_S),
        "none",
    )
    assert_same(
        rk._kernel_opt(np, b, start_work, saved, WORK_S, T_C),
        tk._kernel_opt(T(b), T(start_work), T(saved), WORK_S, T_C),
        "opt",
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_windows_advance(seed):
    rng, a, b, start_work, saved = period_inputs(seed)
    s = with_specials(rng, start_work + rng.uniform(-100.0, 4e4, N))
    window = rng.random(N) < 0.7
    state = (
        saved,
        start_work + rng.uniform(0.0, 100.0, N),
        saved - rng.uniform(0.0, 10.0, N),
        rng.random(N) < 0.1,
        with_specials(rng, np.full(N, np.nan)),
        rng.integers(0, 5, N),
        rng.random(N) < 0.8,
    )
    ref = rk.windows_advance(np, s, window, state, WORK_S, T_C, b)
    port = tk.windows_advance(T(s), T(window), tuple(T(x) for x in state), WORK_S, T_C, T(b))
    assert_same(ref[0], port[0], "window")
    assert_same(ref[1], port[1], "state")


@pytest.mark.parametrize("scheme", ["none", "opt"])
@pytest.mark.parametrize("seed", [0, 1])
def test_period_step_masked(scheme, seed):
    rng, a, b, _, saved = period_inputs(seed)
    valid = rng.random(N) < 0.85
    a = np.where(valid, a, np.nan)
    b = np.where(valid, b, np.nan)
    horizon = np.where(rng.random(N) < 0.2, b, 2.6e6)
    state = (
        saved,
        rng.random(N) < 0.2,
        np.where(rng.random(N) < 0.5, np.inf, rng.uniform(0, 2e6, N)),
        rng.integers(0, 9, N),
        rng.uniform(0, 1e5, N),
        rng.random(N) < 0.5,
        rng.integers(0, 9, N),
    )
    if scheme == "none":
        def ref_run(go, a_, b_, sw, sv):
            return rk._kernel_none(np, b_, sw, sv, WORK_S)

        def port_run(go, a_, b_, sw, sv):
            return tk._kernel_none(b_, sw, sv, WORK_S)
    else:
        def ref_run(go, a_, b_, sw, sv):
            return rk._kernel_opt(np, b_, sw, sv, WORK_S, T_C)

        def port_run(go, a_, b_, sw, sv):
            return tk._kernel_opt(b_, sw, sv, WORK_S, T_C)

    ref = rk.period_step_masked(
        np, RefScheme(scheme), state, a, b, valid, horizon, T_R, ref_run
    )
    port = tk.period_step_masked(
        Scheme(scheme), tuple(T(x) for x in state), T(a), T(b), T(valid), T(horizon), T_R, port_run
    )
    assert_same(ref, port, scheme)


def small_grid_scenario(bid_fractions):
    types = [it for it in ref_catalog() if it.os == "linux"][:3]
    kwargs = dict(bids=(0.5, 0.55, 0.6) if bid_fractions else (0.33, 0.36, 0.40))
    return RefScenario.grid(
        work_s=10 * 3600.0, instances=types, horizon_days=12.0, seeds=(0, 1),
        bid_fractions=bid_fractions, **kwargs,
    )


@pytest.mark.parametrize("bid_fractions", [False, True])
def test_adapt_tables_match_reference(bid_fractions):
    """The grid-vectorized tables (and the one-cell-at-a-time build) equal
    ``repro``'s, float for float."""
    rsc = small_grid_scenario(bid_fractions)
    sc = Scenario.from_reference(rsc.canonical())
    rm, m = rsc.materialize(), sc.materialize()
    ref = rk.AdaptTables.build(rm, rsc, RefGrid.build(rm, rsc))
    for port in (tk.AdaptTables.build(m, sc, _PeriodGrid.build(m, sc)), tk.AdaptTables.build(m, sc)):
        np.testing.assert_array_equal(port.flat, ref.flat)
        np.testing.assert_array_equal(port.off, ref.off)
        np.testing.assert_array_equal(port.top, ref.top)
        assert (port.bin_s, port.n_bins) == (ref.bin_s, ref.n_bins)


def adapt_inputs(seed):
    rng = np.random.default_rng(seed)
    rsc = small_grid_scenario(True)
    rm = rsc.materialize()
    tab = rk.AdaptTables.build(rm, rsc, RefGrid.build(rm, rsc))
    cells = rng.integers(0, len(tab.off), N)
    off, top = tab.off[cells], tab.top[cells]
    a = rng.uniform(0.0, 2e6, N)
    # ages up to twice the 7-day table range, so the censored tail is read too
    t = a + rng.uniform(0.0, 2 * tab.n_bins * tab.bin_s, N)
    b = t + rng.uniform(-50.0, 4e3, N)
    work = with_specials(rng, rng.uniform(0.0, WORK_S, N))
    sv = work - rng.uniform(0.0, 5e4, N)
    next_dec = np.where(rng.random(N) < 0.1, np.inf, t + rng.uniform(0.0, INTERVAL, N))
    return rng, tab, off, top, a, t, b, work, sv, next_dec


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_survival_and_adapt_decision(seed):
    rng, tab, off, top, a, t, _, work, sv, _ = adapt_inputs(seed)
    k = rng.integers(0, 2 * tab.n_bins, N)
    assert_same(
        rk._survival_at(np, k, tab.flat, off, top, tab.n_bins),
        tk._survival_at(T(k), T(tab.flat), T(off), T(top), tab.n_bins),
        "survival",
    )
    age = t - a
    unsaved = work - sv
    for t_c in (T_C, 0.0, np.inf):
        assert_same(
            rk.adapt_decision(np, age, unsaved, tab.flat, off, top, tab.bin_s, tab.n_bins, t_c, T_R, INTERVAL),
            tk.adapt_decision(T(age), T(unsaved), T(tab.flat), T(off), T(top), tab.bin_s, tab.n_bins, t_c, T_R, INTERVAL),
            f"decision t_c={t_c}",
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adapt_tick_core_and_tick(seed):
    rng, tab, off, top, a, t, b, work, sv, next_dec = adapt_inputs(seed)
    live = rng.random(N) < 0.8
    consts = (WORK_S, T_C, T_R, INTERVAL)
    ref = rk.adapt_tick_core(
        np, live, t, work, sv, next_dec, a, b, *consts, tab.flat, off, top, tab.bin_s, tab.n_bins
    )
    port = tk.adapt_tick_core(
        T(live), T(t), T(work), T(sv), T(next_dec), T(a), T(b), *consts,
        T(tab.flat), T(off), T(top), tab.bin_s, tab.n_bins,
    )
    assert_same(ref, port, "adapt_tick_core")

    state = (live, t, work, sv, next_dec, rng.random(N) < 0.1, np.full(N, np.nan), rng.integers(0, 3, N))
    ref = rk.adapt_tick(np, state, a, b, *consts, tab.flat, off, top, tab.bin_s, tab.n_bins)
    port = tk.adapt_tick(
        tuple(T(x) for x in state), T(a), T(b), *consts, T(tab.flat), T(off), T(top), tab.bin_s, tab.n_bins
    )
    assert_same(ref, port, "adapt_tick")
