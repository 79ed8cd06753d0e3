"""Grid evaluation: period grid, ADAPT tables, and host-side billing.

:func:`run_batched` materializes a scenario's market, builds the padded
``(cells, periods)`` availability grid and the ADAPT survival tables on the
host (NumPy), hands the whole scheme set to one ``run_schemes`` call (the
fused spot sweep on a torch device), and folds the per-period run records
through the host biller :func:`_bill_runs_flat`.

The flattened cell axis is ``c = m * n_bids + b`` (markets major).  Billing
stays on the host in NumPy: runs are sorted by (cell, period) and
``np.add.at`` adds each cell's run costs left to right, in chronological
order, exactly as :func:`repro.engine.batch._bill_runs_flat` does — so
``cost`` is bit-identical to ``repro``'s batch and jax engines.

ACC is not part of this package yet and raises :class:`NotImplementedError`.
"""

from __future__ import annotations

import time
import weakref

import numpy as np

from repro_torch.core.schemes import Scheme
from repro_torch.engine.base import EngineResult, PhaseTimings, empty_result, fold_result_counters
from repro_torch.engine.kernels import AdaptTables
from repro_torch.engine.scenario import BID_LIMITED_SCHEMES, MarketCell, Scenario
from repro_torch.obs import telemetry as obs

#: Per-scenario cache of the derived simulation inputs (period grid, ADAPT
#: decision tables): re-running the same Scenario object builds them once.
#: Keys are weak — the cache dies with the scenario.
_SCENARIO_CACHE: "weakref.WeakKeyDictionary[Scenario, dict]" = weakref.WeakKeyDictionary()


def grid_and_tables(
    scenario: Scenario, markets: list[MarketCell], need_adapt: bool
) -> tuple["_PeriodGrid", AdaptTables | None]:
    """The (cached) period grid + ADAPT tables for a scenario.

    Both are pure functions of the scenario (materialization is
    deterministic), so one build serves every re-run in the process."""
    tel = obs.current()
    entry = _SCENARIO_CACHE.setdefault(scenario, {})
    if "grid" not in entry:
        with tel.span("grid.periods"):
            entry["grid"] = _PeriodGrid.build(markets, scenario)
    if need_adapt and "tables" not in entry:
        with tel.span("grid.adapt_tables"):
            entry["tables"] = AdaptTables.build(markets, scenario, entry["grid"])
    return entry["grid"], entry.get("tables")


def run_batched(scenario: Scenario, engine_name: str, run_schemes) -> EngineResult:
    """Evaluate a scenario through ``run_schemes(schemes, grid, scenario,
    adapt_tables)``, one call for the whole scheme set.

    Every phase is timed as a telemetry span (``grid`` / ``sim`` / ``bill``
    under one ``engine.run`` root); the span tree lands in the active
    :class:`~repro_torch.obs.telemetry.Telemetry` collector when there is
    one — a throwaway local collector otherwise — and is folded into the
    typed :class:`~repro_torch.engine.base.PhaseTimings` on
    ``EngineResult.timings`` either way.  ``run_schemes`` returns ``(outs,
    info)``: per-scheme output dicts plus a small dict (the ``impl`` label).
    """
    unported = [s.value for s in scenario.schemes if s not in BID_LIMITED_SCHEMES]
    if unported:
        raise NotImplementedError(
            f"schemes {unported} are not ported yet; pass schemes=BID_LIMITED_SCHEMES"
        )
    markets = scenario.materialize()
    amb = obs.current()
    tel = amb if amb.enabled else obs.Telemetry()  # local phase recorder
    t0 = time.perf_counter()  # wall_s measures simulation, not trace gen
    res = empty_result(scenario, markets, engine_name)

    with obs.activate(tel), tel.span("engine.run", engine=engine_name) as root:
        with tel.span("grid"):
            grid, adapt_tables = grid_and_tables(scenario, markets, Scheme.ADAPT in scenario.schemes)
        outs, _info = run_schemes(tuple(scenario.schemes), grid, scenario, adapt_tables)
        M, B = len(markets), len(scenario.bids)
        for scheme, out in outs.items():
            s = scenario.schemes.index(scheme)
            res.completed[:, :, s] = out["completed"].reshape(M, B)
            res.completion_time[:, :, s] = out["completion_time"].reshape(M, B)
            res.cost[:, :, s] = out["cost"].reshape(M, B)
            res.n_checkpoints[:, :, s] = out["n_checkpoints"].reshape(M, B)
            res.n_kills[:, :, s] = out["n_kills"].reshape(M, B)
            res.work_lost_s[:, :, s] = out["work_lost_s"].reshape(M, B)

    res.wall_s = time.perf_counter() - t0
    res.timings = PhaseTimings.from_span(root, engine_name, res.wall_s)
    if amb.enabled:
        fold_result_counters(amb, res)
    return res


# ---------------------------------------------------------------------------
# Period grid: padded (cells, periods) SoA view of availability
# ---------------------------------------------------------------------------


class _PeriodGrid:
    """Flattened cell axis ``c = m * n_bids + b`` with padded period arrays.

    ``A[c, p]`` / ``B[c, p]`` are the start/end of cell ``c``'s ``p``-th
    availability period (NaN pad), ``valid[c, p]`` marks real periods,
    ``horizon[c]`` is the owning trace's horizon.
    """

    def __init__(self, markets, bids, A, B, valid, horizon):
        self.markets = markets
        self.bids = bids
        self.A = A
        self.B = B
        self.valid = valid
        self.horizon = horizon
        self.n_markets = len(markets)
        self.n_bids = len(bids)
        self.n_cells = A.shape[0]
        # lazy EDGE support: (per-market edge arrays, flat, base, counts)
        self._edges: tuple | None = None
        self._edge_ptr0: np.ndarray | None = None

    @staticmethod
    def build(markets: list[MarketCell], scenario: Scenario) -> "_PeriodGrid":
        per_market = [
            _periods_all_bids(cellm.trace, scenario.market_bids(cellm)) for cellm in markets
        ]
        counts = np.concatenate([c for _, _, c in per_market])
        C = len(counts)
        P = max(int(counts.max()), 1) if C else 1
        A = np.full((C, P), np.nan)
        B = np.full((C, P), np.nan)
        valid = np.zeros((C, P), dtype=bool)
        row0 = 0
        for a_flat, b_flat, cnt in per_market:
            n = len(cnt)
            if a_flat.size:
                # row-major flat (cell, period-within-cell) scatter
                rows = np.repeat(np.arange(n), cnt)
                cols = np.arange(len(a_flat)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
                A[row0 + rows, cols] = a_flat
                B[row0 + rows, cols] = b_flat
                valid[row0 + rows, cols] = True
            row0 += n
        horizon = np.repeat([m.trace.horizon for m in markets], len(scenario.bids))
        return _PeriodGrid(markets, tuple(scenario.bids), A, B, valid, horizon)

    def edges(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(edges_flat, base_of_market, n_edges_of_market) for EDGE windows."""
        if self._edges is None:
            per_market = [m.trace.rising_edges().astype(np.float64) for m in self.markets]
            n = np.asarray([len(e) for e in per_market], dtype=np.int64)
            base = np.concatenate(([0], np.cumsum(n)[:-1]))
            # keep at least one element: masked gathers index 0 unconditionally
            flat = np.concatenate(per_market) if n.sum() else np.zeros(1)
            self._edges = (per_market, flat, base, n)
        _, flat, base, n = self._edges
        return flat, base, n

    def edge_ptr0(self, t_r: float) -> np.ndarray:
        """(cells, periods) cursor table: index of the first rising edge
        strictly after each period's ``start_work = A + t_r`` (one
        ``searchsorted`` per market; NaN pads sort past every edge)."""
        if self._edge_ptr0 is None:
            self.edges()
            per_market = self._edges[0]
            ptr = np.empty(self.A.shape, dtype=np.int64)
            for m, sl in self.market_slices():
                block = self.A[sl] + t_r
                ptr[sl] = np.searchsorted(per_market[m], block.ravel(), side="right").reshape(
                    block.shape
                )
            self._edge_ptr0 = ptr
        return self._edge_ptr0

    def market_slices(self):
        """Contiguous cell ranges per market (cells are market-major)."""
        for m in range(self.n_markets):
            yield m, slice(m * self.n_bids, (m + 1) * self.n_bids)


def _periods_all_bids(trace, bids) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized ``available_periods`` for every bid at once.

    Returns ``(starts_flat, ends_flat, counts)``: period start/end times
    concatenated bid-major (periods of bid 0, then bid 1, ...), chronological
    within each bid, plus the per-bid period count.  Values are read from
    ``trace.times`` exactly as ``PriceTrace.available_periods`` does, so the
    floats are identical.
    """
    bids_arr = np.asarray(bids, dtype=np.float64)
    ok = trace.prices[None, :] <= bids_arr[:, None]  # (B, N)
    Bn, N = ok.shape
    d = np.diff(ok.astype(np.int8), axis=1)
    rs, cs = np.nonzero(d == 1)
    re_, ce = np.nonzero(d == -1)
    # prepend col-0 starts / append col-N ends for bids available at the rims
    first = np.nonzero(ok[:, 0])[0]
    last = np.nonzero(ok[:, -1])[0]
    start_rows = np.concatenate([rs, first])
    start_cols = np.concatenate([cs + 1, np.zeros(len(first), dtype=np.int64)])
    end_rows = np.concatenate([re_, last])
    end_cols = np.concatenate([ce + 1, np.full(len(last), N, dtype=np.int64)])
    so = np.lexsort((start_cols, start_rows))
    eo = np.lexsort((end_cols, end_rows))
    counts = np.bincount(start_rows, minlength=Bn)
    return trace.times[start_cols[so]], trace.times[end_cols[eo]], counts


# ---------------------------------------------------------------------------
# Billing — vectorized bill_run with hour-order cost accumulation
# ---------------------------------------------------------------------------


def _bill_runs_flat(
    grid: _PeriodGrid,
    p_all: np.ndarray,
    cells: np.ndarray,
    launch: np.ndarray,
    end: np.ndarray,
    user: np.ndarray,
    delta: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Bill every recorded run and fold into per-cell totals.

    Runs arrive as flat parallel arrays (one entry per billed instance run,
    in any order — a cell records at most one run per period, which is what
    makes order irrelevant here).  Each instance-hour is charged at the
    price in effect at its start; the final partial hour is free on an
    out-of-bid kill and charged on a user termination.  Within a run, hour
    prices accumulate in hour order, and across a cell's runs costs
    accumulate in period (= chronological) order, each as a plain
    left-to-right ``np.add.at`` fold.  Also derives ``n_kills``
    (non-user-terminated recorded runs).
    """
    C = grid.A.shape[0]
    total = np.zeros(C)
    n_kills = np.zeros(C, dtype=np.int64)
    if len(cells) == 0:
        return total, n_kills
    m_of = cells // grid.n_bids

    run_cost = np.zeros(len(cells))
    for m in np.unique(m_of):
        sel = np.nonzero(m_of == m)[0]
        tr = grid.markets[m].trace
        l_m, e_m, u_m = launch[sel], end[sel], user[sel]
        # int(math.ceil((end - launch) / Δ - 1e-12))
        n_hours = np.ceil((e_m - l_m) / delta - 1e-12).astype(np.int64)
        Q = int(n_hours.sum())
        if Q == 0:
            continue
        # one flat (run, hour) query batch: run-major, hours ascending
        run_of_q = np.repeat(np.arange(len(sel)), n_hours)
        hour_of_q = np.arange(Q) - np.repeat(np.cumsum(n_hours) - n_hours, n_hours)
        start = l_m[run_of_q] + hour_of_q * delta  # launch + k * Δ
        seg = np.searchsorted(tr.times, start, side="right") - 1
        seg = np.clip(seg, 0, len(tr.prices) - 1)
        price = tr.prices[seg]
        full = (start + delta) <= (e_m[run_of_q] + 1e-9)
        charged = full | u_m[run_of_q]
        rc = np.zeros(len(sel))
        # np.add.at accumulates sequentially in query order = hour order
        np.add.at(rc, run_of_q[charged], price[charged])
        run_cost[sel] = rc

    np.add.at(n_kills, cells[~user], 1)
    # sorting runs by (cell, period) and letting np.add.at accumulate
    # sequentially in that order gives each cell's chronological
    # left-to-right cost sum
    order = np.lexsort((p_all, cells))
    np.add.at(total, cells[order], run_cost[order])
    return total, n_kills
