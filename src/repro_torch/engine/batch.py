"""Grid evaluation: period grid, ADAPT tables, ACC's lease walk, host billing.

:func:`run_batched` materializes a scenario's market, builds the padded
``(cells, periods)`` availability grid and the ADAPT survival tables on the
host (NumPy), hands the whole scheme set to one ``run_schemes`` call (the
fused spot sweep on a torch device for the five bid-limited schemes,
:func:`_run_acc` for ACC), and folds the run records through the host biller
:func:`_bill_runs_flat`.

The flattened cell axis is ``c = m * n_bids + b`` (markets major).  Billing
stays on the host in NumPy: runs are sorted by (cell, period) and
``np.add.at`` adds each cell's run costs left to right, in chronological
order, exactly as :func:`repro.engine.batch._bill_runs_flat` does — so
``cost`` is bit-identical to ``repro``'s batch and jax engines.

ACC (:func:`_run_acc`) is not period-structured: it is a lockstep seek /
lease state machine over poll and hour ticks, in torch float64 on the
engine's device, whose run records come back to the host once for the same
biller.
"""

from __future__ import annotations

import time
import weakref

import numpy as np
import torch

from repro_torch.core.schemes import Scheme
from repro_torch.engine.base import EngineResult, PhaseTimings, empty_result, fold_result_counters
from repro_torch.engine.kernels import _EPS, AdaptTables, acc_lease_tick
from repro_torch.engine.scenario import MarketCell, Scenario
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
            if "n_self_terminations" in out:
                res.n_self_terminations[:, :, s] = out["n_self_terminations"].reshape(M, B)

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
# ACC: lockstep seek / lease state machine over poll and hour ticks
# ---------------------------------------------------------------------------


def _acc_arrays(grid: _PeriodGrid, device: torch.device) -> dict:
    """ACC's device copies of the grid, memoized on the grid object (which
    :func:`grid_and_tables` keeps per scenario).

    ``Bs`` is ``B`` with its NaN pads set to ``inf``, so each row is
    ascending and :func:`torch.searchsorted` counts a row's period ends at or
    before a time; ``Tpad`` holds each market's segment boundaries padded with
    ``inf`` (one column more than the longest trace), the vectorized
    ``trace.next_change``."""
    cache = grid.__dict__.setdefault("_acc_device", {})
    key = str(device)
    if key not in cache:
        tlists = [m.trace.times for m in grid.markets]
        Tpad = np.full((grid.n_markets, max(len(tt) for tt in tlists) + 1), np.inf)
        for m_i, tt in enumerate(tlists):
            Tpad[m_i, : len(tt)] = tt

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x)).to(device)

        cache[key] = {
            "A": put(grid.A),
            "B": put(grid.B),
            "Bs": put(np.where(grid.valid, grid.B, np.inf)),
            "pcnt": put(grid.valid.sum(axis=1).astype(np.int64)),
            "horizon": put(grid.horizon.astype(np.float64)),
            "Tpad": put(Tpad),
        }
    return cache[key]


def _advance_cursor(Bs, idx, ptr, pcnt, mask, tq_cells):
    """Move each masked lane's period cursor past the periods that end at or
    before its query time; the others keep theirs.

    The reference walks ``ptr`` forward one period at a time while ``ptr <
    pcnt`` and ``B[ptr] <= tq``.  A cell's period ends ascend (``Bs`` pads
    them with ``inf``), so the walk stops at the count of ends at or before
    ``tq`` (at most ``pcnt``), or where it was if that is further on: one
    :func:`torch.searchsorted` over the cell axis (``tq_cells`` holds each
    lane's query at its cell, ``idx`` the lanes' cells).
    """
    ends_before = torch.searchsorted(Bs, tq_cells.unsqueeze(1), right=True).squeeze(1)[idx]
    return torch.where(mask, torch.maximum(ptr, torch.minimum(ends_before, pcnt)), ptr)


def _boundaries_at_or_before(Tpad, ts_cells):
    """Per cell, the count of its market's segment boundaries at or before
    its time: ``(Tpad[m] <= ts).sum()``, the reference's form, as one
    :func:`torch.searchsorted` (``right=True``) of each market's cells in its
    ascending, ``inf``-padded row (cells are market-major)."""
    M = Tpad.shape[0]
    return torch.searchsorted(Tpad, ts_cells.view(M, -1), right=True).view(-1)


def _run_acc(grid: _PeriodGrid, scenario: Scenario, device) -> dict[str, np.ndarray]:
    """Walk every ACC cell through its lease chain in one lockstep loop on
    ``device`` (the port of :func:`repro.engine.batch._run_acc`).

    ACC (paper §VI) is not period-structured: an instance launches at the
    first admissible poll tick, is never provider-killed, and walks hour
    boundaries to completion, self-termination, or the horizon
    (``simulator._simulate_acc``).  Each lane is one (market, bid) cell in
    one of two modes — *seeking* (the ``_next_launch_time`` poll walk,
    replicated step for step because the visited poll ticks are
    path-dependent float lattice values) or *in-lease* (hour ticks through
    :func:`~repro_torch.engine.kernels.acc_lease_tick`).

    * ``price_at(t) <= a_bid`` iff ``t`` falls inside an availability period
      of the cell, and every lane's queries are monotone in ``t``, so one
      forward-only period cursor per lane answers them (``admissible``,
      :func:`_advance_cursor`).
    * A seek step's next segment boundary is a :func:`torch.searchsorted`
      on the market's boundary row (``right=True``: the count of boundaries
      at or before the tick, as the reference's comparison count).
    * A seeking lane whose cursor has run out of periods is retired at once;
      self-terminated lanes re-enter the seek at ``ceil((t_h + _EPS) / poll
      - _EPS) * poll``; a lease that runs off the horizon is billed over
      ``[launch, horizon)`` as an out-of-bid run, with no work lost.

    Every float expression is the reference's, one torch op each; a division
    takes its divisor as a tensor on the device, since CUDA divides by a
    host scalar through its reciprocal.  The lane state stays on the device;
    the loop reads back only its ``any()`` tests and live counts.  Lanes are
    compacted (``acc.compactions``) once at most half are alive.  The run
    records come back to the host once and go through :func:`_bill_runs_flat`.
    ACC reports ``n_kills = 0`` (never provider-killed).
    """
    dev = torch.device(device)
    params = scenario.params
    work_s = float(scenario.work_s)
    t_r, t_c, t_w = float(params.t_r), float(params.t_c), float(params.t_w)
    delta, poll = float(params.billing_period_s), float(params.poll_s)
    C, P = grid.A.shape
    arr = _acc_arrays(grid, dev)
    A, Bg, Bs, Tpad = arr["A"], arr["B"], arr["Bs"], arr["Tpad"]
    W = Tpad.shape[1]
    f64, i64 = torch.float64, torch.int64
    poll_t = torch.full((), poll, dtype=f64, device=dev)  # divisor on the device

    # global (per-cell) outcomes
    done = torch.zeros(C, dtype=torch.bool, device=dev)
    comp_time = torch.full((C,), np.inf, dtype=f64, device=dev)
    n_ckpt = torch.zeros(C, dtype=i64, device=dev)
    n_term = torch.zeros(C, dtype=i64, device=dev)
    work_lost = torch.zeros(C, dtype=f64, device=dev)
    # run records, one lane-wide entry per recording site and tick:
    # (mask, lease ordinal, cell, launch, end, user)
    records: list[tuple] = []

    # the active lane set (compacted as cells finish)
    idx = torch.arange(C, dtype=i64, device=dev)
    N = C
    m_a = idx // grid.n_bids
    pcnt_a = arr["pcnt"]
    hor_a = arr["horizon"]
    ptr = torch.zeros(N, dtype=i64, device=dev)  # per-lane monotone period cursor
    scratch = torch.zeros(C, dtype=f64, device=dev)

    def at_cells(x):
        """Lane values scattered to the cell axis (other cells: 0.0)."""
        return scratch.index_copy(0, idx, x)

    def admissible(mask, tq):
        nonlocal ptr
        ptr = _advance_cursor(Bs, idx, ptr, pcnt_a, mask, at_cells(tq))
        pc = torch.clamp(ptr, max=P - 1)
        return mask & (ptr < pcnt_a) & (A[idx, pc] <= tq) & (tq < Bg[idx, pc])

    def record(mask, ordn, end, user: bool):
        records.append((mask, ordn, idx, L, end, torch.full_like(mask, user)))

    alive = torch.ones(N, dtype=torch.bool, device=dev)
    sv = torch.full((N,), float(scenario.initial_saved_work), dtype=f64, device=dev)
    L = torch.zeros(N, dtype=f64, device=dev)
    t = torch.zeros(N, dtype=f64, device=dev)
    work = torch.zeros(N, dtype=f64, device=dev)
    kk = torch.ones(N, dtype=i64, device=dev)  # hour index within the current lease
    ordn = torch.zeros(N, dtype=i64, device=dev)
    # immediate launch at t=0 when the opening price already admits the bid;
    # everyone else starts the poll walk from ceil(0/poll - eps) * poll, which
    # is -0.0 (the batch engine's np.ceil keeps the sign)
    adm0 = admissible(alive, torch.zeros(N, dtype=f64, device=dev))
    seeking = ~adm0
    ts = torch.where(seeking, float(np.ceil(0.0 / poll - _EPS) * poll), torch.zeros_like(t))
    work = torch.where(adm0, sv, work)
    t = torch.where(adm0, t_r, t)  # L = 0.0, t = L + t_r

    while bool(alive.any()):
        # -- seek: walk every seeking lane to its launch tick (or retire it)
        seek = alive & seeking
        while bool(seek.any()):
            dead = seek & (ts >= hor_a)
            ok = admissible(seek & ~dead, ts)
            # cursor exhausted: no availability ends after ts — never launches
            dead = dead | (seek & ~dead & ~ok & (ptr >= pcnt_a))
            alive = alive & ~dead
            seek = seek & ~dead
            L = torch.where(ok, ts, L)
            t = torch.where(ok, ts + t_r, t)  # t = L + t_r
            work = torch.where(ok, sv, work)
            kk = torch.where(ok, 1, kk)
            seeking = seeking & ~ok
            seek = seek & ~ok
            # t = max(t + poll, ceil(next_change(t)/poll - eps) * poll)
            j = _boundaries_at_or_before(Tpad, at_cells(ts))[idx]
            # a lane that is not seeking may hold ts = inf (count W); its value is discarded
            nxt = Tpad[m_a, torch.clamp(j, max=W - 1)]
            ts = torch.where(seek, torch.maximum(ts + poll, torch.ceil(nxt / poll_t - _EPS) * poll), ts)

        # -- lease: one hour boundary for every launched lane
        live = alive & ~seeking
        t_h = L + kk.to(f64) * delta
        runoff = live & (t_h > hor_a)
        # lease runs off the horizon: billed OUT_OF_BID over [L, horizon)
        # (full hours charged, partial final hour free), no work_lost
        record(runoff & (hor_a > L), ordn, hor_a, False)
        alive = alive & ~runoff
        live = live & ~runoff

        # Eq. (3)-(4) decision points (schemes.decision_points, inlined)
        t_cd = t_h - t_c - t_w
        t_td = t_h - t_w
        take = live & ~admissible(live, t_cd)
        term_q = live & ~admissible(live, t_td)
        live2, t, work, sv, d_at, fin, ck, term = acc_lease_tick(
            live, t_h, take, term_q, t, work, sv, work_s, t_c
        )
        comp_time[idx] = torch.where(fin, d_at, comp_time[idx])
        done[idx] = done[idx] | fin
        record(fin, ordn, d_at, True)
        alive = alive & ~fin
        n_ckpt[idx] += ck.to(i64)
        record(term, ordn, t_h, True)
        ordn = ordn + term.to(i64)
        n_term[idx] += term.to(i64)
        lost = work_lost[idx]
        work_lost[idx] = torch.where(term, lost + (work - sv), lost)
        seeking = seeking | term  # lane stays alive, back to the poll walk
        # _next_launch_time(terminated_at + _EPS, ...) opening tick
        ts = torch.where(term, torch.ceil((t_h + _EPS) / poll_t - _EPS) * poll, ts)
        kk = torch.where(live2, kk + 1, kk)

        # -- compact: drop finished cells so the tail runs on small arrays
        na = int(alive.sum())
        if na and na <= N // 2:
            obs.current().count("acc.compactions")
            keep = torch.nonzero(alive).squeeze(1)
            idx, pcnt_a, hor_a, m_a = idx[keep], pcnt_a[keep], hor_a[keep], m_a[keep]
            ptr, sv, L, t, work = ptr[keep], sv[keep], L[keep], t[keep], work[keep]
            kk, ts, ordn, seeking = kk[keep], ts[keep], ordn[keep], seeking[keep]
            alive = torch.ones(na, dtype=torch.bool, device=dev)
            N = na

    # the run records come back to the host once
    mask = torch.cat([r[0] for r in records])  # every lane is alive on the first pass: never empty
    rec = [torch.cat([r[k] for r in records])[mask].cpu().numpy() for k in range(1, 6)]
    done, comp_time, n_ckpt, n_term, work_lost = (
        x.cpu().numpy() for x in (done, comp_time, n_ckpt, n_term, work_lost)
    )
    with obs.current().span("bill", scheme=Scheme.ACC.value):
        total, _ = _bill_runs_flat(grid, *rec, delta)

    return {
        "completed": done & np.isfinite(comp_time),
        "completion_time": comp_time,
        "cost": total,
        "n_checkpoints": n_ckpt,
        "n_kills": np.zeros(C, dtype=np.int64),  # ACC is never provider-killed
        "work_lost_s": work_lost,
        "n_self_terminations": n_term,
    }


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
