"""Pure scheme step bodies: the per-period lockstep math in torch float64.

Every bid-limited scheme (NONE / OPT / HOUR / EDGE / ADAPT), and ACC's
hour-boundary lease step (:func:`acc_lease_tick`), is expressed
here as a pure function over tensors — no engine state, no trace objects, no
I/O — on whatever device its inputs lie.  They are the plain PyTorch form of
the fused sweep (:mod:`repro_torch.kernels.spot_sweep.ref` composes them),
and the CUDA kernel (``kernels/spot_sweep/csrc/spot_sweep.cu``) writes the
same expressions per thread.  The per-attempt lockstep walks
(:func:`_kernel_windows` for HOUR / EDGE, :func:`_kernel_adapt` for ADAPT)
are what the fleet engine's attempt waves call, one lane per attempt.

Exactness is the design contract: every floating-point expression keeps the
formula *and* association order of :mod:`repro.engine.kernels` —
``work + (s - t)``, ``t + (work_s - work)``, ``a + k*Δ - t_c`` — and uses only
IEEE-rounded operations (+ − × ÷ and comparisons), each a separate torch
operation, so results are bit-identical and the tests compare with ``==``.
``torch.minimum`` / ``torch.clamp`` propagate NaN exactly as ``np.minimum`` /
``np.clip`` do.

ADAPT is lowered through *binned hazard tables*: :class:`AdaptTables` packs
each (market, bid) cell's compact survival table once (host NumPy), and the
per-tick decision becomes two table gathers plus the Yi et al. comparison
``hazard * (unsaved + t_r) > t_c``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.schemes import FailurePdf, Scheme
from repro_torch.core.simulator import _EPS

__all__ = [
    "AdaptTables",
    "_EPS",
    "_kernel_adapt",
    "_kernel_none",
    "_kernel_opt",
    "_kernel_windows",
    "_survival_at",
    "acc_lease_tick",
    "adapt_decision",
    "adapt_tick",
    "adapt_tick_core",
    "period_step_masked",
    "windows_advance",
]


# ---------------------------------------------------------------------------
# Stateless elementwise kernels
# ---------------------------------------------------------------------------


def _kernel_none(b, start_work, saved, work_s):
    """NONE: no checkpoint windows; one straight work segment per period."""
    lhs = saved + (b - start_work)  # work + (b - t)
    done_now = lhs >= (work_s - _EPS)
    done_at = start_work + (work_s - saved)  # t + (work_s - work)
    return (
        done_now,
        done_at,
        lhs,
        saved,
        torch.zeros(b.shape[0], dtype=torch.int64, device=b.device),
    )


def _kernel_opt(b, start_work, saved, work_s, t_c):
    """OPT oracle: checkpoint exactly once, just before the kill — iff the
    kill precedes completion."""
    remaining = work_s - saved
    completes_at = start_work + remaining
    oracle = completes_at <= (b + _EPS)
    s = b - t_c
    has_s = (~oracle) & (s > start_work)

    # no-window path (oracle completion or window before recovery finished)
    lhsB = saved + (b - start_work)
    doneB = lhsB >= (work_s - _EPS)
    done_atB = start_work + (work_s - saved)

    # window path
    w_at_s = saved + (s - start_work)  # work + (s - t)
    doneA1 = w_at_s >= (work_s - _EPS)
    done_atA1 = start_work + (work_s - saved)
    ckpt_ok = (s + t_c) <= (b + _EPS)
    work1 = w_at_s
    saved1 = torch.where(ckpt_ok, work1, saved)
    t1 = s + t_c
    ended = t1 >= b
    lhsA2 = work1 + (b - t1)
    doneA2 = (~ended) & (lhsA2 >= (work_s - _EPS))
    done_atA2 = t1 + (work_s - work1)
    work_endA = torch.where(ended, work1, lhsA2)

    done_now = torch.where(has_s, doneA1 | doneA2, doneB)
    done_at = torch.where(has_s, torch.where(doneA1, done_atA1, done_atA2), done_atB)
    work_end = torch.where(has_s, work_endA, lhsB)
    saved_out = torch.where(has_s & ~doneA1, saved1, saved)
    ckpt_add = (has_s & ~doneA1 & ckpt_ok).to(torch.int64)
    return done_now, done_at, work_end, saved_out, ckpt_add


def period_step_masked(scheme, state, a, b, valid, horizon, t_r, run_kernel):
    """One padded-period lockstep advance, with masks for inactive lanes.

    Enter the period, consume too-short availability windows, dispatch the
    scheme kernel via ``run_kernel(go, a, b, start_work, saved)``, then fold
    completions / kills / checkpoint counts into the carried state.
    ``state`` is the 7-tuple ``(saved, done, comp_time, n_ckpt, work_lost,
    has_run, n_kills)`` — ``n_kills`` counts one per non-user-terminated
    recorded run, exactly the billing-side tally.  Returns ``(state,
    (rec_exists, rec_end, rec_user))``; the records feed the host biller.
    """
    saved, done, comp_time, n_ckpt, work_lost, has_run, n_kills = state
    none_reset = scheme == Scheme.NONE
    act = valid & ~done
    start_work = a + t_r
    if none_reset:
        # NONE restarts from scratch after any recorded run
        saved = torch.where(act & has_run, 0.0, saved)

    short = act & (start_work >= b)
    shortk = short & (b < horizon)
    go = act & ~short

    done_now, done_at, work_end, saved_out, ckpt_add = run_kernel(go, a, b, start_work, saved)
    done_now = go & done_now

    n_ckpt = n_ckpt + torch.where(go, ckpt_add, 0)
    comp_time = torch.where(done_now, done_at, comp_time)
    done = done | done_now
    kl = go & ~done_now
    if none_reset:
        work_lost = torch.where(kl, work_lost + (work_end - 0.0), work_lost)
        has_run = has_run | shortk | kl
    else:
        work_lost = torch.where(kl, work_lost + (work_end - saved_out), work_lost)
        saved = torch.where(kl, saved_out, saved)
    n_kills = n_kills + (shortk | kl).to(n_kills.dtype)

    rec_exists = shortk | done_now | kl
    rec_end = torch.where(done_now, done_at, b)
    state = (saved, done, comp_time, n_ckpt, work_lost, has_run, n_kills)
    return state, (rec_exists, rec_end, done_now)


# ---------------------------------------------------------------------------
# HOUR / EDGE: scheduled checkpoint windows, one lockstep iteration at a time
# ---------------------------------------------------------------------------


def windows_advance(s, window, state, work_s, t_c, b):
    """Apply one checkpoint window starting at ``s`` to every ``window`` cell.

    ``state = (work, t, sv, done_now, done_at, ckpt_add, in_loop)``; returns
    ``(window, state)`` with ``window`` cleared on lanes that completed.
    """
    work, t, sv, done_now, done_at, ckpt_add, in_loop = state
    w_at = work + (s - t)
    d = window & (w_at >= (work_s - _EPS))
    done_now = done_now | d
    done_at = torch.where(d, t + (work_s - work), done_at)
    in_loop = in_loop & ~d
    window = window & ~d

    work = torch.where(window, w_at, work)
    ckpt_ok = window & ((s + t_c) <= (b + _EPS))
    sv = torch.where(ckpt_ok, work, sv)
    ckpt_add = ckpt_add + ckpt_ok.to(torch.int64)
    t = torch.where(window, s + t_c, t)
    billed_out = window & (t >= b)
    in_loop = in_loop & ~billed_out
    return window, (work, t, sv, done_now, done_at, ckpt_add, in_loop)


def _kernel_windows(
    a,
    b,
    start_work,
    saved,
    work_s,
    t_c,
    hour_delta: float | None = None,
    edge_state: tuple | None = None,
):
    """HOUR / EDGE: walk scheduled checkpoint windows in lockstep.

    The port of :func:`repro.engine.kernels._kernel_windows`.  The loop
    advances one window index per iteration for every active lane at once; a
    lane drops out when it completes, is billed out at ``t >= b``, or runs
    out of windows (tail segment).  Window start times come from hour
    boundaries (``hour_delta``: ``a + k*Δ - t_c``) or the trace's rising
    edges (``edge_state = (edges_flat, base, n_edges, ptr)``: per-lane views
    into one flat edge tensor; ``edges_flat`` must hold at least one entry).
    ``work_s`` is a float or a per-lane tensor.

    The working set is compacted whenever at most half the rows are still
    in the loop, and the results are scattered back to full width on the
    lanes' device at the end — a scheduling change only, so results are
    bit-identical to the reference.  The loop reads back one ``any()`` and
    one live count an iteration.
    """
    C = b.shape[0]
    dev = b.device
    f64 = torch.float64
    b_full = b
    work_s_full = work_s  # per-lane work_s must survive compaction (fleet lanes)
    per_lane = isinstance(work_s, torch.Tensor) and work_s.ndim > 0
    rows = torch.arange(C, device=dev)  # current -> original row mapping
    work = saved
    t = start_work
    sv = saved
    done_now = torch.zeros(C, dtype=torch.bool, device=dev)
    done_at = torch.full((C,), np.nan, dtype=f64, device=dev)
    ckpt_add = torch.zeros(C, dtype=torch.int64, device=dev)
    tail = torch.zeros(C, dtype=torch.bool, device=dev)
    in_loop = torch.ones(C, dtype=torch.bool, device=dev)
    if edge_state is not None:
        edges_flat, base, n_edges, ptr = edge_state
    # full-width result buffers (written back on compaction / exit)
    out = {
        "work": torch.zeros(C, dtype=f64, device=dev),
        "t": torch.zeros(C, dtype=f64, device=dev),
        "sv": torch.zeros(C, dtype=f64, device=dev),
        "done_now": torch.zeros(C, dtype=torch.bool, device=dev),
        "done_at": torch.full((C,), np.nan, dtype=f64, device=dev),
        "ckpt_add": torch.zeros(C, dtype=torch.int64, device=dev),
        "tail": torch.zeros(C, dtype=torch.bool, device=dev),
    }

    def flush():
        out["work"][rows] = work
        out["t"][rows] = t
        out["sv"][rows] = sv
        out["done_now"][rows] = done_now
        out["done_at"][rows] = done_at
        out["ckpt_add"][rows] = ckpt_add
        out["tail"][rows] = tail

    k = 1
    while bool(in_loop.any()):
        if edge_state is None:
            s = a + k * hour_delta - t_c  # launch + k*Δ - t_c
            no_more = in_loop & ~(s < b)
            window = in_loop & (s < b) & (s > start_work)
            # s <= start_work windows are skipped but the walk continues
        else:
            have = in_loop & (ptr < n_edges)
            idx = torch.where(have, base + ptr, 0)
            s = torch.where(have, edges_flat[idx], np.inf)
            no_more = in_loop & (~have | ~(s < b))
            window = in_loop & have & (s < b)
        tail = tail | no_more
        in_loop = in_loop & ~no_more

        state = (work, t, sv, done_now, done_at, ckpt_add, in_loop)
        window, state = windows_advance(s, window, state, work_s, t_c, b)
        work, t, sv, done_now, done_at, ckpt_add, in_loop = state
        if edge_state is not None:
            ptr = ptr + window.to(ptr.dtype)  # only consumed edges advance
        k += 1

        live = int(in_loop.sum())
        if live and live <= rows.shape[0] // 2:
            flush()
            keep = torch.nonzero(in_loop).squeeze(1)
            rows = rows[keep]
            a, b, start_work = a[keep], b[keep], start_work[keep]
            work, t, sv = work[keep], t[keep], sv[keep]
            done_now, done_at, ckpt_add = done_now[keep], done_at[keep], ckpt_add[keep]
            tail = tail[keep]
            in_loop = in_loop[keep]
            if per_lane:
                work_s = work_s[keep]
            if edge_state is not None:
                base, n_edges, ptr = base[keep], n_edges[keep], ptr[keep]

    flush()
    work, t, sv = out["work"], out["t"], out["sv"]
    done_now, done_at, ckpt_add, tail = out["done_now"], out["done_at"], out["ckpt_add"], out["tail"]
    b = b_full
    work_s = work_s_full

    # tail segment: work to b, maybe completing
    lhs = work + (b - t)
    d2 = tail & (lhs >= (work_s - _EPS))
    done_now = done_now | d2
    done_at = torch.where(d2, t + (work_s - work), done_at)
    work_end = torch.where(tail, lhs, work)
    return done_now, done_at, work_end, sv, ckpt_add


# ---------------------------------------------------------------------------
# ADAPT: binned-hazard decision table, walked at the decision cadence
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdaptTables:
    """Per-cell binned survival tables for the lockstep ADAPT walk.

    One :meth:`~repro_torch.core.schemes.FailurePdf.compact_survival` table
    per (market, bid) cell, concatenated into ``flat`` with per-cell
    ``off``-sets and plateau indices ``top`` (cells are market-major,
    matching the period grid's cell axis).  A lookup at integer age bin
    ``k`` reads index ``min(k, top)`` inside the observed failure range and
    the censored tail entry (``top + 1``) from ``n_bins`` on — the exact
    floats :meth:`FailurePdf.survival` returns.
    """

    flat: np.ndarray  # float64, concatenated compact tables
    off: np.ndarray  # (C,) int64 start of each cell's table
    top: np.ndarray  # (C,) int64 plateau index within each table
    bin_s: float
    n_bins: int  # K: ages binned at >= K read the censored entry

    @staticmethod
    def build(markets, scenario, grid=None) -> "AdaptTables":
        """Materialize the decision tables for every (market, bid) cell.

        Without ``grid``, each cell's pdf is built one by one
        (:meth:`FailurePdf.from_trace` + :meth:`~FailurePdf.compact_survival`);
        with the scenario's period grid the same floats come vectorized per
        market (:func:`_build_tables_from_grid`).
        """
        if grid is not None:
            return _build_tables_from_grid(markets, grid)
        vals: list[np.ndarray] = []
        offs: list[int] = []
        tops: list[int] = []
        pos = 0
        bin_s: float | None = None
        n_bins: int | None = None
        for cellm in markets:
            for bid in scenario.market_bids(cellm):
                pdf = FailurePdf.from_trace(cellm.trace, bid)
                v, tp = pdf.compact_survival()
                if bin_s is None:
                    bin_s, n_bins = pdf.bin_s, len(pdf.pdf)
                offs.append(pos)
                tops.append(tp)
                vals.append(v)
                pos += len(v)
        return AdaptTables(
            flat=np.concatenate(vals) if vals else np.zeros(1),
            off=np.asarray(offs, dtype=np.int64),
            top=np.asarray(tops, dtype=np.int64),
            bin_s=float(bin_s if bin_s is not None else FailurePdf.DEFAULT_BIN_S),
            n_bins=int(n_bins if n_bins is not None else 1),
        )


def _build_tables_from_grid(markets, grid) -> AdaptTables:
    """Vectorized :meth:`AdaptTables.build`: survival tables straight from the
    period grid, one batch of array ops per market.

    Mirrors :meth:`FailurePdf.from_trace` float-for-float: failure durations
    are ``B - A`` of the non-censored periods, each contributes ``1.0 / n``
    in chronological order (``np.add.at`` adds sequentially), and the
    survival rows are ``1 - cumsum``.
    """
    bin_s = FailurePdf.DEFAULT_BIN_S
    K = FailurePdf.DEFAULT_MAX_BINS
    vals: list[np.ndarray] = []
    tops_all: list[np.ndarray] = []
    lens_all: list[np.ndarray] = []
    for m, sl in grid.market_slices():
        A, B, V = grid.A[sl], grid.B[sl], grid.valid[sl]
        nb = A.shape[0]
        horizon = markets[m].trace.horizon
        killed = V & (B < horizon)
        n = V.sum(axis=1)  # durations + censored, as the scalar counts
        cens_n = n - killed.sum(axis=1)
        rows, cols = np.nonzero(killed)  # row-major = chronological per cell
        k = np.minimum(((B[rows, cols] - A[rows, cols]) / bin_s).astype(np.int64), K - 1)
        Ka = int(k.max()) + 2 if k.size else 1
        pdf = np.zeros((nb, Ka))
        w = np.where(n > 0, 1.0 / np.maximum(n, 1), 0.0)
        np.add.at(pdf, (rows, k), w[rows])  # sequential adds in scalar order
        # last occupied bin per row (mass at k implies pdf[k] != 0: the adds
        # are positive), so the survival plateau starts at L + 1
        L = np.full(nb, -1, dtype=np.int64)
        np.maximum.at(L, rows, k)
        top = np.minimum(L + 1, K - 1)
        cum = np.cumsum(pdf[:, : max(int(top.max()), 1)], axis=1)
        censored = np.where(n > 0, cens_n / np.maximum(n, 1), 1.0)
        # ragged-flatten [1, 1 - cum[:top]] + [censored] per row, no Python loop
        top1 = top + 1
        off_local = np.cumsum(top + 2) - (top + 2)
        rowrep = np.repeat(np.arange(nb), top1)
        pos = np.arange(int(top1.sum())) - np.repeat(np.cumsum(top1) - top1, top1)
        flat_m = np.empty(int((top + 2).sum()))
        flat_m[off_local[rowrep] + pos] = np.where(
            pos == 0, 1.0, 1.0 - cum[rowrep, np.maximum(pos - 1, 0)]
        )
        flat_m[off_local + top1] = censored
        vals.append(flat_m)
        tops_all.append(top)
        lens_all.append(top + 2)
    lens = np.concatenate(lens_all)
    return AdaptTables(
        flat=np.concatenate(vals) if vals else np.zeros(1),
        off=np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64),
        top=np.concatenate(tops_all).astype(np.int64),
        bin_s=float(bin_s),
        n_bins=int(K),
    )


def _survival_at(k, flat, off, top, n_bins):
    """Gather binned survival for integer age bins ``k`` (per-cell tables)."""
    idx = torch.where(k >= n_bins, top + 1, torch.minimum(k, top))
    return flat[off + idx]


def adapt_decision(age, unsaved, flat, off, top, bin_s, n_bins, t_c, t_r, interval):
    """Yi et al.'s ADAPT rule as an elementwise table lookup.

    Survival now and one decision window ahead (age bins are a true IEEE
    division truncated toward zero), hazard ``clip((s_now - s_later) /
    s_now, 0, 1)`` (1 when the survival mass is exhausted), checkpoint iff
    ``h * (unsaved + t_r) > t_c``.
    """
    # the divisor as a tensor on the device: CUDA divides by a host scalar
    # through its reciprocal, which is not the IEEE quotient
    bin_t = torch.full((), bin_s, dtype=age.dtype, device=age.device)
    k1 = (age / bin_t).to(torch.int64)
    s_now = _survival_at(k1, flat, off, top, n_bins)
    k2 = ((age + interval) / bin_t).to(torch.int64)
    s_later = _survival_at(k2, flat, off, top, n_bins)
    dead = s_now <= 0.0
    den = torch.where(dead, 1.0, s_now)
    h = torch.where(dead, 1.0, torch.clamp((s_now - s_later) / den, 0.0, 1.0))
    return (h * (unsaved + t_r)) > t_c


def adapt_tick_core(
    live, t, work, sv, next_dec, a, b, work_s, t_c, t_r, interval,
    flat, off, top, bin_s, n_bins,
):
    """One ADAPT decision tick, the single shared body.

    Work to the next decision point (or the kill), maybe complete, then
    decide via the binned hazard whether to spend ``t_c`` checkpointing
    before the next interval.  Returns ``(live, t, work, sv, next_dec, d_at,
    fin, ck, kl)``: the advanced clocks, the would-be completion time
    ``d_at`` (valid on ``fin`` lanes), and the completion /
    checkpoint-taken / killed masks.
    """
    seg_end = torch.minimum(next_dec, b)
    fin = live & (work + (seg_end - t) >= work_s - _EPS)
    d_at = t + (work_s - work)
    live = live & ~fin
    work = torch.where(live, work + (seg_end - t), work)
    t = torch.where(live, seg_end, t)
    kill1 = live & (t >= b)  # killed at b with no decision left
    live = live & ~kill1

    age = t - a
    take = live & adapt_decision(
        age, work - sv, flat, off, top, bin_s, n_bins, t_c, t_r, interval
    )
    ck = take & ((t + t_c) <= (b + _EPS))
    sv = torch.where(ck, work, sv)
    t = torch.where(take, torch.minimum(t + t_c, b), t)
    kill2 = take & (t >= b)
    live = live & ~kill2
    next_dec = torch.where(live, t + interval, next_dec)
    return live, t, work, sv, next_dec, d_at, fin, ck, kill1 | kill2


def adapt_tick(state, a, b, work_s, t_c, t_r, interval, flat, off, top, bin_s, n_bins):
    """One period-synchronized ADAPT tick for every in-loop cell.

    ``state = (in_loop, t, work, sv, next_dec, done_now, done_at, ckpt_add)``:
    a thin bookkeeping wrapper over :func:`adapt_tick_core`.
    """
    in_loop, t, work, sv, next_dec, done_now, done_at, ckpt_add = state
    live, t, work, sv, next_dec, d_at, fin, ck, _ = adapt_tick_core(
        in_loop, t, work, sv, next_dec, a, b, work_s, t_c, t_r, interval,
        flat, off, top, bin_s, n_bins,
    )
    done_now = done_now | fin
    done_at = torch.where(fin, d_at, done_at)
    ckpt_add = ckpt_add + ck.to(torch.int64)
    return live, t, work, sv, next_dec, done_now, done_at, ckpt_add


def _kernel_adapt(a, b, start_work, saved, work_s, t_c, t_r, interval, tables, cells):
    """ADAPT: walk the decision cadence in lockstep, hazards from binned
    tables (the port of :func:`repro.engine.kernels._kernel_adapt`).

    ``tables`` is an :class:`AdaptTables` (its arrays NumPy or tensors);
    ``cells`` selects each lane's table.  Both are moved to the lanes'
    device.  Returns the same ``(done_now, done_at, work_end, saved_out,
    ckpt_add)`` tuple as every other step body.
    """
    C = b.shape[0]
    dev = b.device
    cells = torch.as_tensor(cells, device=dev)
    off = torch.as_tensor(tables.off, device=dev)[cells]
    top = torch.as_tensor(tables.top, device=dev)[cells]
    flat = torch.as_tensor(tables.flat, device=dev)
    state = (
        torch.ones(C, dtype=torch.bool, device=dev),  # in_loop
        start_work,  # t
        saved,  # work
        saved,  # sv
        start_work + interval,  # next_dec
        torch.zeros(C, dtype=torch.bool, device=dev),  # done_now
        torch.full((C,), np.nan, dtype=torch.float64, device=dev),  # done_at
        torch.zeros(C, dtype=torch.int64, device=dev),  # ckpt_add
    )
    while bool(state[0].any()):
        state = adapt_tick(
            state, a, b, work_s, t_c, t_r, interval,
            flat, off, top, tables.bin_s, tables.n_bins,
        )
    _, _, work, sv, _, done_now, done_at, ckpt_add = state
    return done_now, done_at, work, sv, ckpt_add


def acc_lease_tick(live, t_h, take_ckpt, term_q, t, work, sv, work_s, t_c):
    """One ACC hour-boundary step for every in-lease lane.

    The port of :func:`repro.engine.kernels.acc_lease_tick`: one iteration
    of the ``while True`` loop in ``simulator._acc_lease``, with the two
    price queries hoisted to the caller — ``take_ckpt`` is ``price_at(t_h -
    t_c - t_w) > a_bid`` and ``term_q`` is ``price_at(t_h - t_w) > a_bid``
    (Eq. 4 decision points).  The caller owns the hour cadence and the
    horizon-runoff break, which happen *before* this tick.

    Order matters and is the scalar's, expression for expression: the
    checkpoint-shortened segment end, the completion test (association
    ``work + (seg_end - t)`` and ``t + (work_s - work)``), the
    *unconditional* ``t = seg_end`` for lanes that neither finished nor
    advanced, then checkpoint commit (``sv = work``, ``t = t_h``), then the
    self-termination query.

    Returns ``(live, t, work, sv, d_at, fin, ck, term)``: surviving lanes,
    advanced clocks, the would-be completion time ``d_at`` (valid on ``fin``
    lanes), and the completion / checkpoint-taken / self-terminated masks
    (terminated lanes stop at ``t_h``).
    """
    seg_end = torch.where(take_ckpt, t_h - t_c, t_h)
    adv = live & (seg_end > t)
    fin = adv & (work + (seg_end - t) >= work_s - _EPS)
    d_at = t + (work_s - work)
    live = live & ~fin
    adv = adv & ~fin
    work = torch.where(adv, work + (seg_end - t), work)
    t = torch.where(live, seg_end, t)
    ck = live & take_ckpt
    sv = torch.where(ck, work, sv)
    t = torch.where(ck, t_h, t)
    term = live & term_q
    live = live & ~term
    return live, t, work, sv, d_at, fin, ck, term
