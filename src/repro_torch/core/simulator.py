"""Discrete-event simulator for checkpointing schemes on spot instances.

The scalar reference of the port (the counterpart of
:mod:`repro.core.simulator`): work progresses at unit rate while an instance
is up and not writing a checkpoint; billing follows
:mod:`repro_torch.core.billing` (hour-start prices, free partial hour only on
out-of-bid kills); each scheme of :mod:`repro_torch.core.schemes` schedules
checkpoint windows and — for ACC — self-terminations.

It is host Python, event by event over the piecewise-constant price trace,
and the semantic yardstick of the engine
(:class:`repro_torch.engine.reference.ReferenceEngine`,
:mod:`repro_torch.engine.parity`), not a device path.  Every expression and
its association order is the reference's, and :func:`_result` folds a job's
run costs with the builtin ``sum()`` as the reference does, so every field,
``cost`` included, equals :func:`repro.core.simulator.simulate`'s.
:func:`_next_launch_time` is also the relaunch poll of the live trainer.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core import billing
from repro_torch.core.billing import Termination
from repro_torch.core.market import PriceTrace
from repro_torch.core.schemes import (
    FailurePdf,
    Scheme,
    SimParams,
    adapt_should_checkpoint,
    decision_points,
)

#: Tolerance of every "work is done" / "checkpoint fits" comparison.
_EPS = 1e-9


@dataclasses.dataclass
class InstanceRun:
    launch: float
    end: float
    termination: Termination
    cost: float


@dataclasses.dataclass
class SimResult:
    scheme: Scheme
    bid: float
    work_s: float
    completed: bool
    completion_time: float  # wall-clock seconds from t=0 to job completion
    cost: float  # $
    n_checkpoints: int
    n_kills: int  # provider (out-of-bid) terminations
    n_self_terminations: int  # ACC user terminations
    work_lost_s: float
    runs: list[InstanceRun]

    @property
    def cost_time_product(self) -> float:
        return self.cost * self.completion_time

    @property
    def availability_overhead(self) -> float:
        """completion_time / work_s — 1.0 is perfect."""
        return self.completion_time / self.work_s


def simulate(
    trace: PriceTrace,
    scheme: Scheme,
    work_s: float,
    bid: float,
    params: SimParams | None = None,
    failure_pdf: FailurePdf | None = None,
    initial_saved_work: float = 0.0,
) -> SimResult:
    """Simulate one job of ``work_s`` seconds under ``scheme`` with ``bid``.

    For ACC, ``bid`` is the *application* bid A_bid (the instance bid S_bid is
    taken as infinite).  For ADAPT, ``failure_pdf`` defaults to the pdf
    estimated from this trace's own history (the paper estimates it from the
    published 3-month history).

    ``initial_saved_work`` resumes a job mid-trace from an existing
    checkpoint: the first launch restores that much completed work (the job
    finishes once total work reaches ``work_s``).  This is how the fleet
    migration engine re-homes a killed job on a new instance type; the
    default of 0.0 keeps single-job behavior identical.
    """
    params = params or SimParams()
    if not 0.0 <= initial_saved_work <= work_s:
        raise ValueError(f"initial_saved_work {initial_saved_work} outside [0, {work_s}]")
    if scheme == Scheme.ACC:
        return _simulate_acc(trace, work_s, bid, params, initial_saved_work)
    if scheme == Scheme.ADAPT and failure_pdf is None:
        failure_pdf = FailurePdf.from_trace(trace, bid)
    return _simulate_bid_limited(trace, scheme, work_s, bid, params, failure_pdf, initial_saved_work)


# ---------------------------------------------------------------------------
# Bid-limited schemes: NONE / OPT / HOUR / EDGE / ADAPT
# ---------------------------------------------------------------------------


def _simulate_bid_limited(
    trace: PriceTrace,
    scheme: Scheme,
    work_s: float,
    bid: float,
    params: SimParams,
    failure_pdf: FailurePdf | None,
    initial_saved_work: float = 0.0,
) -> SimResult:
    saved = initial_saved_work
    n_ckpt = 0
    n_kills = 0
    work_lost = 0.0
    runs: list[InstanceRun] = []

    for a, b in trace.available_periods(bid):
        killed = b < trace.horizon  # period truncated by out-of-bid
        start_work = a + params.t_r
        if scheme == Scheme.NONE:
            saved = 0.0 if runs else saved  # NONE restarts from scratch after a kill

        if start_work >= b:
            # killed before recovery finished: pay (partial hour free), no progress
            if killed:
                cost = billing.run_cost(trace, a, b, Termination.OUT_OF_BID, params.billing_period_s)
                runs.append(InstanceRun(a, b, Termination.OUT_OF_BID, cost))
                n_kills += 1
            continue

        done_at, work_end, saved, took = _run_period(
            trace, scheme, a, start_work, b, saved, work_s, params, failure_pdf
        )
        n_ckpt += took

        if done_at is not None:
            cost = billing.run_cost(trace, a, done_at, Termination.USER, params.billing_period_s)
            runs.append(InstanceRun(a, done_at, Termination.USER, cost))
            return _result(scheme, bid, work_s, True, done_at, runs, n_ckpt, n_kills, 0, work_lost)

        # out-of-bid kill at b
        cost = billing.run_cost(trace, a, b, Termination.OUT_OF_BID, params.billing_period_s)
        runs.append(InstanceRun(a, b, Termination.OUT_OF_BID, cost))
        n_kills += 1
        work_lost += work_end - (0.0 if scheme == Scheme.NONE else saved)

    return _result(scheme, bid, work_s, False, math.inf, runs, n_ckpt, n_kills, 0, work_lost)


def _run_period(trace, scheme, launch, start_work, b, saved, work_s, params, failure_pdf):
    """Walk one availability period. Returns (done_at|None, work_at_end, saved, n_ckpt)."""
    t = start_work
    work = saved
    n_ckpt = 0

    # Precompute scheduled checkpoint-window starts for stateless schemes.
    if scheme == Scheme.HOUR:
        starts = []
        k = 1
        while True:
            s = launch + k * params.billing_period_s - params.t_c
            if s >= b:
                break
            if s > start_work:
                starts.append(s)
            k += 1
    elif scheme == Scheme.EDGE:
        starts = [float(e) for e in trace.rising_edges() if start_work < e < b]
    elif scheme == Scheme.OPT:
        # Oracle: only checkpoint if the kill (at b) arrives before completion.
        remaining = work_s - work
        completes_at = start_work + remaining
        if completes_at <= b + _EPS:
            starts = []
        else:
            s = b - params.t_c
            starts = [s] if s > start_work else []
    elif scheme in (Scheme.NONE,):
        starts = []
    else:  # ADAPT: dynamic decisions, handled below
        starts = None

    if starts is not None:
        for s in starts:
            # work segment [t, s)
            if work + (s - t) >= work_s - _EPS:
                return t + (work_s - work), work_s, saved, n_ckpt
            work += s - t
            if s + params.t_c <= b + _EPS:  # checkpoint completes in-period
                saved = work
                n_ckpt += 1
            t = s + params.t_c
            if t >= b:
                return None, work, saved, n_ckpt
        if work + (b - t) >= work_s - _EPS:
            return t + (work_s - work), work_s, saved, n_ckpt
        return None, work + (b - t), saved, n_ckpt

    # ADAPT: decide every adapt_interval_s whether to checkpoint now.
    next_decision = start_work + params.adapt_interval_s
    while True:
        seg_end = min(next_decision, b)
        if work + (seg_end - t) >= work_s - _EPS:
            return t + (work_s - work), work_s, saved, n_ckpt
        work += seg_end - t
        t = seg_end
        if t >= b:
            return None, work, saved, n_ckpt
        age = t - launch
        if adapt_should_checkpoint(failure_pdf, age, work - saved, params):
            if t + params.t_c <= b + _EPS:
                saved = work
                n_ckpt += 1
            t = min(t + params.t_c, b)
            if t >= b:
                return None, work, saved, n_ckpt
        next_decision = t + params.adapt_interval_s


# ---------------------------------------------------------------------------
# Single-attempt primitive (fleet migration engine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttemptResult:
    """Outcome of one instance attempt (a single availability period, or —
    for ACC — a single lease between launch and self-termination).

    All times are absolute on the given trace.  ``work_done_s`` and
    ``saved_work_s`` include ``initial_saved_work``; on a kill only
    ``saved_work_s`` survives to the next attempt.  ``self_terminated`` marks
    an ACC user termination at an hour boundary — like ``killed`` it ends the
    attempt with the job unfinished, so a fleet controller treats either as a
    migration trigger, but it is billed as a USER termination (full final
    hour) per the paper's corrected billing.
    """

    launch: float
    end: float  # completion instant, kill instant, or horizon
    completed: bool
    killed: bool  # provider out-of-bid kill at ``end`` (False at horizon)
    cost: float
    work_done_s: float
    saved_work_s: float
    n_checkpoints: int
    self_terminated: bool = False  # ACC only

    def termination(self) -> Termination:
        if self.completed or self.self_terminated:
            return Termination.USER
        return Termination.OUT_OF_BID


def simulate_attempt(
    trace: PriceTrace,
    scheme: Scheme,
    work_s: float,
    bid: float,
    start_t: float = 0.0,
    params: SimParams | None = None,
    failure_pdf: FailurePdf | None = None,
    initial_saved_work: float = 0.0,
) -> AttemptResult | None:
    """Run a *single* instance attempt: launch at the first availability at or
    after ``start_t`` and walk one availability period to completion, kill, or
    horizon.

    Unlike :func:`simulate`, which relaunches on the *same* trace after every
    kill, this returns control to the caller at the first kill so a fleet
    controller can re-provision onto a different instance type (migration).
    Returns ``None`` when the trace is never available again under ``bid``.
    ACC is bid-unlimited (the instance is never provider-killed), so fleet
    attempts use the bid-limited schemes.
    """
    params = params or SimParams()
    if scheme == Scheme.ACC:
        raise ValueError("simulate_attempt supports bid-limited schemes; use simulate() for ACC")
    if not 0.0 <= initial_saved_work <= work_s:
        raise ValueError(f"initial_saved_work {initial_saved_work} outside [0, {work_s}]")
    if scheme == Scheme.ADAPT and failure_pdf is None:
        failure_pdf = FailurePdf.from_trace(trace, bid)

    launch = trace.next_available(bid, start_t)
    if launch is None or launch >= trace.horizon:
        return None
    b = trace.next_out_of_bid(bid, launch)
    killed = b < trace.horizon
    saved = initial_saved_work

    start_work = launch + params.t_r
    if start_work >= b:
        # killed (or horizon) before recovery finished: no progress
        cost = billing.run_cost(trace, launch, b, Termination.OUT_OF_BID, params.billing_period_s)
        return AttemptResult(launch, b, False, killed, cost, saved, saved, 0)

    done_at, work_end, saved, took = _run_period(
        trace, scheme, launch, start_work, b, saved, work_s, params, failure_pdf
    )
    if done_at is not None:
        cost = billing.run_cost(trace, launch, done_at, Termination.USER, params.billing_period_s)
        return AttemptResult(launch, done_at, True, False, cost, work_s, saved, took)
    cost = billing.run_cost(trace, launch, b, Termination.OUT_OF_BID, params.billing_period_s)
    return AttemptResult(launch, b, False, killed, cost, work_end, saved, took)


def simulate_acc_attempt(
    trace: PriceTrace,
    work_s: float,
    a_bid: float,
    start_t: float = 0.0,
    params: SimParams | None = None,
    initial_saved_work: float = 0.0,
) -> AttemptResult | None:
    """Run a *single* ACC lease: launch at the first admissible instant at or
    after ``start_t`` and walk hour boundaries to completion, self-termination
    (``self_terminated=True``), or the horizon.

    The ACC analogue of :func:`simulate_attempt`: ACC instances are never
    provider-killed (S_bid ~ infinity), but a self-termination ends the lease
    with the job unfinished exactly like an out-of-bid kill does for the
    bid-limited schemes — so a fleet controller can re-provision the job onto
    a different type from its last checkpoint.  Launch timing mirrors
    :func:`simulate`'s ACC loop: immediate at ``start_t == 0`` when the price
    already admits ``a_bid``, otherwise the next admissible poll tick; chain
    attempts with ``start_t = previous.end + eps`` to reproduce the multi-
    lease ``simulate`` outcome exactly (including the final lease, which is
    billed OUT_OF_BID-style when it runs off the horizon).  Returns ``None``
    when no admissible launch exists before the horizon.
    """
    params = params or SimParams()
    if not 0.0 <= initial_saved_work <= work_s:
        raise ValueError(f"initial_saved_work {initial_saved_work} outside [0, {work_s}]")

    if start_t == 0.0 and trace.price_at(0.0) <= a_bid:
        launch = 0.0
    else:
        launch = _next_launch_time(trace, start_t, a_bid, params.poll_s)
    if launch is None or launch >= trace.horizon:
        return None

    done_at, terminated_at, work, saved, n_ckpt = _acc_lease(
        trace, launch, work_s, a_bid, initial_saved_work, params
    )
    if done_at is not None:
        cost = billing.run_cost(trace, launch, done_at, Termination.USER, params.billing_period_s)
        return AttemptResult(launch, done_at, True, False, cost, work_s, saved, n_ckpt)
    if terminated_at is None:  # ran off the horizon: billed OUT_OF_BID
        # (full hours charged, partial final hour free), mirroring simulate()
        cost = billing.run_cost(
            trace, launch, trace.horizon, Termination.OUT_OF_BID, params.billing_period_s
        )
        return AttemptResult(launch, trace.horizon, False, False, cost, work, saved, n_ckpt)
    cost = billing.run_cost(trace, launch, terminated_at, Termination.USER, params.billing_period_s)
    return AttemptResult(
        launch, terminated_at, False, False, cost, work, saved, n_ckpt, self_terminated=True
    )


# ---------------------------------------------------------------------------
# ACC (paper §VI)
# ---------------------------------------------------------------------------


def _next_launch_time(trace: PriceTrace, t_from: float, a_bid: float, poll_s: float) -> float | None:
    """First poll tick >= t_from with price <= A_bid (paper: user-defined poll)."""
    t = math.ceil(t_from / poll_s - _EPS) * poll_s
    while t < trace.horizon:
        if trace.price_at(t) <= a_bid:
            return t
        # jump to the next of (next poll tick, next price change) — price is
        # piecewise constant so polls inside one segment all agree.
        nxt_change = trace.next_change(t)
        t = max(t + poll_s, math.ceil(nxt_change / poll_s - _EPS) * poll_s)
    return None


def _acc_lease(
    trace: PriceTrace,
    launch: float,
    work_s: float,
    a_bid: float,
    saved: float,
    params: SimParams,
) -> tuple[float | None, float | None, float, float, int]:
    """Walk one ACC lease from ``launch``: hour-by-hour checkpoint/terminate
    decisions at the Eq. (3)-(4) decision points until completion,
    self-termination, or the horizon.

    Returns ``(done_at, terminated_at, work, saved, n_ckpt)``; exactly one of
    ``done_at`` / ``terminated_at`` is set unless the lease runs off the
    horizon (both ``None``).  Shared by :func:`simulate` (ACC) and the fleet
    primitive :func:`simulate_acc_attempt` so the two can never drift.
    """
    L = launch
    t = L + params.t_r
    work = saved
    k = 1
    n_ckpt = 0
    done_at = None
    terminated_at = None
    while True:
        t_h = L + k * params.billing_period_s
        t_cd, t_td = decision_points(t_h, params)
        if t_h > trace.horizon:
            break
        take_ckpt = trace.price_at(t_cd) > a_bid
        seg_end = (t_h - params.t_c) if take_ckpt else t_h
        if seg_end > t:
            if work + (seg_end - t) >= work_s - _EPS:
                done_at = t + (work_s - work)
                break
            work += seg_end - t
        t = seg_end
        if take_ckpt:
            saved = work  # snapshot at window start, completes exactly at t_h
            n_ckpt += 1
            t = t_h
        if trace.price_at(t_td) > a_bid:
            terminated_at = t_h
            break
        k += 1
    return done_at, terminated_at, work, saved, n_ckpt


def _simulate_acc(
    trace: PriceTrace,
    work_s: float,
    a_bid: float,
    params: SimParams,
    initial_saved_work: float = 0.0,
) -> SimResult:
    saved = initial_saved_work
    n_ckpt = 0
    n_term = 0
    work_lost = 0.0
    runs: list[InstanceRun] = []

    t0 = 0.0 if trace.price_at(0.0) <= a_bid else None
    launch_at = t0 if t0 is not None else _next_launch_time(trace, 0.0, a_bid, params.poll_s)

    while launch_at is not None and launch_at < trace.horizon:
        L = launch_at
        done_at, terminated_at, work, saved, ckpts = _acc_lease(
            trace, L, work_s, a_bid, saved, params
        )
        n_ckpt += ckpts

        if done_at is not None:
            cost = billing.run_cost(trace, L, done_at, Termination.USER, params.billing_period_s)
            runs.append(InstanceRun(L, done_at, Termination.USER, cost))
            return _result(Scheme.ACC, a_bid, work_s, True, done_at, runs, n_ckpt, 0, n_term, work_lost)

        if terminated_at is None:  # ran off the horizon: bill like the
            # bid-limited schemes bill a horizon-truncated period (full hours
            # charged, partial final hour free) so cross-scheme cost
            # comparisons at non-completing bids aren't biased towards ACC
            if trace.horizon > L:
                cost = billing.run_cost(
                    trace, L, trace.horizon, Termination.OUT_OF_BID, params.billing_period_s
                )
                runs.append(InstanceRun(L, trace.horizon, Termination.OUT_OF_BID, cost))
            break

        cost = billing.run_cost(trace, L, terminated_at, Termination.USER, params.billing_period_s)
        runs.append(InstanceRun(L, terminated_at, Termination.USER, cost))
        n_term += 1
        work_lost += work - saved
        launch_at = _next_launch_time(trace, terminated_at + _EPS, a_bid, params.poll_s)

    return _result(Scheme.ACC, a_bid, work_s, False, math.inf, runs, n_ckpt, 0, n_term, work_lost)


def _result(scheme, bid, work_s, completed, done_at, runs, n_ckpt, n_kills, n_term, work_lost) -> SimResult:
    return SimResult(
        scheme=scheme,
        bid=bid,
        work_s=work_s,
        completed=completed,
        completion_time=done_at,
        cost=sum(r.cost for r in runs),
        n_checkpoints=n_ckpt,
        n_kills=n_kills,
        n_self_terminations=n_term,
        work_lost_s=work_lost,
        runs=runs,
    )
