"""Fleet controller: many concurrent jobs, one discrete-event loop.

The port's copy of :mod:`repro.fleet.controller`.  It is host Python, event
by event, like the port's scalar ``ReferenceEngine``: the yardstick of the
batch engine (:mod:`repro_torch.fleet.batch`) and the one engine for
contended and re-bidding fleets.

:class:`FleetController` runs a :class:`~repro_torch.fleet.workload.Workload` of
jobs across a catalog of instance types with one price trace per type.  Each
job replica advances through *attempts* — single availability periods
simulated by :func:`repro_torch.core.simulator.simulate_attempt` under the chosen
checkpointing scheme (single ACC leases via
:func:`~repro_torch.core.simulator.simulate_acc_attempt`), billed by
:mod:`repro_torch.core.billing`.  On an out-of-bid kill — or an ACC
self-termination, which evicts the job the same way — the migration engine
re-runs the placement policy over the surviving catalog and resumes the job
on a (usually different) type from its last checkpoint, scaling remaining
work by the ECU ratio exactly as Algorithm 1 scales work when ranking types.

The event loop holds a heap of (time, event) pairs; attempts are simulated
eagerly into the future and cancelled lazily (stale tokens), which keeps the
loop O(events log events) with no per-tick stepping.

With ``capacity`` set the controller trades against a capacity-constrained
market (:mod:`repro_torch.market`): every attempt is simulated on its *cleared
view* — the uniform-price auction of the background stack plus all
registered fleet demand — and registered in the per-type demand ledger, so a
large fleet moves prices against itself and competing jobs.  When a new
registration raises a type's clearing price above a running replica's bid,
that replica's attempt is re-simulated on its updated view and ends in an
ordinary out-of-bid kill (preemption-by-outbid), feeding the same migration
path as an exogenous price spike.  Bids come from the pluggable
:class:`~repro_torch.fleet.policies.BidPolicy` hook — fixed margins by default,
online re-bidding from the cleared quote with
:class:`~repro_torch.fleet.policies.ClearingRebid`.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Mapping

from repro_torch.core import billing
from repro_torch.core.billing import Termination
from repro_torch.core.market import InstanceType, PriceTrace
from repro_torch.core.schemes import Scheme, SimParams
from repro_torch.core.schemes import FailurePdf
from repro_torch.core.simulator import _EPS, simulate_acc_attempt, simulate_attempt
from repro_torch.fleet.policies import BidPolicy, Placement, PlacementContext, PlacementPolicy
from repro_torch.fleet.workload import Job, Workload
from repro_torch.market import FleetMarket, MarketParams
from repro_torch.obs import telemetry as obs

_ARRIVAL, _END = 0, 1


@dataclasses.dataclass(frozen=True)
class AttemptRecord:
    """One billed instance run of one job replica.

    ``initial_saved_ref`` / ``saved_after_ref`` are checkpointed work in
    reference-ECU seconds before and after the attempt; ``work_start`` is when
    useful work began (launch + t_r, clipped to ``end``) — the interval
    ``[work_start, end)`` is when this replica was making progress.
    """

    job_id: int
    replica: int
    instance: str
    bid: float
    launch: float
    end: float
    termination: Termination
    cost: float
    work_start: float
    initial_saved_ref: float
    saved_after_ref: float
    killed: bool
    completed: bool
    cancelled: bool  # sibling replica finished first; run truncated at its end
    self_terminated: bool = False  # ACC user termination (migration trigger)


@dataclasses.dataclass
class JobOutcome:
    job: Job
    completed: bool
    completion_time: float  # math.inf when unfinished
    cost: float  # sum over this job's records
    n_kills: int
    n_migrations: int
    attempts: list[AttemptRecord]

    @property
    def deadline_met(self) -> bool | None:
        if self.job.deadline_s is None:
            return None
        return self.completed and self.completion_time <= self.job.deadline_s


@dataclasses.dataclass
class FleetResult:
    policy: str
    scheme: Scheme
    outcomes: dict[int, JobOutcome]
    records: list[AttemptRecord]
    horizon: float

    @property
    def total_cost(self) -> float:
        return sum(r.cost for r in self.records)

    @property
    def n_completed(self) -> int:
        return sum(1 for o in self.outcomes.values() if o.completed)

    @property
    def n_kills(self) -> int:
        return sum(o.n_kills for o in self.outcomes.values())

    @property
    def n_migrations(self) -> int:
        return sum(o.n_migrations for o in self.outcomes.values())

    @property
    def n_self_terminations(self) -> int:
        """ACC user terminations across all records (0 for bid-limited schemes)."""
        return sum(1 for r in self.records if r.self_terminated)

    @property
    def kill_rate(self) -> float:
        """Kills per attempted instance run."""
        return self.n_kills / max(1, len(self.records))

    @property
    def makespan(self) -> float:
        """Last completion minus first arrival (inf if any job unfinished)."""
        if not self.outcomes:
            return 0.0
        if any(not o.completed for o in self.outcomes.values()):
            return math.inf
        t0 = min(o.job.arrival_s for o in self.outcomes.values())
        return max(o.completion_time for o in self.outcomes.values()) - t0

    def mean_completion_s(self) -> float:
        done = [o.completion_time - o.job.arrival_s for o in self.outcomes.values() if o.completed]
        return sum(done) / len(done) if done else math.inf

    def outage_intervals(self, eps: float = 1e-6) -> list[tuple[float, float]]:
        """Whole-fleet outages: maximal intervals during which at least one
        job is active (arrived, unfinished) yet **no** replica anywhere in the
        fleet is making progress.

        Correlated kills show up here: if every job sits on the same instance
        type, one price spike stalls them all simultaneously (at minimum for
        the t_r recovery of the migration), whereas a diversified fleet keeps
        computing through a regional spike.

        ``eps`` is a *relative* tolerance: a record (or gap) only counts when
        it is longer than ``eps * max(1.0, |t|)``.  Fleet timestamps reach
        ~1e6 s, where float64 spacing is ~1e-10 s — an absolute ``1e-6``
        cutoff near the horizon silently classified real zero-length
        touch-points as outages (and vice versa) depending on how far into
        the trace they fell.
        """

        def tol(t: float) -> float:
            return eps * max(1.0, abs(t))

        deltas: list[tuple[float, int, int]] = []  # (time, job_delta, work_delta)
        for o in self.outcomes.values():
            a = o.job.arrival_s
            b = min(o.completion_time, self.horizon) if o.completed else self.horizon
            if b > a:
                deltas.append((a, 1, 0))
                deltas.append((b, -1, 0))
        for r in self.records:
            if r.end > r.work_start + tol(r.work_start):
                deltas.append((r.work_start, 0, 1))
                deltas.append((r.end, 0, -1))
        deltas.sort()
        out: list[tuple[float, float]] = []
        jobs = work = 0
        start: float | None = None
        for t, dj, dw in deltas:
            was_outage = jobs > 0 and work == 0
            jobs += dj
            work += dw
            is_outage = jobs > 0 and work == 0
            if is_outage and not was_outage:
                start = t
            elif was_outage and not is_outage and start is not None:
                if t - start > tol(start):
                    out.append((start, t))
                start = None
        return out

    def summary(self) -> dict[str, float]:
        return {
            "total_cost": self.total_cost,
            "n_jobs": len(self.outcomes),
            "n_completed": self.n_completed,
            "n_kills": self.n_kills,
            "n_migrations": self.n_migrations,
            "kill_rate": self.kill_rate,
            "makespan_h": self.makespan / 3600.0,
            "mean_completion_h": self.mean_completion_s() / 3600.0,
            "n_outages": len(self.outage_intervals()),
        }


@dataclasses.dataclass
class _Replica:
    saved_ref: float = 0.0
    n_migrations: int = 0
    n_kills: int = 0
    done: bool = False
    token: int | None = None
    # (AttemptResult, Placement, initial_saved_ref, start_t, Registration|None)
    active: tuple | None = None


@dataclasses.dataclass
class _JobState:
    job: Job
    replicas: dict[int, _Replica]
    completed_at: float | None = None


class FleetController:
    """Schedules a workload across the catalog under one placement policy."""

    def __init__(
        self,
        catalog: list[InstanceType],
        traces: Mapping[str, PriceTrace],
        policy: PlacementPolicy,
        histories: Mapping[str, PriceTrace] | None = None,
        params: SimParams | None = None,
        scheme: Scheme = Scheme.HOUR,
        reference_ecu: float = 8.0,
        migrate: bool = True,
        max_migrations_per_replica: int = 64,
        bid_margin: float = 0.56,
        capacity: int | None = None,
        market_params: MarketParams | None = None,
        bid_policy: BidPolicy | None = None,
    ):
        """``histories`` is what policies (and ADAPT) estimate failure pdfs
        from.  It defaults to the evaluation traces themselves — convenient
        for tests, but that grants policies oracle knowledge of the future;
        pass a disjoint history (as :func:`repro_torch.engine.fleetgrid.run_fleet`
        does) for honest policy comparisons.

        ``capacity`` switches on the capacity-constrained market: each type's
        trace becomes the background of a :class:`~repro_torch.market.SpotMarket`
        and placements compete in its auction (ADAPT's hazard estimate stays
        history-based — contention is not in the pdf).  ``bid_policy``
        overrides how non-paper policies bid; the default reproduces
        ``bid_margin × on-demand`` bit for bit."""
        missing = [it.name for it in catalog if it.name not in traces]
        if missing:
            raise ValueError(f"no trace for catalog types: {missing[:4]}...")
        self.catalog = list(catalog)
        self.traces = dict(traces)
        self.policy = policy
        self.histories = dict(histories) if histories is not None else dict(traces)
        self.params = params or SimParams()
        self.scheme = scheme
        self.reference_ecu = reference_ecu
        self.migrate = migrate
        self.max_migrations_per_replica = max_migrations_per_replica
        self.horizon = min(t.horizon for t in self.traces.values())
        self.market: FleetMarket | None = None
        if capacity is not None:
            self.market = FleetMarket.build(self.catalog, self.traces, capacity, market_params)
        self.ctx = PlacementContext(
            histories=self.histories,
            params=self.params,
            reference_ecu=reference_ecu,
            bid_margin=bid_margin,
            bid_policy=bid_policy,
        )
        # ADAPT pdfs built from *evaluation* traces when a type has no
        # history: cached here so re-provisioning the same (type, bid) across
        # migrations doesn't rebuild the pdf inside every simulate_attempt
        self._eval_pdf_cache: dict[tuple[str, float], FailurePdf] = {}

    # -- helpers ------------------------------------------------------------

    def _spot_prices(self, now: float) -> dict[str, float]:
        """Quotes policies (and re-bid hooks) observe: cleared prices when a
        market is live, exogenous trace prices otherwise."""
        if self.market is not None:
            # quote-only trace entries outside the catalog have no pool (they
            # are never placeable): fall back to their exogenous price
            return {
                name: self.market.price_at(name, now) if name in self.market else tr.price_at(now)
                for name, tr in self.traces.items()
            }
        return {name: tr.price_at(now) for name, tr in self.traces.items()}

    def _market_view(self, placement: Placement, own_reg=None):
        """The trace one replica's attempt simulates on: the auction-cleared
        view under a live market, the exogenous trace otherwise."""
        if self.market is None:
            return self.traces[placement.instance.name]
        return self.market[placement.instance.name].cleared_view(placement.bid, own_reg)

    def _feasible(self, job: Job, exclude: frozenset[str] = frozenset()) -> list[InstanceType]:
        return [it for it in self.catalog if job.sla.admits(it) and it.name not in exclude]

    def _scale(self, it: InstanceType) -> float:
        """reference-ECU seconds -> wall seconds on ``it`` (and back by /)."""
        return self.reference_ecu / it.compute_units

    def _adapt_pdf(self, name: str, bid: float) -> FailurePdf:
        """ADAPT failure pdf for (type, bid): from history via the shared
        placement-context cache, else built once from the evaluation trace
        (and cached) — never rebuilt per migration attempt.

        The returned pdf's binned survival table is materialized here, so
        every per-step hazard decision inside ``simulate_attempt`` is the
        same O(1) table lookup the batched engine kernels use (one numeric
        source; the attempt loop never pays per-decision prefix sums)."""
        pdf = self.ctx.pdf(name, bid)
        if pdf is None:
            key = (name, round(bid, 6))
            if key not in self._eval_pdf_cache:
                self._eval_pdf_cache[key] = FailurePdf.from_trace(self.traces[name], bid)
            pdf = self._eval_pdf_cache[key]
        pdf.survival_table()
        return pdf

    # -- main loop ----------------------------------------------------------

    def run(self, workload: Workload) -> FleetResult:
        tel = obs.current()
        records: list[AttemptRecord] = []
        states: dict[int, _JobState] = {}
        heap: list[tuple[float, int, int, tuple]] = []
        seq = 0
        token_counter = 0

        def push(t: float, kind: int, payload: tuple) -> None:
            nonlocal seq
            heapq.heappush(heap, (t, kind, seq, payload))
            seq += 1

        def simulate_on(trace, st: _JobState, placement: Placement, start_t: float, saved_ref: float):
            """One attempt of ``st.job`` on ``trace`` (the cleared view under
            a live market) — the single simulation path shared by fresh
            spawns and market re-pricing, so the two can never drift."""
            scale = self._scale(placement.instance)
            if self.scheme == Scheme.ACC:
                # ACC lease: never provider-killed; a self-termination at an
                # hour boundary drives migration like an out-of-bid kill does
                return simulate_acc_attempt(
                    trace,
                    st.job.work_s * scale,
                    placement.bid,
                    start_t=start_t,
                    params=self.params,
                    initial_saved_work=saved_ref * scale,
                )
            # ADAPT's hazard estimate must come from history, not from the
            # future of the very trace being simulated (and is cached).
            failure_pdf = None
            if self.scheme == Scheme.ADAPT:
                failure_pdf = self._adapt_pdf(placement.instance.name, placement.bid)
            return simulate_attempt(
                trace,
                self.scheme,
                st.job.work_s * scale,
                placement.bid,
                start_t=start_t,
                params=self.params,
                failure_pdf=failure_pdf,
                initial_saved_work=saved_ref * scale,
            )

        def spawn_attempt(st: _JobState, r_idx: int, placement: Placement, now: float) -> None:
            nonlocal token_counter
            rep = st.replicas[r_idx]
            att = simulate_on(self._market_view(placement), st, placement, now, rep.saved_ref)
            if att is None:  # type never available again under this bid
                rep.done = True
                return
            tel.count("fleet.attempts")
            if tel.enabled:
                tel.event(
                    "fleet.launch", att.launch,
                    job=st.job.id, replica=r_idx, instance=placement.instance.name,
                )
            reg = None
            if self.market is not None:
                reg = self.market[placement.instance.name].register(
                    att.launch, att.end, placement.bid
                )
            token_counter += 1
            rep.token = token_counter
            rep.active = (att, placement, rep.saved_ref, now, reg)
            push(att.end, _END, (st.job.id, r_idx, rep.token))
            if reg is not None:
                reclear(placement.instance.name, att.launch, att.end, (st.job.id, r_idx))

        def reclear(name: str, lo: float, hi: float, skip: tuple[int, int]) -> None:
            """First-order market re-clearing: new demand on ``name`` over
            ``[lo, hi)`` re-prices every overlapping attempt on that type.

            Each such attempt is re-simulated from its original start on its
            updated cleared view (its own stale registration excluded) — the
            past it already lived through is unchanged (the ledger is
            append-only over time), so only the future moves: a replica whose
            bid the new clearing price exceeds now ends in an ordinary
            out-of-bid kill, exactly like an exogenous spike.  Demand that
            *shrinks* as a result is recorded in the ledger (visible to every
            later view) but does not re-extend other running attempts — a
            displaced instance migrates, it does not come back.
            """
            nonlocal token_counter
            tel.count("market.reclear_passes")
            sm = self.market[name]
            for job_id, st2 in states.items():
                if st2.completed_at is not None:
                    continue
                for r2, rep2 in st2.replicas.items():
                    if (job_id, r2) == skip or rep2.active is None:
                        continue
                    att2, pl2, init2, start2, reg2 = rep2.active
                    if pl2.instance.name != name or att2.end <= lo or att2.launch >= hi:
                        continue
                    new_att = simulate_on(
                        self._market_view(pl2, own_reg=reg2), st2, pl2, start2, init2
                    )
                    if new_att is None:
                        # priced out of the whole horizon before ever
                        # launching: migrate like any other preemption (the
                        # displacing demand starts at lo, so re-place there)
                        tel.count("fleet.preempt_outbid")
                        sm.update(reg2, reg2.start, reg2.start)
                        rep2.token = None
                        rep2.active = None
                        if self.migrate and rep2.n_migrations < self.max_migrations_per_replica:
                            rep2.n_migrations += 1
                            tel.count("fleet.migrations")
                            replace(st2, r2, lo, frozenset({name}))
                        else:
                            rep2.done = True
                        continue
                    if new_att.killed and not att2.killed:
                        # the new demand's clearing price now exceeds this
                        # replica's bid: its attempt shortens into a kill
                        tel.count("fleet.preempt_outbid")
                    sm.update(reg2, new_att.launch, new_att.end)
                    token_counter += 1
                    rep2.token = token_counter
                    rep2.active = (new_att, pl2, init2, start2, reg2)
                    push(new_att.end, _END, (job_id, r2, rep2.token))

        def replace(st: _JobState, r_idx: int, now: float, exclude: frozenset[str]) -> None:
            rep = st.replicas[r_idx]
            # keep replicas apart: avoid types a sibling is already running
            # on, falling back to overlap rather than stranding the replica
            sibling_types = frozenset(
                rep2.active[1].instance.name
                for r2, rep2 in st.replicas.items()
                if r2 != r_idx and rep2.active is not None
            )
            feasible = self._feasible(st.job, exclude | sibling_types)
            if not feasible:
                feasible = self._feasible(st.job, exclude)
            if not feasible:
                rep.done = True
                return
            with tel.span("fleet.migrate", job=st.job.id, replica=r_idx):
                self.ctx.spot_prices_now = self._spot_prices(now)
                remaining = st.job.work_s - rep.saved_ref
                placements = self.policy.place(st.job, now, remaining, feasible, self.ctx, k=1)
                spawn_attempt(st, r_idx, placements[0], now)

        def record_attempt(
            st: _JobState, r_idx: int, att, placement: Placement, initial_ref: float,
            end: float, termination: Termination, cost: float,
            killed: bool, completed: bool, cancelled: bool, saved_after_ref: float,
            self_terminated: bool = False,
        ) -> None:
            work_start = min(att.launch + self.params.t_r, end)
            records.append(
                AttemptRecord(
                    job_id=st.job.id,
                    replica=r_idx,
                    instance=placement.instance.name,
                    bid=placement.bid,
                    launch=att.launch,
                    end=end,
                    termination=termination,
                    cost=cost,
                    work_start=work_start,
                    initial_saved_ref=initial_ref,
                    saved_after_ref=saved_after_ref,
                    killed=killed,
                    completed=completed,
                    cancelled=cancelled,
                    self_terminated=self_terminated,
                )
            )

        for job in workload:
            push(job.arrival_s, _ARRIVAL, (job,))

        while heap:
            now, kind, _, payload = heapq.heappop(heap)

            if kind == _ARRIVAL:
                (job,) = payload
                feasible = self._feasible(job)
                if not feasible:
                    states[job.id] = _JobState(job=job, replicas={})
                    continue
                with tel.span("fleet.place", job=job.id):
                    self.ctx.spot_prices_now = self._spot_prices(now)
                    placements = self.policy.place(job, now, job.work_s, feasible, self.ctx)
                    st = _JobState(
                        job=job, replicas={r: _Replica() for r in range(len(placements))}
                    )
                    states[job.id] = st
                    for r_idx, placement in enumerate(placements):
                        spawn_attempt(st, r_idx, placement, now)
                continue

            job_id, r_idx, token = payload
            st = states[job_id]
            rep = st.replicas[r_idx]
            if st.completed_at is not None or rep.token != token or rep.active is None:
                continue  # stale event (cancelled or superseded)
            att, placement, initial_ref, _, _reg = rep.active
            rep.token = None
            rep.active = None
            scale = self._scale(placement.instance)

            tel.count("fleet.checkpoints", att.n_checkpoints)
            if att.completed:
                st.completed_at = att.end
                tel.count("fleet.completions")
                if tel.enabled:
                    tel.event("fleet.complete", att.end, job=job_id, replica=r_idx)
                record_attempt(
                    st, r_idx, att, placement, initial_ref, att.end,
                    Termination.USER, att.cost, False, True, False, st.job.work_s,
                )
                rep.saved_ref = st.job.work_s
                rep.done = True
                # first replica wins: truncate and bill siblings up to now
                for r2, rep2 in st.replicas.items():
                    if r2 == r_idx or rep2.active is None:
                        continue
                    att2, placement2, init2, _, reg2 = rep2.active
                    rep2.token = None
                    rep2.active = None
                    rep2.done = True
                    if reg2 is not None:  # cancelled: its demand ends now
                        self.market[placement2.instance.name].truncate(reg2, now)
                    if att2.launch < now - _EPS:
                        # bill the truncated run at the prices it actually saw
                        # (the cleared view under a live market)
                        tr2 = self._market_view(placement2, own_reg=reg2)
                        cost2 = billing.run_cost(
                            tr2, att2.launch, now, Termination.USER, self.params.billing_period_s
                        )
                        record_attempt(
                            st, r2, att2, placement2, init2, now,
                            Termination.USER, cost2, False, False, True, init2,
                        )
                continue

            # attempt ended without completing: kill or horizon
            saved_after_ref = att.saved_work_s / scale
            if saved_after_ref < rep.saved_ref - _EPS:
                raise AssertionError(
                    f"job {job_id}: checkpointed work shrank {rep.saved_ref} -> {saved_after_ref}"
                )
            if att.killed:
                rep.n_kills += 1
                tel.count("fleet.kills")
                tel.count("fleet.work_lost_s", float(att.work_done_s - att.saved_work_s))
                if tel.enabled:
                    tel.event(
                        "fleet.kill", att.end,
                        job=job_id, replica=r_idx, instance=placement.instance.name,
                    )
            record_attempt(
                st, r_idx, att, placement, initial_ref, att.end,
                att.termination(), att.cost, att.killed, False, False, saved_after_ref,
                self_terminated=att.self_terminated,
            )
            rep.saved_ref = saved_after_ref
            # out-of-bid kills and ACC self-terminations both re-enter placement
            evicted = att.killed or att.self_terminated
            if evicted and self.migrate and rep.n_migrations < self.max_migrations_per_replica:
                rep.n_migrations += 1
                tel.count("fleet.migrations")
                replace(st, r_idx, att.end + _EPS, frozenset({placement.instance.name}))
            else:
                rep.done = True

        outcomes: dict[int, JobOutcome] = {}
        per_job: dict[int, list[AttemptRecord]] = {}
        for r in records:
            per_job.setdefault(r.job_id, []).append(r)
        for job_id, st in states.items():
            recs = per_job.get(job_id, [])
            outcomes[job_id] = JobOutcome(
                job=st.job,
                completed=st.completed_at is not None,
                completion_time=st.completed_at if st.completed_at is not None else math.inf,
                cost=sum(r.cost for r in recs),
                n_kills=sum(rep.n_kills for rep in st.replicas.values()),
                n_migrations=sum(rep.n_migrations for rep in st.replicas.values()),
                attempts=recs,
            )
        return FleetResult(
            policy=self.policy.name,
            scheme=self.scheme,
            outcomes=outcomes,
            records=records,
            horizon=self.horizon,
        )
