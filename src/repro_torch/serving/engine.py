"""`ServingScenario` + `run_serving`: the serving-tier simulation engine.

The port of :mod:`repro.serving.engine`.  One scenario pins a ``(policy ×
bid-margin × seed)`` grid of serving cells: each cell runs the same diurnal
traffic (per seed), the same spot markets (per type × seed,
:func:`repro_torch.core.market.ensemble_seed`-decorrelated), and one
autoscaler policy bidding ``margin × on_demand`` on every spot type.  Per
control period a cell (1) matures boots and drains, (2) clears each type's
auction — uncontended markets preempt by the out-of-bid rule,
``capacity``-limited markets through the uniform-price auction — (3) bills
and serves, and (4) lets the policy resize the spot tier through the
boot/drain pipelines.

Two backends, selected by ``run_serving(..., engine=)``:

* ``reference`` — one cell at a time, scalar state, per-segment
  :func:`repro_torch.market.clear_stack` auctions, host NumPy: the legible
  ground truth, a copy of the JAX package's.
* ``batch`` (``"auto"``) — the whole grid advances in lockstep waves of
  torch ops on ``device`` (the GPU unless ``device="cpu"``); contended
  periods clear every spot type at once through
  :func:`repro_torch.market.clear_periods_torch`, with the cell axis as the
  vectorized axis (each cell is its own market universe).

Bit-identical parity is structural: both backends read the *same*
precomputed host inputs (:func:`_serving_inputs` — traffic paths,
period-sampled base prices, free depths, hazard factors, the displacement
ladder), call the same elementwise helpers (:mod:`repro_torch.serving.replicas`
and its torch twins, the policies) in the same per-period order, and
accumulate floats in the same association order.  The batch engine clears
at the fixed depth ``max_spot`` in every period where the JAX package's
batch engine reads back the deepest live stack: lanes beyond a cell's stack
are ``-inf`` and rungs beyond ``max_spot`` are ``+inf``, so neither can
meet, and the results are the same bits with no host read-back in the
period loop.  With ``base_rps=0`` nothing ever bids and the recorded
``spot_price`` is the exogenous trace, bit for bit.

Traffic, trace sampling, hazard factors, the ladder and the SLO scoring
(``np.sin`` / ``np.exp`` / ``np.log``, whose bits a device does not
reproduce) stay host NumPy: the batch engine copies its inputs to the
device once and brings the per-period arrays and totals home once, after
its period loop.

Fault sites honored: ``serving.replica_boot`` (a maturing boot batch is
lost — any action kind) and ``serving.scale_decision`` (the period's
scaling decision is skipped).  Both are domain effects folded into the
result, never raised.  With a plan active the batch engine fires them cell
by cell with the same ``(site, key)`` in the same order as the JAX
package's, reading the maturing boots back once a period.
"""

from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from repro_torch import faults
from repro_torch.core.market import (
    HOUR,
    InstanceType,
    TraceModel,
    ensemble_seed,
    get_instance,
    sample_traces_batch,
)
from repro_torch.core.schemes import FailurePdf
from repro_torch.engine.base import resolve_device
from repro_torch.engine.scenario import _canonical_market_params
from repro_torch.market import (
    MarketParams,
    clear_periods_torch,
    clear_stack,
    free_depth,
    marginal_price,
    resolve_ref_price,
)
from repro_torch.obs import telemetry as obs
from repro_torch.serving import replicas as rep
from repro_torch.serving.autoscaler import AutoscalerPolicy, policy_registry
from repro_torch.serving.slo import ServingResult, summarize
from repro_torch.serving.traffic import TrafficModel, rates_batch

__all__ = ["ServingScenario", "run_serving", "SERVING_ENGINES"]

SERVING_ENGINES = ("reference", "batch")

faults.register_site(
    "serving.replica_boot",
    "one hit per cell-period with a maturing boot batch (any kind: the batch is lost)",
)
faults.register_site(
    "serving.scale_decision",
    "one hit per cell-period (any kind: the period's scaling decision is skipped)",
)

#: Over-provisioning guard: a hazard-aware policy buys at most 5x the
#: hazard-free capacity (1 / (1 - h) with the denominator floored at 0.2),
#: so a near-certain preemption window cannot request unbounded replicas.
_HAZARD_FLOOR = 0.2


def _default_on_demand() -> InstanceType:
    return get_instance("m1.xlarge")


def _default_spot() -> tuple[InstanceType, ...]:
    return (get_instance("m1.xlarge"), get_instance("c1.xlarge"))


@dataclasses.dataclass(frozen=True, eq=False)
class ServingScenario:
    """Declarative serving study: traffic × tier × autoscaler × market.

    A frozen value object with :meth:`canonical` for suite hashing, the
    serving analogue of :class:`repro_torch.engine.scenario.Scenario`.  The cell
    grid is ``policies × bid_margins × seeds``; each seed draws both a
    traffic path and one price trace per spot type.
    """

    # -- traffic (see repro_torch.serving.traffic.TrafficModel)
    base_rps: float = 2000.0
    diurnal_amplitude: float = 0.6
    diurnal_period_s: float = 24 * HOUR
    diurnal_phase_s: float = 0.0
    flash_crowds: int = 0
    flash_magnitude: float = 3.0
    flash_duration_s: float = 1800.0
    jitter: float = 1.0
    horizon_days: float = 3.0
    control_period_s: float = 300.0
    seeds: tuple[int, ...] = (0,)
    # -- replica tier
    on_demand_replicas: int = 2
    on_demand_type: InstanceType = dataclasses.field(default_factory=_default_on_demand)
    spot_types: tuple[InstanceType, ...] = dataclasses.field(default_factory=_default_spot)
    #: rps one reference (8-ECU) replica serves; heterogeneous types scale
    #: by ECU (:func:`repro_torch.serving.replicas.replica_rps`)
    rps_capacity_ref: float = 100.0
    boot_delay_s: float = 600.0
    drain_delay_s: float = 300.0
    #: per-type replica ceiling (also the lane depth of the batch auction)
    max_spot: int = 64
    # -- autoscaler
    policies: tuple[str, ...] = ("target", "threshold", "hazard")
    target_utilization: float = 0.7
    threshold_hi: float = 0.85
    threshold_lo: float = 0.5
    #: threshold step size in reference-replica units
    threshold_step: int = 2
    #: look-ahead window for the hazard-aware over-provisioning factor
    hazard_window_s: float = 1 * HOUR
    # -- market
    bid_margins: tuple[float, ...] = (0.6,)
    capacity: int | None = None
    market: MarketParams = dataclasses.field(default_factory=MarketParams)
    # -- SLO
    slo_p99_s: float = 1.0

    def __post_init__(self):
        self.traffic_model()  # delegate traffic validation
        if self.control_period_s <= 0:
            raise ValueError("control_period_s must be positive")
        if self.horizon_days * 24 * HOUR < self.control_period_s:
            raise ValueError("horizon must cover at least one control period")
        if not self.seeds or not self.bid_margins or not self.policies:
            raise ValueError("seeds, bid_margins and policies must be non-empty")
        if self.on_demand_replicas < 0:
            raise ValueError("on_demand_replicas must be >= 0")
        if not self.spot_types:
            raise ValueError("spot_types must be non-empty")
        if self.rps_capacity_ref <= 0:
            raise ValueError("rps_capacity_ref must be positive")
        if self.boot_delay_s < 0 or self.drain_delay_s < 0:
            raise ValueError("boot/drain delays must be >= 0")
        if self.max_spot < 1:
            raise ValueError(f"max_spot must be >= 1, got {self.max_spot}")
        if self.threshold_step < 1:
            raise ValueError(f"threshold_step must be >= 1, got {self.threshold_step}")
        if self.hazard_window_s <= 0:
            raise ValueError("hazard_window_s must be positive")
        if self.capacity is not None and self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")
        if self.slo_p99_s <= 0:
            raise ValueError("slo_p99_s must be positive")

    # -- derived views ------------------------------------------------------

    def traffic_model(self) -> TrafficModel:
        return TrafficModel(
            base_rps=self.base_rps,
            diurnal_amplitude=self.diurnal_amplitude,
            diurnal_period_s=self.diurnal_period_s,
            diurnal_phase_s=self.diurnal_phase_s,
            flash_crowds=self.flash_crowds,
            flash_magnitude=self.flash_magnitude,
            flash_duration_s=self.flash_duration_s,
            jitter=self.jitter,
        )

    @property
    def horizon_s(self) -> float:
        return self.horizon_days * 24 * HOUR

    @property
    def n_periods(self) -> int:
        return int(self.horizon_s // self.control_period_s)

    @property
    def n_cells(self) -> int:
        return len(self.policies) * len(self.bid_margins) * len(self.seeds)

    def bids(self) -> np.ndarray:
        """Absolute $/h bids, ``(n_margins, n_types)`` — ``margin ×
        on_demand`` on the catalog's $0.001 grid (the
        ``Scenario.market_bids`` rounding)."""
        return np.array(
            [[round(m * it.on_demand, 3) for it in self.spot_types] for m in self.bid_margins]
        )

    def canonical(self) -> dict:
        """Stable plain-dict form of every engine-visible field (the
        :mod:`repro_torch.suite.hashing` contract; see
        :meth:`repro_torch.engine.scenario.Scenario.canonical`)."""

        def inst(it: InstanceType) -> dict:
            return {
                "name": it.name,
                "hardware": it.hardware,
                "region": it.region,
                "os": it.os,
                "on_demand": float(it.on_demand),
                "compute_units": float(it.compute_units),
            }

        return {
            "kind": "serving",
            "base_rps": float(self.base_rps),
            "diurnal_amplitude": float(self.diurnal_amplitude),
            "diurnal_period_s": float(self.diurnal_period_s),
            "diurnal_phase_s": float(self.diurnal_phase_s),
            "flash_crowds": int(self.flash_crowds),
            "flash_magnitude": float(self.flash_magnitude),
            "flash_duration_s": float(self.flash_duration_s),
            "jitter": float(self.jitter),
            "horizon_days": float(self.horizon_days),
            "control_period_s": float(self.control_period_s),
            "seeds": [int(s) for s in self.seeds],
            "on_demand_replicas": int(self.on_demand_replicas),
            "on_demand_type": inst(self.on_demand_type),
            "spot_types": [inst(it) for it in self.spot_types],
            "rps_capacity_ref": float(self.rps_capacity_ref),
            "boot_delay_s": float(self.boot_delay_s),
            "drain_delay_s": float(self.drain_delay_s),
            "max_spot": int(self.max_spot),
            "policies": [str(p) for p in self.policies],
            "target_utilization": float(self.target_utilization),
            "threshold_hi": float(self.threshold_hi),
            "threshold_lo": float(self.threshold_lo),
            "threshold_step": int(self.threshold_step),
            "hazard_window_s": float(self.hazard_window_s),
            "bid_margins": [float(m) for m in self.bid_margins],
            "capacity": None if self.capacity is None else int(self.capacity),
            "market": _canonical_market_params(self.market),
            "slo_p99_s": float(self.slo_p99_s),
        }


# ---------------------------------------------------------------------------
# Shared precomputed inputs — the root of cross-backend parity
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _ServingInputs:
    """Everything period-indexed both backends read, computed exactly once.

    ``base[t, s, p]`` is spot type ``t``'s exogenous price under seed ``s``
    sampled at the *start* of period ``p`` (the control loop acts on the
    price quote it observes when the period opens); ``free`` is the matching
    auction free depth (``None`` for an uncontended market).
    """

    n_periods: int
    period_s: float
    period_h: float
    rates: np.ndarray        # (S, P) offered rps
    base: np.ndarray         # (T, S, P) exogenous price at period start
    free: np.ndarray | None  # (T, S, P) int64 auction free depth
    bids: np.ndarray         # (M, T) absolute $/h
    rps: np.ndarray          # (T,) per-replica rps
    od_rps: float
    od_price: float
    hazard_factor: np.ndarray  # (M, T, S) over-provisioning factor, >= 1
    boot_k: int
    drain_k: int
    #: (T, S, K, P) marginal price of rank k+1 (K = max_spot), contended only
    ladder: np.ndarray | None = None


@functools.lru_cache(maxsize=8)
def _serving_inputs(scenario: ServingScenario) -> _ServingInputs:
    period_s = scenario.control_period_s
    P = scenario.n_periods
    S, T = len(scenario.seeds), len(scenario.spot_types)

    rates = rates_batch(scenario.traffic_model(), scenario.horizon_s, period_s, scenario.seeds)

    # one batched draw, type-major then seed — the Scenario.materialize recipe
    models, streams = [], []
    for it in scenario.spot_types:
        m = TraceModel.for_instance(it)
        for s in scenario.seeds:
            models.append(m)
            streams.append(ensemble_seed(it, s))
    traces = sample_traces_batch(models, scenario.horizon_s, streams)

    starts = np.arange(P, dtype=np.float64) * period_s
    base = np.empty((T, S, P))
    free = np.empty((T, S, P), dtype=np.int64) if scenario.capacity is not None else None
    bids = scenario.bids()
    hazard_factor = np.empty((len(scenario.bid_margins), T, S))
    for ti, it in enumerate(scenario.spot_types):
        for si in range(S):
            tr = traces[ti * S + si]
            idx = np.clip(np.searchsorted(tr.times, starts, side="right") - 1, 0, len(tr.prices) - 1)
            base[ti, si] = tr.prices[idx]
            if free is not None:
                ref = resolve_ref_price(scenario.market, it.on_demand, tr)
                free[ti, si] = free_depth(base[ti, si], scenario.capacity, ref, scenario.market)
            for mi in range(len(scenario.bid_margins)):
                h = FailurePdf.from_trace(tr, bids[mi, ti]).hazard(0.0, scenario.hazard_window_s)
                hazard_factor[mi, ti, si] = 1.0 / max(1.0 - h, _HAZARD_FLOOR)

    rps = np.array([rep.replica_rps(it, scenario.rps_capacity_ref) for it in scenario.spot_types])
    ladder = None
    if free is not None:
        # the displacement ladder is bid-independent: one vectorized
        # marginal_price over the whole horizon feeds every period's
        # clearing; a cell clears at most max_spot lanes, so deeper rungs
        # are +inf (an inactive -inf lane meets nothing)
        ladder = marginal_price(
            base[:, :, None, :],
            free[:, :, None, :],
            np.arange(1, scenario.max_spot + 1)[None, None, :, None],
            scenario.capacity,
            scenario.market,
        )
    return _ServingInputs(
        n_periods=P,
        period_s=period_s,
        period_h=period_s / HOUR,
        rates=rates,
        base=base,
        free=free,
        bids=bids,
        rps=rps,
        od_rps=scenario.on_demand_replicas
        * rep.replica_rps(scenario.on_demand_type, scenario.rps_capacity_ref),
        od_price=float(scenario.on_demand_type.on_demand),
        hazard_factor=hazard_factor,
        boot_k=max(1, int(np.ceil(scenario.boot_delay_s / period_s))),
        drain_k=max(1, int(np.ceil(scenario.drain_delay_s / period_s))),
        ladder=ladder,
    )


def _resolve_policies(scenario: ServingScenario, overrides) -> list[AutoscalerPolicy]:
    registry = dict(policy_registry(scenario))
    if overrides:
        registry.update(overrides)
    missing = [p for p in scenario.policies if p not in registry]
    if missing:
        raise ValueError(f"unknown autoscaler policies {missing}; known: {sorted(registry)}")
    return [registry[p] for p in scenario.policies]


def _cell_keys(scenario: ServingScenario) -> list[str]:
    """Stable per-cell fault keys, policy-major — identical across backends
    (fault determinism is per ``(site, key)``, so cross-cell firing order
    never matters)."""
    return [
        f"{pol}|{float(margin)!r}|{int(seed)}"
        for pol in scenario.policies
        for margin in scenario.bid_margins
        for seed in scenario.seeds
    ]


def _clear_uncontended(bid, base_p, n_demand):
    """Out-of-bid preemption in an infinitely deep market: every replica
    whose bid meets the exogenous price runs *at* that price; the rest are
    preempted.  ``(served, price)`` — price is ``base_p`` untouched (the
    zero-demand anchor is bitwise by construction)."""
    served = np.where(bid >= base_p, n_demand, np.int64(0))
    return served.astype(np.int64), base_p


# ---------------------------------------------------------------------------
# Reference backend: one cell at a time, the legible ground truth
# ---------------------------------------------------------------------------


def _run_reference(scenario: ServingScenario, inp: _ServingInputs, policies):
    P, T = inp.n_periods, len(scenario.spot_types)
    Pl, M, S = len(policies), len(scenario.bid_margins), len(scenario.seeds)
    C = Pl * M * S
    plan = faults.current()
    keys = _cell_keys(scenario)

    cap_rps = np.zeros((C, P))
    spot_price = np.zeros((C, T, P))
    cost = np.zeros(C)
    served_req = np.zeros(C)
    offered_req = np.zeros(C)
    n_preempted = np.zeros(C, dtype=np.int64)
    n_scale_out = np.zeros(C, dtype=np.int64)
    n_scale_in = np.zeros(C, dtype=np.int64)
    n_boot_lost = np.zeros(C, dtype=np.int64)

    ones_t = np.ones(T)
    for ci in range(C):
        pi, rest = divmod(ci, M * S)
        mi, si = divmod(rest, S)
        policy = policies[pi]
        factor = inp.hazard_factor[mi, :, si] if policy.hazard_aware else ones_t
        bid = inp.bids[mi]  # (T,)
        n_run = np.zeros(T, dtype=np.int64)
        boot = np.zeros((T, inp.boot_k), dtype=np.int64)
        drain = np.zeros((T, inp.drain_k), dtype=np.int64)

        for p in range(P):
            # 1. boot maturation (fault: the whole maturing batch is lost)
            matured, boot = rep.advance_pipe(boot)
            if plan.enabled and matured.sum() > 0 and plan.fire("serving.replica_boot", f"{keys[ci]}|{p}"):
                n_boot_lost[ci] += matured.sum()
                matured = np.zeros_like(matured)
            n_run = n_run + matured
            # 2. drain maturation (a preemption may have beaten the drain)
            matured_d, drain = rep.advance_pipe(drain)
            removed = np.minimum(matured_d, n_run)
            n_run = n_run - removed
            # 3. auction clearing per type
            if inp.free is None:
                n_served, price = _clear_uncontended(bid, inp.base[:, si, p], n_run)
            else:
                n_served = np.zeros(T, dtype=np.int64)
                price = np.zeros(T)
                for t in range(T):
                    res = clear_stack(
                        np.full(int(n_run[t]), bid[t]),
                        float(inp.base[t, si, p]),
                        int(inp.free[t, si, p]),
                        scenario.capacity,
                        scenario.market,
                    )
                    n_served[t] = res.n_served
                    price[t] = res.price
            n_preempted[ci] += (n_run - n_served).sum()
            n_run = n_served
            # 4. capacity + 5. billing + 6. serving
            cap = rep.tier_capacity(inp.od_rps, n_run, inp.rps)
            cap_rps[ci, p] = cap
            spot_price[ci, :, p] = price
            cost[ci] = cost[ci] + rep.period_cost(
                scenario.on_demand_replicas, inp.od_price, n_run, price, inp.period_h
            )
            rate = inp.rates[si, p]
            served_req[ci] = served_req[ci] + np.minimum(rate, cap) * inp.period_s
            offered_req[ci] = offered_req[ci] + rate * inp.period_s
            # 7. autoscaler (fault: the period's decision is skipped)
            if plan.enabled and plan.fire("serving.scale_decision", f"{keys[ci]}|{p}"):
                continue
            desired = policy.desired_spot_rps(rate, inp.od_rps, cap - inp.od_rps)
            n_target = rep.target_counts(desired, inp.rps, factor, scenario.max_spot)
            commit = np.maximum(n_run + boot.sum(-1) - drain.sum(-1), 0)
            delta = n_target - commit
            headroom = np.maximum(scenario.max_spot - (n_run + boot.sum(-1)), 0)
            out = np.minimum(np.maximum(delta, 0), headroom)
            boot[:, -1] += out
            n_scale_out[ci] += out.sum()
            want_in = np.maximum(-delta, 0)
            cancelled = rep.cancel_latest(boot, want_in)
            drain[:, -1] += want_in - cancelled
            n_scale_in[ci] += want_in.sum()

    return cap_rps, spot_price, cost, served_req, offered_req, n_preempted, n_scale_out, n_scale_in, n_boot_lost


# ---------------------------------------------------------------------------
# Batch backend: the whole grid in lockstep waves of torch ops on the device
# ---------------------------------------------------------------------------


def _run_batch(scenario: ServingScenario, inp: _ServingInputs, policies, device: torch.device):
    P, T = inp.n_periods, len(scenario.spot_types)
    Pl, M, S = len(policies), len(scenario.bid_margins), len(scenario.seeds)
    C = Pl * M * S
    plan = faults.current()
    keys = _cell_keys(scenario)
    f64, i64 = torch.float64, torch.int64

    def put(a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    # policy-major cell axis: ci = (pi * M + mi) * S + si
    cell_mi = (np.arange(C) // S) % M
    cell_si = np.arange(C) % S
    bid_c = put(inp.bids[cell_mi], f64)                                   # (C, T)
    base_c = put(inp.base[:, cell_si, :].transpose(2, 1, 0), f64)         # (P, C, T)
    rate_c = put(inp.rates[cell_si].T, f64)                               # (P, C)
    hazard_c = inp.hazard_factor[cell_mi, :, cell_si]                     # (C, T)
    factor_np = np.ones((C, T))
    slices = []
    for pi, policy in enumerate(policies):
        sl = slice(pi * M * S, (pi + 1) * M * S)
        slices.append((sl, policy))
        if policy.hazard_aware:
            factor_np[sl] = hazard_c[sl]
    factor_c = put(factor_np, f64)
    rps = put(inp.rps, f64)
    if inp.free is not None:
        # lanes (T, M*K, C) as the JAX package lays them out (lane m*K + r is
        # margin m's rank r), at the fixed depth K = max_spot: a lane is
        # active when its margin is the cell's and its rank is below the
        # cell's live stack; the ladder's rungs past K stay +inf
        K = scenario.max_spot
        lane_margin = np.repeat(np.arange(M), K)
        lane_rank = put(np.tile(np.arange(K), M), i64)[None, :, None]     # (1, M*K, 1)
        lane_of_cell = put(lane_margin[:, None] == cell_mi[None, :])      # (M*K, C)
        lane_bids = put(np.repeat(inp.bids.T, K, axis=1), f64)            # (T, M*K)
        ladder_p = put(inp.ladder.transpose(3, 0, 2, 1), f64)             # (P, T, K, S)
        cell_si_t = put(cell_si, i64)
        lad = torch.full((T, M * K, C), float("inf"), dtype=f64, device=device)

    cap_rps = torch.zeros((P, C), dtype=f64, device=device)
    spot_price = torch.zeros((P, C, T), dtype=f64, device=device)
    cost = torch.zeros(C, dtype=f64, device=device)
    served_req = torch.zeros(C, dtype=f64, device=device)
    offered_req = torch.zeros(C, dtype=f64, device=device)
    n_preempted = torch.zeros(C, dtype=i64, device=device)
    n_scale_out = torch.zeros(C, dtype=i64, device=device)
    n_scale_in = torch.zeros(C, dtype=i64, device=device)
    n_boot_lost = torch.zeros(C, dtype=i64, device=device)

    n_run = torch.zeros((C, T), dtype=i64, device=device)
    boot = torch.zeros((C, T, inp.boot_k), dtype=i64, device=device)
    drain = torch.zeros((C, T, inp.drain_k), dtype=i64, device=device)
    desired = torch.empty(C, dtype=f64, device=device)

    # the period loop reads nothing back unless a fault plan is active (a
    # profiler range names it, so a trace can count what happens inside)
    with torch.profiler.record_function("serving.period_loop"):
        for p in range(P):
            # 1. boot maturation
            matured, boot = rep.advance_pipe_torch(boot)
            if plan.enabled:  # chaos runs read the maturing boots back for per-cell keys
                per_cell = matured.sum(-1).cpu().numpy()
                lost = [ci for ci in range(C)
                        if per_cell[ci] > 0 and plan.fire("serving.replica_boot", f"{keys[ci]}|{p}")]
                if lost:
                    idx = torch.as_tensor(lost, dtype=i64, device=device)
                    n_boot_lost[idx] += matured[idx].sum(-1)
                    matured[idx] = 0
            n_run = n_run + matured
            # 2. drain maturation
            matured_d, drain = rep.advance_pipe_torch(drain)
            removed = torch.minimum(matured_d, n_run)
            n_run = n_run - removed
            # 3. auction clearing
            base_p = base_c[p]                                                 # (C, T)
            if inp.free is None:
                n_served = torch.where(bid_c >= base_p, n_run, 0)
                price = base_p
            else:
                active = (lane_rank < n_run.T[:, None, :]) & lane_of_cell      # (T, M*K, C)
                lad[:, :K, :] = torch.index_select(ladder_p[p], 2, cell_si_t)
                served_t, price_t = clear_periods_torch(lane_bids, active, base_p.T, lad)
                n_served, price = served_t.T, price_t.T
            n_preempted += (n_run - n_served).sum(-1)
            n_run = n_served
            # 4-6. capacity, billing, serving
            cap = rep.tier_capacity_torch(inp.od_rps, n_run, rps)
            cap_rps[p] = cap
            spot_price[p] = price
            cost = cost + rep.period_cost_torch(
                scenario.on_demand_replicas, inp.od_price, n_run, price, inp.period_h
            )
            rate = rate_c[p]
            served_req = served_req + torch.minimum(rate, cap) * inp.period_s
            offered_req = offered_req + rate * inp.period_s
            # 7. autoscaler
            for sl, policy in slices:
                desired[sl] = policy.desired_spot_rps(rate[sl], inp.od_rps, cap[sl] - inp.od_rps)
            n_target = rep.target_counts_torch(desired, rps, factor_c, scenario.max_spot)
            booting = boot.sum(-1)
            commit = torch.clamp(n_run + booting - drain.sum(-1), min=0)
            delta = n_target - commit
            headroom = torch.clamp(scenario.max_spot - (n_run + booting), min=0)
            out = torch.minimum(torch.clamp(delta, min=0), headroom)
            want_in = torch.clamp(-delta, min=0)
            if plan.enabled:
                skip = [bool(plan.fire("serving.scale_decision", f"{keys[ci]}|{p}")) for ci in range(C)]
                if any(skip):
                    mask = torch.as_tensor(skip, device=device)
                    out[mask] = 0
                    want_in[mask] = 0
            boot[:, :, -1] += out
            n_scale_out += out.sum(-1)
            cancelled = rep.cancel_latest_torch(boot, want_in)
            drain[:, :, -1] += want_in - cancelled
            n_scale_in += want_in.sum(-1)

    # one trip home, after the loop
    home = (cap_rps.T, spot_price.permute(1, 2, 0), cost, served_req, offered_req,
            n_preempted, n_scale_out, n_scale_in, n_boot_lost)
    return tuple(np.ascontiguousarray(x.cpu().numpy()) for x in home)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


def run_serving(
    scenario: ServingScenario,
    engine: str = "auto",
    policies: dict[str, AutoscalerPolicy] | None = None,
    device=None,
) -> ServingResult:
    """Run the serving grid and fold SLO metrics into a :class:`ServingResult`.

    ``engine`` is ``"reference"`` (host NumPy; it takes no device and
    raises when given a CUDA one), ``"batch"``, or ``"auto"`` (= batch).
    The batch engine runs on ``device``: the GPU unless ``device="cpu"``,
    raising when there is no GPU.  ``policies`` overrides/extends the
    built-in registry by name — any object satisfying
    :class:`repro_torch.serving.autoscaler.AutoscalerPolicy`.
    """
    name = {"auto": "batch"}.get(engine, engine)
    if name not in SERVING_ENGINES:
        raise ValueError(f"unknown serving engine {engine!r}; expected {SERVING_ENGINES + ('auto',)}")
    if name == "reference":
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError("the reference serving engine runs on the host; it takes no device")
        dev = None
    else:
        dev = resolve_device(device)
    resolved = _resolve_policies(scenario, policies)
    inp = _serving_inputs(scenario)

    tel = obs.current()
    t0 = time.perf_counter()
    with tel.span("serving.run", engine=name, n_cells=scenario.n_cells, n_periods=inp.n_periods,
                  device=str(dev) if dev is not None else "host"):
        if name == "batch":
            raw = _run_batch(scenario, inp, resolved, dev)
        else:
            raw = _run_reference(scenario, inp, resolved)
        (cap_rps, spot_price, cost, served, offered,
         n_preempted, n_scale_out, n_scale_in, n_boot_lost) = raw
    wall_s = time.perf_counter() - t0

    grid = (len(resolved), len(scenario.bid_margins), len(scenario.seeds))
    rates_c = inp.rates[np.tile(np.arange(len(scenario.seeds)), grid[0] * grid[1])]
    availability, p99_mean, violation_s, cost_per_mreq = summarize(
        scenario, rates_c, cap_rps, served, offered, cost
    )

    if tel.enabled:
        tel.count("serving.scale_out", int(n_scale_out.sum()))
        tel.count("serving.scale_in", int(n_scale_in.sum()))
        tel.count("serving.preempt_outbid", int(n_preempted.sum()))
        tel.count("serving.boot_lost", int(n_boot_lost.sum()))
        tel.count("serving.slo_violation_s", float(violation_s.sum()))

    def g(a, *tail):
        return np.ascontiguousarray(a.reshape(grid + tail))

    T, P = len(scenario.spot_types), inp.n_periods
    return ServingResult(
        policies=tuple(p.name for p in resolved),
        bid_margins=tuple(float(m) for m in scenario.bid_margins),
        seeds=tuple(int(s) for s in scenario.seeds),
        spot_types=tuple(it.name for it in scenario.spot_types),
        engine=name,
        wall_s=wall_s,
        availability=g(availability),
        p99_latency_s=g(p99_mean),
        slo_violation_s=g(violation_s),
        cost=g(cost),
        served_requests=g(served),
        offered_requests=g(offered),
        cost_per_mreq=g(cost_per_mreq),
        n_preempted=g(n_preempted),
        n_scale_out=g(n_scale_out),
        n_scale_in=g(n_scale_in),
        n_boot_lost=g(n_boot_lost),
        capacity_rps=g(cap_rps, P),
        spot_price=g(spot_price, T, P),
        rates=inp.rates.copy(),
    )
