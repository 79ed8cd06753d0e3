"""Reference backend: the scalar event loop, cell by cell, on the host.

Wraps :func:`repro_torch.core.simulator.simulate` over every (market, bid,
scheme) cell of a Scenario (the port of :mod:`repro.engine.reference`).
Slow but semantically canonical: the torch engine is defined by agreeing
with it (see :mod:`repro_torch.engine.parity`).  ADAPT failure pdfs are
cached per (market, bid).
"""

from __future__ import annotations

import time
from typing import Sequence

from repro_torch.core.schemes import FailurePdf, Scheme
from repro_torch.core.simulator import simulate
from repro_torch.engine.base import EngineResult, PhaseTimings, empty_result, fold_result_counters
from repro_torch.engine.scenario import MarketCell, Scenario
from repro_torch.obs import telemetry as obs


def scalar_fill(
    scenario: Scenario,
    markets: list[MarketCell],
    res: EngineResult,
    schemes: Sequence[Scheme],
) -> None:
    """Evaluate the ``schemes`` slice of ``scenario`` with the scalar event
    loop, writing outcomes (and ``res.sim_results`` when present) in place.
    The reference engine's one per-cell path."""
    for m, cellm in enumerate(markets):
        pdf_cache: dict[float, FailurePdf] = {}
        for b, bid in enumerate(scenario.market_bids(cellm)):
            for scheme in schemes:
                s = scenario.schemes.index(scheme)
                pdf = None
                if scheme == Scheme.ADAPT:
                    if bid not in pdf_cache:
                        pdf_cache[bid] = FailurePdf.from_trace(cellm.trace, bid)
                    pdf = pdf_cache[bid]
                r = simulate(
                    cellm.trace,
                    scheme,
                    scenario.work_s,
                    bid,
                    scenario.params,
                    pdf,
                    initial_saved_work=scenario.initial_saved_work,
                )
                res.completed[m, b, s] = r.completed
                res.completion_time[m, b, s] = r.completion_time
                res.cost[m, b, s] = r.cost
                res.n_checkpoints[m, b, s] = r.n_checkpoints
                res.n_kills[m, b, s] = r.n_kills
                res.n_self_terminations[m, b, s] = r.n_self_terminations
                res.work_lost_s[m, b, s] = r.work_lost_s
                if res.sim_results is not None:
                    res.sim_results[(m, b, s)] = r


class ReferenceEngine:
    """Scalar per-cell evaluation (the correctness anchor).

    ``keep_runs=True`` stores the full per-cell :class:`SimResult` (including
    the billed run list) in ``EngineResult.sim_results``, which
    ``EngineResult.cell`` returns; switch it off for large grids.
    """

    name = "reference"

    def __init__(self, keep_runs: bool = True):
        self.keep_runs = keep_runs

    def run(self, scenario: Scenario) -> EngineResult:
        markets = scenario.materialize()
        amb = obs.current()
        tel = amb if amb.enabled else obs.Telemetry()  # local phase recorder
        t0 = time.perf_counter()  # wall_s measures simulation, not trace gen
        res = empty_result(scenario, markets, self.name)
        if self.keep_runs:
            res.sim_results = {}
        with obs.activate(tel), tel.span("engine.run", engine=self.name) as root:
            with tel.span("scalar", schemes=[s.value for s in scenario.schemes]):
                scalar_fill(scenario, markets, res, scenario.schemes)
        res.wall_s = time.perf_counter() - t0
        res.timings = PhaseTimings.from_span(root, self.name, res.wall_s)
        if amb.enabled:
            fold_result_counters(amb, res)
        return res
