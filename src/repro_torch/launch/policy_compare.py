"""Paper §VII as one study: ``python -m repro_torch.launch.policy_compare``.

The port of ``examples/policy_compare.py``: the m1.xlarge eu-west-1 job of
500 minutes, 9 bids from 0.537 to 0.59 of on-demand, over an ensemble of
4 seeds × 3 start offsets (0, 11 and 23 hours) of 45-day traces, under all
six schemes.  The example simulates each (scheme, bid, trace) with the scalar
``simulate``; here the ensemble is one explicit-trace
:class:`~repro_torch.engine.Scenario` evaluated by ``engine.run`` — on the
card unless ``--device cpu`` — and the completed cells are averaged in the
example's order (bid-major, then trace).  Prints each scheme's mean cost,
time and cost × time of the completed jobs, ACC's and every scheme's
difference to OPT, and the paper's claims (ACC vs OPT: +5.94 % cost,
-10.77 % time, -5.56 % cost × time).

    PYTHONPATH=src python -m repro_torch.launch.policy_compare --device cpu
    PYTHONPATH=src python -m repro_torch.launch.policy_compare
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import ALL_SCHEMES, HOUR, Scheme, SimParams, get_instance, shift_trace, synthetic_trace
from repro_torch.engine import EngineResult, Scenario, run

#: The paper's ACC-vs-OPT claims (§VII), in percent.
PAPER_VS_OPT = {"cost_pct": 5.94, "time_pct": -10.77, "cost_time_pct": -5.56}


def ensemble_study() -> Scenario:
    """The example's ensemble as one explicit-trace study over all six schemes."""
    it = get_instance("m1.xlarge", "eu-west-1")
    od = it.on_demand
    bids = np.round(np.linspace(0.537 * od, 0.59 * od, 9), 3)
    traces = [
        shift_trace(synthetic_trace(it, horizon_days=45, seed=100 + s), off * HOUR)
        for s in range(4)
        for off in (0, 11, 23)
    ]
    return Scenario(
        work_s=500 * 60.0,
        bids=tuple(float(b) for b in bids),
        schemes=ALL_SCHEMES,
        params=SimParams(),
        traces=tuple(traces),
        labels=tuple(f"seed{100 + s}+{off}h" for s in range(4) for off in (0, 11, 23)),
    )


def summarize(res: EngineResult) -> dict[Scheme, tuple[float, float, float]]:
    """Per scheme: the mean cost ($), time (minutes) and cost × time of the
    completed cells, each mean over the example's bid-major list."""
    agg = {}
    for scheme in res.schemes:
        s = res.scheme_index(scheme)
        done = res.completed[:, :, s].T.ravel()  # (bid, trace) order
        cost = res.cost[:, :, s].T.ravel()[done]
        t = res.completion_time[:, :, s].T.ravel()[done]
        agg[scheme] = (
            float(np.mean(list(cost))),
            float(np.mean([x / 60 for x in t])),
            float(np.mean([c * x / 60 for c, x in zip(cost, t)])),
        )
    return agg


def vs_opt(agg) -> dict[str, float]:
    """ACC against OPT in percent, as the paper states it."""
    c, t, p = agg[Scheme.ACC]
    oc, ot, op = agg[Scheme.OPT]
    return {"cost_pct": 100 * (c / oc - 1), "time_pct": 100 * (t / ot - 1), "cost_time_pct": 100 * (p / op - 1)}


def table(agg) -> str:
    opt = agg[Scheme.OPT]
    lines = [f"{'scheme':8} {'cost $':>8} {'time min':>9} {'cost*time':>10} {'vs OPT cost':>12} {'vs OPT time':>12}"]
    for s, (c, tm, p) in agg.items():
        lines.append(
            f"{s.value:8} {c:8.3f} {tm:9.1f} {p:10.1f} {100 * (c / opt[0] - 1):+11.2f}% {100 * (tm / opt[1] - 1):+11.2f}%"
        )
    paper = PAPER_VS_OPT
    lines.append(
        f"paper: ACC vs OPT cost {paper['cost_pct']:+.2f}%, time {paper['time_pct']:+.2f}%, "
        f"cost*time {paper['cost_time_pct']:+.2f}%"
    )
    return "\n".join(lines)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    res = run(ensemble_study(), device=args.device)
    agg = summarize(res)
    print(table(agg))
    return {"agg": agg, "vs_opt": vs_opt(agg), "wall_s": res.wall_s, "cells": res.n_cells}


if __name__ == "__main__":
    main()
