"""Capacity-constrained spot market: ``python -m repro_torch.launch.market_contention``.

The port of ``examples/market_contention.py``: two vignettes on a
capacity-limited m1.xlarge pool (us-east-1, on-demand $0.68/h, capacity 4).

  1. **Engine sweep** — one contended :class:`~repro_torch.engine.Scenario`
     per fleet depth ``demand`` (HOUR, bid $0.385, a 24 h job on a 20-day
     trace), each through ``engine.run`` — on the card unless ``--device
     cpu``: as the block outgrows the pool's free depth, the auction-cleared
     price climbs the displacement ladder, kills appear, and past what the
     pool holds nothing is for sale.
  2. **Fleet replay** — the same pool under the host
     :class:`~repro_torch.fleet.FleetController`: four staggered 6-hour jobs
     re-price each other through the demand ledger, an over-capacity arrival
     queues for a freed slot, and with the online re-bid policy a later job
     outbids and preempts a running incumbent mid-flight.

Prints the example's tables.

    PYTHONPATH=src python -m repro_torch.launch.market_contention --device cpu
    PYTHONPATH=src python -m repro_torch.launch.market_contention
"""

from __future__ import annotations

import argparse

from repro_torch.core import HOUR, Scheme, constant_trace, get_instance, synthetic_trace
from repro_torch.engine import Scenario, run
from repro_torch.fleet import ClearingRebid, CostGreedyPolicy, FleetController, Workload
from repro_torch.market import MarketParams

IT = get_instance("m1.xlarge", region="us-east-1")  # on-demand $0.68/h
CAPACITY = 4
DEMANDS = (1, 2, 3, 4, 5)
BID = 0.385


def sweep_scenario(demand: int) -> Scenario:
    """The engine sweep's study at fleet depth ``demand`` (<= CAPACITY)."""
    return Scenario.from_trace(
        synthetic_trace(IT, 20, seed=3), 24 * 3600.0, [BID], schemes=(Scheme.HOUR,),
        capacity=CAPACITY, demand=demand, market=MarketParams(ref_price=IT.on_demand),
    )


def engine_sweep(device=None) -> dict:
    """Vignette 1; returns ``{demand: EngineResult}`` for the depths the pool holds."""
    print(f"== engine sweep: fleet depth vs cleared price (capacity={CAPACITY}) ==")
    print(f"{'demand':>6} {'kills':>6} {'done':>5} {'finish (h)':>11} {'cost $':>8}")
    out = {}
    for demand in DEMANDS:
        if demand > CAPACITY:
            print(f"{demand:>6} {'pool exhausted: nothing for sale':>38}")
            continue
        res = out[demand] = run(sweep_scenario(demand), device=device)
        done = bool(res.completed[0, 0, 0])
        hours = res.completion_time[0, 0, 0] / HOUR if done else float("inf")
        print(f"{demand:>6} {int(res.n_kills[0, 0, 0]):>6} {str(done):>5} "
              f"{hours:>11.2f} {float(res.cost[0, 0, 0]):>8.2f}")
    print()
    return out


def replay_cases():
    """The fleet replay's three controllers' keyword sets, by label."""
    return (
        ("infinite depth", dict()),
        ("capacity-limited", dict(capacity=CAPACITY)),
        ("capacity + re-bid", dict(capacity=CAPACITY, bid_policy=ClearingRebid(margin=0.56, markup=0.10))),
    )


def fleet_replay() -> dict:
    """Vignette 2; returns ``{label: FleetResult}``."""
    print(f"== fleet replay: 4 staggered jobs, one type, capacity={CAPACITY} ==")
    traces = {IT.name: constant_trace(0.36, 60 * HOUR)}
    workload = Workload.from_sizes([6.0] * 4, interarrival_s=0.5 * HOUR)
    out = {}
    for label, kwargs in replay_cases():
        ctl = FleetController(
            [IT], traces, CostGreedyPolicy(), scheme=Scheme.HOUR, bid_margin=0.56, **kwargs,
        )
        res = out[label] = ctl.run(workload)
        print(f"-- {label}: cost ${res.total_cost:.2f}, kills {res.n_kills}, completed {res.n_completed}/4")
        for r in sorted(res.records, key=lambda r: (r.launch, r.job_id)):
            fate = "done" if r.completed else ("KILLED (outbid)" if r.killed else "ran")
            print(f"   job {r.job_id}: bid {r.bid:.3f}  [{r.launch / HOUR:5.2f}h, {r.end / HOUR:5.2f}h)  "
                  f"${r.cost:5.2f}  {fate}")
    print()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device of the engine sweep (default: the card)")
    args = ap.parse_args(argv)
    sweep = engine_sweep(args.device)
    replay = fleet_replay()
    return {"sweep": sweep, "replay": replay}


if __name__ == "__main__":
    main()
