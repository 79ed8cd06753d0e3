"""Auto-scale a replica tier through a flash crowd: ``python -m repro_torch.launch.spot_serving``.

The port of ``examples/spot_serving.py``: a day of diurnal traffic with one
flash crowd, served by two on-demand replicas plus a spot tier of
m1.xlarge / c1.xlarge scaled by the three built-in autoscaler policies
(target tracking, threshold steps and the hazard-aware spot variant),
bidding half vs just above on-demand in a capacity-limited pool of 12.  The
grid runs through :func:`repro_torch.serving.run_serving`'s batch engine —
on the card unless ``--device cpu`` — and the table is the example's, line
for line: per (policy, margin) the mean availability, p99 latency, SLO
violation hours, $ per million requests and preemptions.

    PYTHONPATH=src python -m repro_torch.launch.spot_serving --device cpu
    PYTHONPATH=src python -m repro_torch.launch.spot_serving
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.serving import ServingResult, ServingScenario, run_serving


def example_scenario() -> ServingScenario:
    """The example's scenario."""
    return ServingScenario(
        base_rps=1500.0,
        flash_crowds=1,          # one seeded flash crowd per day
        flash_magnitude=3.0,     # peaking at ~3x the diurnal rate
        horizon_days=1.0,
        seeds=(0, 1),
        bid_margins=(0.5, 1.1),  # below vs just above on-demand
        capacity=12,             # contended pool: preemption is by auction outbid
        max_spot=16,
    )


def table(result: ServingResult) -> list[str]:
    """The example's per-(policy, margin) lines, header first."""
    header = f"{'policy':<10} {'margin':>6} | {'avail':>7} {'p99 s':>7} {'viol h':>7} {'$/Mreq':>7} {'preempt':>7}"
    lines = [header, "-" * len(header)]
    for pi, policy in enumerate(result.policies):
        for mi, margin in enumerate(result.bid_margins):
            lines.append(
                f"{policy:<10} {margin:>6.2f} | "
                f"{result.availability[pi, mi].mean():>7.4f} "
                f"{result.p99_latency_s[pi, mi].mean():>7.3f} "
                f"{result.slo_violation_s[pi, mi].mean() / 3600.0:>7.2f} "
                f"{np.nanmean(result.cost_per_mreq[pi, mi]):>7.3f} "
                f"{result.n_preempted[pi, mi].sum():>7d}"
            )
    peak = result.rates.max(axis=1)
    lines.append(f"offered load peaks (rps per seed): {np.round(peak, 1).tolist()}")
    return lines


def main(argv=None) -> ServingResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device of the batch engine (default: the card)")
    args = ap.parse_args(argv)
    scenario = example_scenario()
    result = run_serving(scenario, device=args.device)  # engine="auto" = the lockstep batch backend
    print(f"{scenario.n_cells} cells x {scenario.n_periods} periods ({result.engine} engine, {result.wall_s:.2f}s)")
    for line in table(result):
        print(line)
    return result


if __name__ == "__main__":
    main()
