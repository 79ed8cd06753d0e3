"""``python -m repro_torch.suite``: the port's suite control-plane CLI.

The counterpart of ``python -m repro.suite``, with its flags, plus
``run --device`` (the GPU unless ``--device cpu``).  Subcommands::

    run    <suite.toml> [--store DIR] [--engine NAME] [--jobs N] [--device D]
           [--set key.path=value ...] [--dry-run] [--max-cells N]
           [--expect-all-hits] [--retries N] [--cell-timeout S]
    list   [--store DIR]
    gc     [--store DIR] [--dry-run]
    verify [--store DIR] [--repair] [--deep] [--parity DIR]
    trend  [--store DIR] [--history BENCH_history.jsonl] [--json]

``run`` executes only the cells missing from the store (rerun to resume an
interrupted sweep), simulating up to ``--jobs`` cells concurrently (store
writes stay on the main thread); ``--dry-run`` prints the expanded cell
list with per-field layer provenance and simulates nothing;
``--expect-all-hits`` fails (exit 1) unless the whole pass was served from
the store with zero ``engine.run``/``serving.run`` spans — the contract
"re-running an unchanged suite performs zero simulation".
A crashing or hung cell no longer aborts the pass: it retries under
``--retries``/``--cell-timeout`` (see :class:`repro_torch.suite.RetryPolicy`),
every completed cell is flushed, the failures are listed, and the exit
code is nonzero — rerun to heal.  Setting ``REPRO_FAULTS=<schedule>``
activates a :mod:`repro_torch.faults` plan around the pass.
``gc`` compacts superseded index lines and deletes orphaned payload files,
reporting the bytes reclaimed.  ``verify`` checks every payload against
its index checksum (``--deep``: full decode), ``--repair`` quarantines
corrupt entries so the next run re-simulates them, and ``--parity OTHER``
asserts bitwise payload agreement with another store (exit 1 on
divergence); ``OTHER`` may be a store of either package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys

from repro_torch import faults
from repro_torch import obs
from repro_torch.suite.layers import parse_override
from repro_torch.suite.runner import RetryPolicy, run_suite
from repro_torch.suite.spec import load_suite
from repro_torch.suite.store import DEFAULT_ROOT, RunStore
from repro_torch.suite.trend import DEFAULT_HISTORY, compute_trends, load_bench_history, render_trends

log = logging.getLogger("repro_torch.suite.cli")


def configure_logging(level: int | str | None = None) -> None:
    """Plain messages from the ``repro_torch`` loggers on stderr, at the
    level of ``REPRO_LOG`` (default ``info``)."""
    if level is None:
        level = os.environ.get("REPRO_LOG", "info")
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    root = logging.getLogger("repro_torch")
    for h in list(root.handlers):
        if getattr(h, "_repro_configured", False):
            root.removeHandler(h)
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(message)s"))
    handler._repro_configured = True
    root.addHandler(handler)
    root.setLevel(level)


def _cmd_run(args: argparse.Namespace) -> int:
    suite = load_suite(args.suite)
    cli = dict(parse_override(item) for item in args.set or [])
    if args.dry_run:
        cells = suite.expand(cli)
        print(f"# suite {suite.name}: {len(cells)} cells (dry run, nothing simulated)")
        for cell in cells:
            print(cell.describe())
        return 0
    store = RunStore(args.store)
    retry = RetryPolicy(
        max_attempts=max(1, args.retries),
        timeout_s=args.cell_timeout,
    )
    plan = faults.plan_from_env()
    plan_ctx = faults.activate(plan) if plan is not None else contextlib.nullcontext()
    if plan is not None:
        log.warning("fault injection active (%s): %s", faults.ENV_VAR, plan.describe())
    with plan_ctx, obs.Telemetry() as tel:
        report = run_suite(
            suite, store, engine=args.engine, cli=cli or None,
            max_cells=args.max_cells, jobs=args.jobs, retry=retry, device=args.device,
        )
    print(report.summary())
    if plan is not None and plan.log:
        log.warning(
            "injected %d faults: %s", len(plan.log),
            ", ".join(a.describe() for a in plan.log),
        )
    if report.n_failed:
        log.error(
            "%d cell(s) failed after retries: %s — completed cells are stored; "
            "rerun to retry only the failures",
            report.n_failed, ", ".join(o.cell.label for o in report.failures),
        )
        return 1
    if args.expect_all_hits:
        n_runs = len(tel.find_spans("engine.run")) + len(tel.find_spans("serving.run"))
        if report.n_misses or report.n_skipped or n_runs:
            log.error(
                "expected a fully cached pass: %d misses, %d skipped, %d engine/serving run spans",
                report.n_misses, report.n_skipped, n_runs,
            )
            return 1
        log.info(
            "all %d cells served from the store (suite.cache_hit=%d, zero simulation spans)",
            len(report.outcomes), int(tel.counter("suite.cache_hit")),
        )
    return 0


def _cmd_gc(args: argparse.Namespace) -> int:
    store = RunStore(args.store)
    stats = store.gc(dry_run=args.dry_run)
    print(f"# store {store.root}: {stats.summary()}")
    for path in stats.payloads_deleted:
        print(f"{'would delete' if args.dry_run else 'deleted'} {path}")
    return 0


def _cmd_verify(args: argparse.Namespace) -> int:
    store = RunStore(args.store)
    with obs.Telemetry():
        stats = store.verify(repair=args.repair, deep=args.deep)
    print(f"# store {store.root}: {stats.summary()}")
    for key, reason in stats.corrupt:
        print(f"corrupt {key[:12]}: {reason}")
    for path in stats.quarantined:
        print(f"quarantined {path}")
    rc = 0 if stats.ok or args.repair else 1
    if args.parity:
        other = RunStore(args.parity)
        mismatches = store.parity(other)
        shared = len(set(r.run_key for r in store.records())
                     & set(r.run_key for r in other.records()))
        if mismatches:
            for key, reason in sorted(mismatches.items()):
                print(f"parity mismatch {key[:12]}: {reason}")
            log.error("parity vs %s: %d/%d shared runs diverge", other.root,
                      len(mismatches), shared)
            return 1
        print(f"# parity vs {other.root}: {shared} shared runs bit-identical")
    return rc


def _cmd_list(args: argparse.Namespace) -> int:
    store = RunStore(args.store)
    records = store.records()
    print(f"# store {store.root}: {len(records)} runs")
    for r in records:
        suite = f" suite={r.suite}/{r.cell}" if r.suite else ""
        print(
            f"{r.run_key[:12]} {r.kind:<8} engine={r.engine:<9} "
            f"sha={r.sha[:9] if r.sha else None} cells={r.n_cells}{suite}"
        )
    return 0


def _cmd_trend(args: argparse.Namespace) -> int:
    store = RunStore(args.store)
    bench = load_bench_history(args.history)
    groups = compute_trends(store.records(), bench)
    if args.json:
        payload = [
            {
                "scenario_hash": g.scenario_hash,
                "engine": g.engine,
                "kind": g.kind,
                "suite": g.suite,
                "shas": g.shas,
                "n_runs": len(g.runs),
                "drift": {k: list(v) for k, v in g.drift().items()},
                "bench": g.bench_join(bench),
            }
            for g in groups
        ]
        print(json.dumps(payload, indent=1))
    else:
        print(render_trends(groups, bench))
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="python -m repro_torch.suite", description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="execute a suite file, resuming from the store")
    p_run.add_argument("suite", help="path to a .toml/.json suite file")
    p_run.add_argument("--store", default=DEFAULT_ROOT, help="run-store root directory")
    p_run.add_argument("--engine", default=None, help="override every cell's engine backend")
    p_run.add_argument(
        "--device", default=None,
        help="torch device of the torch engines (default: the GPU; 'cpu' for the plain CPU run)",
    )
    p_run.add_argument(
        "--set", action="append", metavar="KEY=VALUE",
        help="CLI override layer (dotted keys, e.g. --set params.t_c=120)",
    )
    p_run.add_argument(
        "--dry-run", action="store_true",
        help="print the expanded cells with per-field provenance; simulate nothing",
    )
    p_run.add_argument(
        "--max-cells", type=int, default=None,
        help="simulate at most N missing cells this pass (cache hits are free)",
    )
    p_run.add_argument(
        "--expect-all-hits", action="store_true",
        help="fail unless every cell was a cache hit with zero simulation spans",
    )
    p_run.add_argument(
        "--jobs", type=int, default=1, metavar="N",
        help="simulate up to N missing cells concurrently (store writes stay serial)",
    )
    p_run.add_argument(
        "--retries", type=int, default=3, metavar="N",
        help="attempts per cell before recording it as failed (default 3)",
    )
    p_run.add_argument(
        "--cell-timeout", type=float, default=None, metavar="S",
        help="wall-clock watchdog per cell on the --jobs path (default: off)",
    )
    p_run.set_defaults(fn=_cmd_run)

    p_list = sub.add_parser("list", help="list the store index")
    p_list.add_argument("--store", default=DEFAULT_ROOT)
    p_list.set_defaults(fn=_cmd_list)

    p_gc = sub.add_parser("gc", help="compact the index and delete orphaned payloads")
    p_gc.add_argument("--store", default=DEFAULT_ROOT)
    p_gc.add_argument(
        "--dry-run", action="store_true", help="report what would be reclaimed; change nothing"
    )
    p_gc.set_defaults(fn=_cmd_gc)

    p_verify = sub.add_parser("verify", help="checksum-verify payloads; quarantine with --repair")
    p_verify.add_argument("--store", default=DEFAULT_ROOT)
    p_verify.add_argument(
        "--repair", action="store_true",
        help="move corrupt payloads to quarantine/ and drop their index lines",
    )
    p_verify.add_argument(
        "--deep", action="store_true", help="additionally decode every payload end to end"
    )
    p_verify.add_argument(
        "--parity", default=None, metavar="DIR",
        help="also require bitwise payload parity with the store at DIR",
    )
    p_verify.set_defaults(fn=_cmd_verify)

    p_trend = sub.add_parser("trend", help="metric drift per scenario hash across git shas")
    p_trend.add_argument("--store", default=DEFAULT_ROOT)
    p_trend.add_argument("--history", default=DEFAULT_HISTORY, help="BENCH_history.jsonl path")
    p_trend.add_argument("--json", action="store_true", help="machine-readable output")
    p_trend.set_defaults(fn=_cmd_trend)

    args = parser.parse_args(argv)
    configure_logging()
    try:
        return args.fn(args)
    except BrokenPipeError:  # e.g. `python -m repro_torch.suite list | head`
        return 0


if __name__ == "__main__":
    sys.exit(main())
