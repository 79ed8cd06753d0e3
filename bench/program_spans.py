"""Runs one cell of the benchmark traced, as ``bench/run.py --trace 1`` does,
and prints what the program's own spans saw as the last line of standard
output:

    python3 bench/program_spans.py --workload <name> --seed <n> --seconds <s>

The line holds the run's ``correct``, per-layer metrics and device, then
``program`` (:func:`bench.harness.attribution.attribute`: each span's count,
host seconds, device seconds and launch calls in the window),
``readings`` (:data:`bench.harness.attribution.READINGS`, the per-layer
numbers those spans give), ``idle_by_program_span`` (the window's idle gaps
by the innermost program span on the window's thread) and the run's notes.
The run is the harness's own: its call to read the profiler's events
(``bench.harness.trace.events``) is wrapped so that it also keeps the
program's ranges and the host's launch calls.  Runs on the card only, as
``bench/run.py`` does.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def run(root: Path, workload: str, seed: int, seconds: float, device: str, started: float | None = None) -> dict:
    """One traced run of ``workload`` under ``root`` and what its program spans saw."""
    from bench.harness import attribution, cell, trace

    kept = []
    read = trace.events

    def events(prof):
        kept.append(attribution.events(prof))
        return read(prof)

    trace.events = events
    try:
        result, notes = cell.run(root, workload, seed, seconds, True, device, started)
    finally:
        trace.events = read
    evts = kept[0] if kept else []
    program = attribution.attribute(evts)
    return {"workload": workload, "seed": seed, "correct": result["correct"], "metrics": result["metrics"],
            "device": result["device"], "program": program,
            "readings": {m: attribution.reading(program, m) for m in attribution.READINGS},
            "idle_by_program_span": attribution.idle_by_span(evts), "notes": notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    from bench.harness import env

    env.prepare_environment(ROOT)
    from bench.harness.manifest import Manifest

    err = env.card_error(Manifest(ROOT).cell(args.workload)["chips"])
    if err:
        print(err, file=sys.stderr)
        return 2
    print(env.power_line(), file=sys.stderr, flush=True)
    line = run(ROOT, args.workload, args.seed, args.seconds, "cuda", STARTED)
    banned = env.banned_modules()
    if banned:
        print(f"modules the run may not load were loaded: {banned}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
