"""Runs one cell of the benchmark once and prints its result as the last line
of standard output (see PERF.md):

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs on the card only: without one, or with fewer than the cell asks for, it
exits with 2 and prints no result.  It also exits non-zero with no result
when a JAX module was loaded.  The numbers the run compared with the
reference are its last lines on standard error, each beside its limit.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bench.harness import env

    env.prepare_environment(ROOT)
    from bench.harness import cell
    from bench.harness.manifest import Manifest

    chips = Manifest(ROOT).cell(args.workload)["chips"]
    err = env.card_error(chips)
    if err:
        print(err, file=sys.stderr)
        return 2
    print(env.power_line(), file=sys.stderr, flush=True)
    result, notes = cell.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", STARTED)
    banned = env.banned_modules()
    if banned:
        print(f"modules the run may not load were loaded: {banned}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("notes " + json.dumps(notes), file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
