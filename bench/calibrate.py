"""The readings that a cell's limits are set from (see PERF.md), on the card:

    python3 bench/calibrate.py --workload <name> --seeds 1,2,... --control-seeds 7,8,9

For every seed of ``--seeds``, the program's numbers as a run compares them
(a training cell's first steps; a serving cell's first whole cycle of
batches, its sample judged by the reference).  For every seed of
``--control-seeds``, the same numbers of the control (the reference computed
with float8 products, put in the program's place) and of the faults a run
has to catch: half of each batch left out (training) and every served token
one id off (serving).  A state left unchanged reads 1 by the training
numbers' measure and needs no run.  One JSON line per seed and kind.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def _context(workload: str, seed: int):
    from bench.harness.cell import Context
    from bench.harness.manifest import Manifest
    from bench.harness.spans import Spans

    m = Manifest(ROOT)
    cell = m.cell(workload)
    conf = m.config(cell["config"])
    return Context(model=conf["model"], norm_eps=conf["norm_eps"], traffic=m.traffic(cell["traffic"]),
                   limits=m.limits(workload), seed=seed, seconds=float("inf"), traced=False, device="cuda",
                   started=time.perf_counter(), spans=Spans(False))


def train_readings(ctx, control: bool) -> dict:
    from bench.harness import cell, train, weights
    from bench.harness.traffic import TrainFeed
    from bench.reference.train import follow
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig

    t = ctx.traffic
    shapes = T.abstract_params(ModelConfig(**ctx.model))
    out = {}
    if not control:
        prog = train.first_steps(ctx, shapes)[2]
        cell.free(ctx.device)

    def ref(**kw):
        feed = TrainFeed(t, ctx.model["vocab_size"], ctx.seed, ctx.device)
        r = follow(ctx.model, weights.make(shapes, ctx.seed, ctx.device), [next(feed) for _ in range(t["check_steps"])],
                   t["optimizer"], ctx.norm_eps, **kw)
        cell.free(ctx.device)
        return r

    base = ref()
    if control:
        out["control"] = train.compare(ref(precision="fp8"), base)
        out["half_batch"] = train.compare(ref(half_batch=True), base)
    else:
        out["program"] = train.compare(prog, base)
    return out


def serve_readings(ctx, control: bool) -> dict:
    from bench.harness import cell, serve
    from bench.harness.traffic import batch_kinds

    cfg, params = serve.program(ctx)
    serve.warm_up(ctx, cfg, params)
    done = serve.window(ctx, cfg, params, batches=len(batch_kinds(ctx.traffic)))[0]
    cell.free(ctx.device)
    picked = serve.sample(ctx, done)
    ref = list(serve.reference_logits(ctx, params, picked))
    out = {"program": {"token_gap": max(g for served, lg in ref for g in serve.token_gaps(lg, served))},
           "checked_tokens": sum(len(r.tokens) for r in picked)}
    if control:
        vocab = ref[0][1].shape[-1]
        off = [g for served, lg in ref for g in serve.token_gaps(lg, (served + 1) % vocab)]
        out["off_by_one"] = {"token_gap": max(off)}
        ctl = [lg.argmax(dim=-1) for _, lg in serve.reference_logits(ctx, params, picked, "fp8")]
        out["control"] = {"token_gap": max(g for (_, lg), c in zip(ref, ctl) for g in serve.token_gaps(lg, c))}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    from bench.harness import env

    env.prepare_environment(ROOT)
    err = env.card_error(1)
    if err:
        print(err, file=sys.stderr)
        return 2
    print(env.power_line(), flush=True)
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            ctx = _context(args.workload, seed)
            t0 = time.perf_counter()
            readings = (train_readings if ctx.traffic["driver"] == "train" else serve_readings)(ctx, control)
            print(json.dumps({"workload": args.workload, "seed": seed, "seconds": time.perf_counter() - t0,
                              **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
