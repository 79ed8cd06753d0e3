"""The training driver: the program's train step on a feed of new rows.

Set-up makes the weights and the AdamW state, builds the step once and runs
its first ``check_steps`` steps on the feed (those are what the reference
follows), then ``WARM_STEPS`` more.  The program's readings are taken on the
way: each checked step's loss, each leaf's first gradient as the optimizer
took it (its first moment after one step over ``1 - b1``) and, after the
last checked step, each leaf's change from the initial weights (made again
from the seed).  The same step and feed then run the window, each step ended
by reading its loss on the host.  No step starts after ``--seconds``; the
window ends with the last step begun, and the rate is every step's tokens
over the whole window.  After the window the program's state is freed and
:func:`bench.reference.train.follow` runs the checked steps in float32.
"""

from __future__ import annotations

import statistics
import time

import torch

from bench.harness import cell, trace, weights
from bench.harness.cell import Context, Outcome
from bench.harness.traffic import TrainFeed
from bench.reference.train import follow, named_leaves

#: Steps run after the checked ones and before the window: the first steps after
#: set-up's allocations ran up to twice as long as the rest (on an H100).
WARM_STEPS = 2
#: A leaf whose reference gradient is under this share of the median leaf's
#: moves by round-off alone and is left out of the change (a bias under softmax).
STILL_LEAF = 1e-3


def _norms(tree: dict, scale: float = 1.0) -> dict:
    return {n: float(torch.linalg.vector_norm(v.float())) * scale for n, v in named_leaves(tree)}


def worst_leaf(prog: dict, ref: dict, keep: list[str]) -> float:
    """The largest gap between the program's and the reference's norm of a
    leaf, over the larger of that leaf's and the median leaf's reference norm."""
    med = statistics.median(ref[n] for n in keep)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in keep)


def compare(prog: dict, ref: dict) -> dict:
    grads = ref["grad_norms"]
    names = list(grads)
    med = statistics.median(grads.values())
    moving = [n for n in names if grads[n] >= STILL_LEAF * med]
    return {
        "loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])),
        "grad_gap": worst_leaf(prog["grad_norms"], grads, names),
        "change_gap": worst_leaf(prog["change_norms"], ref["change_norms"], moving),
    }


def first_steps(ctx: Context, shapes: dict):
    """The program's state after its first ``check_steps`` steps, with the
    step, the feed and the program's readings of those steps."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import steps as program_steps

    t, dev = ctx.traffic, ctx.device
    opt_cfg = AdamWConfig(**t["optimizer"])
    params = weights.make(shapes, ctx.seed, dev)
    opt_state = adamw_init(params, opt_cfg)
    step = program_steps.make_train_step(ModelConfig(**ctx.model), opt_cfg, remat=t["remat"])
    feed = TrainFeed(t, ctx.model["vocab_size"], ctx.seed, dev)
    prog = {"losses": []}
    for i in range(t["check_steps"]):
        with ctx.spans.span("setup_step"):
            params, opt_state, metrics = step(params, opt_state, next(feed))
            prog["losses"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad_norms"] = _norms(opt_state["mu"], 1.0 / (1.0 - opt_cfg.b1))
    start = dict(named_leaves(weights.make(shapes, ctx.seed, dev)))
    prog["change_norms"] = {n: float(torch.linalg.vector_norm(v.float() - start[n].float()))
                            for n, v in named_leaves(params)}
    del start
    for _ in range(WARM_STEPS):
        with ctx.spans.span("setup_step"):
            params, opt_state, metrics = step(params, opt_state, next(feed))
            float(metrics["loss"])
    return (params, opt_state), (step, feed), prog


def run(ctx: Context) -> Outcome:
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig

    t, dev = ctx.traffic, ctx.device
    shapes = T.abstract_params(ModelConfig(**ctx.model))
    (params, opt_state), (step, feed), prog = first_steps(ctx, shapes)
    cell.settle(dev)

    tokens_per_step = t["batch"] * t["seq"]
    prof = trace.profiler(dev) if ctx.traced else None
    if prof is not None:
        prof.start()
    begun = time.perf_counter()
    setup_s = begun - ctx.started
    window, done, started = [], 0, 0
    with ctx.spans.span("window"):
        while time.perf_counter() - begun < ctx.seconds:
            started += 1
            with ctx.spans.span("data") as data:
                batch = next(feed)
            with ctx.spans.span("step") as rec:
                params, opt_state, metrics = step(params, opt_state, batch)
                loss = float(metrics["loss"])
            rec.meta["loss"] = loss
            window += [data, rec]
            done += loss == loss
    length = time.perf_counter() - begun
    summary = None
    if prof is not None:
        prof.stop()
        summary = trace.summarize(trace.events(prof))
        del prof
    failed = sum(1 for s in window if s.name == "step" and s.meta["loss"] != s.meta["loss"])
    peak = cell.memory_peak(dev)
    del params, opt_state, metrics, batch, step
    cell.free(dev)

    ref_feed = TrainFeed(t, ctx.model["vocab_size"], ctx.seed, dev)
    t_ref = time.perf_counter()
    ref = follow(ctx.model, weights.make(shapes, ctx.seed, dev), [next(ref_feed) for _ in range(t["check_steps"])],
                 t["optimizer"], ctx.norm_eps)
    return Outcome(
        end_to_end={"train_tokens_per_s": done * tokens_per_step / length, "setup_s": setup_s},
        attempted=started, failed=failed, compared=compare(prog, ref), memory_peak_bytes=peak, window=window,
        trace=summary,
        notes={"window_s": length, "steps_done": done, "step_s": [s.seconds for s in window if s.name == "step"],
               "losses": prog["losses"], "reference_losses": ref["losses"],
               "reference_s": time.perf_counter() - t_ref},
    )
