"""mfu.train: model FLOPs of the window's train steps (the frozen count: 6 per
weight and token, plus 3 times the causal attention's forward) over the
steps' host spans, against the bf16 tensor-core peak, in %."""


def read(run):
    steps = [s for s in run.spans if s.name == "step"]
    if not steps:
        return None
    t = run.traffic
    flops = run.counts.train_step_flops(run.model, t["batch"], t["seq"]) * len(steps)
    return 100.0 * flops / sum(s.seconds for s in steps) / run.peaks.BF16_TENSOR_FLOPS
