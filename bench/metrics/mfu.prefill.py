"""mfu.prefill: model FLOPs of the window's prefills (the frozen count: 2 per
weight and prompt token, the head on the last position, attention's forward
where the model has it) over the prefill host spans, against the bf16
tensor-core peak, in %."""


def read(run):
    spans = [s for s in run.spans if s.name == "prefill"]
    if not spans:
        return None
    flops = sum(run.counts.prefill_flops(run.model, *s.meta["batch"]) for s in spans)
    return 100.0 * flops / sum(s.seconds for s in spans) / run.peaks.BF16_TENSOR_FLOPS
