"""The serving driver: a closed loop of static batches through the program's
``prefill`` and ``decode_step``, greedy tokens streamed to the host.

Set-up makes the weights and warms every batch shape of the traffic's cycle
up on the model's first layers (each layer has the same shapes), and one
batch on all of them: a prefill, the first token and two decode steps each.
The window then serves batches in the schedule's order, one after the other:
the prefill and its first token on the host (the time to first token), then
``new_tokens - 1`` decode steps, each step's tokens copied to the host.  No
batch starts after ``--seconds``; the window ends when the last batch begun
has its last tokens on the host, and every request of the window counts,
over the whole window.

After the window the program's caches are freed, a sample of the requests
(the longest always in it, the rest drawn from the seed) is run through the
reference: each prompt with its served tokens in one forward pass, and each
served token's logit is read against the reference's best at its position.
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from bench.harness import cell, trace, weights
from bench.harness.cell import Context, Outcome
from bench.harness.env import derive
from bench.harness.traffic import batch_kinds, serve_prompts, serve_schedule
from bench.reference import model as reference

#: Decode steps of each warm-up batch.
WARMUP_STEPS = 2
#: Layers each warm-up batch runs through.
WARMUP_LAYERS = 2


@dataclasses.dataclass
class Request:
    batch: int  # index of its batch in the schedule
    row: int
    prompt: int  # prompt length
    tokens: list  # served ids
    ttft_s: float


def serve_batch(ctx: Context, cfg, params, tokens, new_tokens: int, spans: list):
    """Prefill, first token, decode; returns ``(served ids (B, new_tokens),
    seconds to the first token on the host)``."""
    from repro_torch.models import transformer as T
    from repro_torch.train import steps

    t0 = time.perf_counter()
    with ctx.spans.span("prefill", batch=tuple(tokens.shape)) as rec:
        logits, cache = T.prefill(cfg, params, {"tokens": tokens}, tokens.shape[1] + new_tokens, device=ctx.device)
        tok = steps.greedy_sample(logits)
        out = [tok.cpu()]
    spans.append(rec)
    first = time.perf_counter() - t0
    for _ in range(new_tokens - 1):
        with ctx.spans.span("decode", batch=tokens.shape[0]) as rec:
            logits, cache = T.decode_step(cfg, params, tok, cache, device=ctx.device)
            tok = steps.greedy_sample(logits)
            with ctx.spans.span("host_copy"):
                out.append(tok.cpu())
        spans.append(rec)
    del logits, cache
    return torch.cat(out, dim=1), first


def sample(ctx: Context, done: list[Request]) -> list[Request]:
    """The longest request, then requests drawn from the seed until the served
    tokens reach ``check.served_tokens`` or the next would take the reference's
    prompt tokens over ``check.prompt_tokens``."""
    check = ctx.traffic["check"]
    longest = max(done, key=lambda r: (r.prompt, -r.batch, -r.row))
    rest = [r for r in done if r is not longest]
    random.Random(derive(ctx.seed, "sample")).shuffle(rest)
    picked, served, prompt = [longest], len(longest.tokens), longest.prompt
    for r in rest:
        if served >= check["served_tokens"]:
            break
        if prompt + r.prompt <= check["prompt_tokens"]:
            picked.append(r)
            served += len(r.tokens)
            prompt += r.prompt
    return picked


def reference_logits(ctx: Context, params: dict, requests: list[Request], precision: str = "fp32"):
    """The reference's float32 logits at every served position of ``requests``,
    a group of equal prompt lengths at a time: yields ``(served ids (R, T),
    logits (R, T, V))``.  Each prompt goes in with its served tokens."""
    by_len: dict[int, list[Request]] = {}
    for r in requests:
        by_len.setdefault(r.prompt, []).append(r)
    for length, group in sorted(by_len.items()):
        prompts = torch.cat([_prompt_row(ctx, r) for r in group])
        served = torch.tensor([r.tokens for r in group], dtype=torch.int64, device=ctx.device)
        seq = torch.cat([prompts, served[:, :-1]], dim=1)
        pos = range(length - 1, length - 1 + served.shape[1])
        yield served, reference.logits_at(ctx.model, params, seq, pos, ctx.norm_eps, precision)


def token_gaps(logits: torch.Tensor, tokens: torch.Tensor) -> list[float]:
    """How far each token's logit lies below the best logit at its position."""
    best = logits.max(dim=-1).values
    return (best - torch.gather(logits, -1, tokens[..., None])[..., 0]).flatten().tolist()


def _prompt_row(ctx: Context, r: Request) -> torch.Tensor:
    kind = next(k for k in batch_kinds(ctx.traffic) if k[0] == r.prompt)
    return serve_prompts(ctx.traffic, ctx.model["vocab_size"], ctx.seed, r.batch, kind, ctx.device)[r.row:r.row + 1]


def program(ctx: Context):
    """The program's configuration and the weights made from the seed."""
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ModelConfig

    cfg = ModelConfig(**ctx.model)
    return cfg, weights.make(T.abstract_params(cfg), ctx.seed, ctx.device)


def warm_up(ctx: Context, cfg, params) -> None:
    """Every batch shape of the cycle through the model's first layers (each
    layer has the same shapes), then one batch through all of them, so that
    the allocator already holds what a whole prefill keeps until it returns."""
    small = dataclasses.replace(cfg, n_layers=min(WARMUP_LAYERS, cfg.n_layers))
    part = dict(params, layers=params["layers"][:small.n_layers])
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(derive(ctx.seed, "warm-up"))
    kinds = sorted(set(batch_kinds(ctx.traffic)))
    for prompt, rows in kinds:
        ids = torch.randint(1, ctx.model["vocab_size"], (rows, prompt), generator=gen, device=ctx.device)
        serve_batch(ctx, small, part, ids, WARMUP_STEPS + 1, [])
    serve_batch(ctx, cfg, params, ids, WARMUP_STEPS + 1, [])
    cell.sync(ctx.device)


def window(ctx: Context, cfg, params, batches: int | None = None) -> tuple[list[Request], int, list, dict | None,
                                                                              float, float]:
    """Serves batches until ``--seconds`` have passed (or ``batches`` batches);
    returns the requests served, the requests attempted, the window's spans,
    the trace's summary, and the window's start and length on the host clock."""
    new_tokens = ctx.traffic["new_tokens"]
    schedule = serve_schedule(ctx.traffic, ctx.seed, 10_000)
    prof = trace.profiler(ctx.device) if ctx.traced else None
    if prof is not None:
        prof.start()
    begun = time.perf_counter()
    done, attempted, spans = [], 0, []
    with ctx.spans.span("window"):
        for index, kind in enumerate(schedule):
            if index == batches or batches is None and time.perf_counter() - begun >= ctx.seconds:
                break
            attempted += kind[1]
            with ctx.spans.span("data") as rec:
                ids = serve_prompts(ctx.traffic, ctx.model["vocab_size"], ctx.seed, index, kind, ctx.device)
            spans.append(rec)
            served, first = serve_batch(ctx, cfg, params, ids, new_tokens, spans)
            done += [Request(index, row, kind[0], served[row].tolist(), first) for row in range(kind[1])]
    length = time.perf_counter() - begun
    summary = None
    if prof is not None:
        prof.stop()
        summary = trace.summarize(trace.events(prof))
    return done, attempted, spans, summary, begun, length


def run(ctx: Context) -> Outcome:
    cfg, params = program(ctx)
    warm_up(ctx, cfg, params)
    cell.settle(ctx.device)
    done, attempted, spans, summary, begun, length = window(ctx, cfg, params)
    peak = cell.memory_peak(ctx.device)
    cell.free(ctx.device)
    t_ref = time.perf_counter()
    picked = sample(ctx, done) if done else []
    gaps = [g for served, ref in reference_logits(ctx, params, picked) for g in token_gaps(ref, served)]
    new_tokens = ctx.traffic["new_tokens"]
    served = sum(r.prompt + new_tokens for r in done)
    return Outcome(
        end_to_end={"serve_tokens_per_s": served / length,
                    "ttft_mean_ms": 1e3 * sum(r.ttft_s for r in done) / max(1, len(done)),
                    "setup_s": begun - ctx.started},
        attempted=attempted, failed=0, compared={"token_gap": max(gaps, default=float("inf"))},
        memory_peak_bytes=peak, window=spans, trace=summary,
        notes={"window_s": length, "requests_done": len(done),
               "batches": [(s.meta["batch"], s.seconds) for s in spans if s.name == "prefill"],
               "decode_steps": sum(1 for s in spans if s.name == "decode"),
               "checked": [(r.prompt, len(r.tokens)) for r in picked], "reference_s": time.perf_counter() - t_ref},
    )
