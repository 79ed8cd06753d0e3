"""The one generator of the benchmark's inputs, driven by a traffic file.

Token ids follow the training corpus rule of the port's synthetic stream
(a frozen copy): a float32 uniform ``u`` per position gives the id
``int(exp(u * log(V - 1)))`` clipped to ``[1, V)``, a Zipf-like unigram in
log-rank space, and a second uniform under ``1 / mean_doc_len`` puts the
end-of-document id there.  The draws run on the device from a generator
seeded by the run's seed and the stream's name.

* Training (``"driver": "train"``): :class:`TrainFeed` gives each step new
  rows of ``seq + 1`` ids, cut into tokens and labels shifted by one.
* Serving (``"driver": "serve"``): a closed loop of static batches.  The
  traffic's ``cycle`` lists batch kinds (prompt length, requests a batch,
  count in a cycle); :func:`serve_schedule` repeats the cycle, each repeat in
  its own seeded order, so every seed serves the same kinds in another order;
  :func:`serve_prompts` draws one batch's prompts from the seed and the
  batch's index, so any batch can be drawn again without the others.
"""

from __future__ import annotations

import math
import random

import torch

from bench.harness.env import derive


def zipf_tokens(gen: torch.Generator, shape: tuple, vocab: int, mean_doc_len: float, eos: int,
                device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    ids = torch.exp(u * math.log(vocab - 1)).to(torch.int64).clamp_(1, vocab - 1)
    ends = torch.rand(shape, generator=gen, device=device, dtype=torch.float32) < 1.0 / mean_doc_len
    return torch.where(ends, torch.full_like(ids, eos), ids)


class TrainFeed:
    """Batches ``{"tokens", "labels"}`` of ``(batch, seq)`` ids, a new draw every call."""

    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        self.traffic, self.vocab, self.device = traffic, vocab, device
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(derive(seed, "train-feed"))

    def __next__(self) -> dict:
        t = self.traffic
        rows = zipf_tokens(self.gen, (t["batch"], t["seq"] + 1), self.vocab, t["mean_doc_len"], t["eos"],
                           self.device)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}

    def __iter__(self):
        return self


def batch_kinds(traffic: dict) -> list[tuple[int, int]]:
    """One cycle's batches as ``(prompt length, requests)``, in the file's order."""
    return [(k["prompt"], k["batch"]) for k in traffic["cycle"] for _ in range(k["count"])]


def serve_schedule(traffic: dict, seed: int, n: int) -> list[tuple[int, int]]:
    """The first ``n`` batches' ``(prompt length, requests)``."""
    out = []
    cycle = 0
    while len(out) < n:
        kinds = batch_kinds(traffic)
        random.Random(derive(seed, "order", cycle)).shuffle(kinds)
        out += kinds
        cycle += 1
    return out[:n]


def serve_prompts(traffic: dict, vocab: int, seed: int, index: int, kind: tuple[int, int], device) -> torch.Tensor:
    """Prompt ids ``(requests, prompt length)`` of batch ``index``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "prompts", index))
    prompt, requests = kind
    return zipf_tokens(gen, (requests, prompt), vocab, traffic["mean_doc_len"], traffic["eos"], device)
