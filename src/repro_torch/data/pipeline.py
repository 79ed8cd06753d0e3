"""Deterministic resumable token pipeline (the port of :mod:`repro.data.pipeline`).

A batch is a *pure function of (seed, step)*, so the only iterator state is
the step counter: restoring a checkpoint restores the exact data order with
no buffered state to persist (the paper's E_launch workflow: "resume tasks" =
restore params + optimizer state + one integer).

The synthetic corpus has the JAX package's distribution: tokens uniform in
log-rank space (a Zipf-like unigram), clipped to ``[1, vocab_size)``, and EOS
with probability ``1 / mean_doc_len``; ``tokens`` and ``labels`` are the same
int32 sequence shifted by one.  The JAX package draws from threefry, which
PyTorch does not have, so the numbers differ from it: each batch is drawn
from a CPU ``torch.Generator`` seeded with a fixed mix of (seed, step) and
then moved to the stream's device, which makes a batch the same on the CPU
and on the card.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.engine.base import resolve_device

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def batch_seed(seed: int, step: int) -> int:
    """The generator seed of the batch at ``step`` (a 63-bit mix of both)."""
    return _splitmix64(_splitmix64(seed & _MASK64) ^ (step & _MASK64)) >> 1


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    eos: int = 0
    mean_doc_len: float = 64.0
    step: int = 0  # checkpointable state (the only state)
    device: str | torch.device | None = None  # where batches land: the card unless "cpu"

    def state_dict(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        if int(d["seed"]) != self.seed:
            raise ValueError(f"restoring a stream of seed {d['seed']} into one of seed {self.seed}")
        self.step = int(d["step"])

    def batch_at(self, step: int) -> dict:
        """Pure: the batch for a given step."""
        gen = torch.Generator(device="cpu").manual_seed(batch_seed(self.seed, step))
        shape = (self.batch, self.seq_len + 1)
        # zipf-ish unigram: uniform in log-rank space
        u = torch.rand(shape, generator=gen, dtype=torch.float32)
        ranks = torch.exp(u * math.log(self.vocab_size - 1)).to(torch.int32)
        tokens = torch.clamp(ranks, 1, self.vocab_size - 1)
        # EOS boundaries with prob 1/mean_doc_len
        eos_mask = torch.rand(shape, generator=gen, dtype=torch.float32) < (1.0 / self.mean_doc_len)
        tokens = torch.where(eos_mask, torch.tensor(self.eos, dtype=torch.int32), tokens)
        dev = resolve_device(self.device)
        return {
            "tokens": tokens[:, :-1].contiguous().to(dev),
            "labels": tokens[:, 1:].contiguous().to(dev),
        }

    def __next__(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def __iter__(self):
        return self
