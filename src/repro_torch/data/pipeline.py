"""Deterministic resumable token pipeline (the port of :mod:`repro.data.pipeline`).

A batch is a *pure function of (seed, step)*, so the only iterator state is
the step counter: restoring a checkpoint restores the exact data order with
no buffered state to persist (the paper's E_launch workflow: "resume tasks" =
restore params + optimizer state + one integer).

The synthetic corpus is the JAX package's, drawn from the same numbers:
``fold_in(PRNGKey(seed), step)`` split in two keys, float32 uniforms from
the first taken to the power of ``vocab_size - 1`` (a Zipf-like unigram in
log-rank space), cast to int32 and clipped to ``[1, vocab_size)``, and EOS
where a uniform of the second key falls under ``1 / mean_doc_len``;
``tokens`` and ``labels`` are the same int32 sequence shifted by one.  The
keys and uniforms come from :mod:`repro_torch.data.threefry` and are bit for
bit ``jax.random``'s; a token can differ only where float32 ``exp`` lands
within an ulp of an integer, where PyTorch's and XLA's ``exp`` round
differently.  Each batch is drawn on the CPU and then moved to the stream's
device, which makes a batch the same on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import threefry
from repro_torch.engine.base import resolve_device


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
        key = threefry.fold_in(threefry.prng_key(self.seed), step)
        k1, k2 = threefry.split(key)
        shape = (self.batch, self.seq_len + 1)
        # zipf-ish unigram: uniform in log-rank space (float32 throughout, as
        # JAX multiplies by the float32 value of the float64 log)
        u = threefry.uniform(k1, shape)
        ranks = torch.exp(u * torch.tensor(np.float32(np.log(self.vocab_size - 1)))).to(torch.int32)
        tokens = torch.clamp(ranks, 1, self.vocab_size - 1)
        # EOS boundaries with prob 1/mean_doc_len
        eos_mask = threefry.uniform(k2, shape) < torch.tensor(np.float32(1.0 / self.mean_doc_len))
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
