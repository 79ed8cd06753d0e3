"""Sampling step of the serving loop (:func:`repro.train.steps.greedy_sample`)."""

from __future__ import annotations

import torch


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """``(B, S, V)`` logits -> ``(B, 1)`` int32 argmax of the last position.

    The argmax runs over the padded vocabulary, as in the JAX package; ties go
    to the lowest id.
    """
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
