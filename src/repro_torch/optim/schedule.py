"""Learning-rate schedules as functions ``step -> multiplier`` (the port of
:mod:`repro.optim.schedule`), in float32 on the step's device."""

from __future__ import annotations

import math

import torch


def cosine_schedule(total_steps: int, final_frac: float = 0.1):
    def fn(step):
        s = torch.as_tensor(step).to(torch.float32)
        t = torch.clamp(s / max(total_steps, 1), 0.0, 1.0)
        return final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))

    return fn


def linear_warmup_cosine(warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    cos = cosine_schedule(max(total_steps - warmup_steps, 1), final_frac)

    def fn(step):
        step = torch.as_tensor(step)
        warm = step.to(torch.float32) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))

    return fn
