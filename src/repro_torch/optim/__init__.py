"""Optimizer: AdamW with float32 arithmetic and dtype-configurable moments,
and learning-rate schedules (the port of :mod:`repro.optim` without its
gradient compression, which no training path calls)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "linear_warmup_cosine",
]
