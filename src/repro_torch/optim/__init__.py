"""Optimizer: AdamW with float32 arithmetic and dtype-configurable moments,
learning-rate schedules, and int8 error-feedback gradient compression (the
port of :mod:`repro.optim`)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, global_norm, opt_state_axes
from repro_torch.optim.compress import CompressionState, compress_gradients_init, compressed_grad_transform
from repro_torch.optim.schedule import cosine_schedule, linear_warmup_cosine

__all__ = [
    "AdamWConfig",
    "CompressionState",
    "adamw_init",
    "adamw_update",
    "compress_gradients_init",
    "compressed_grad_transform",
    "cosine_schedule",
    "global_norm",
    "linear_warmup_cosine",
    "opt_state_axes",
]
