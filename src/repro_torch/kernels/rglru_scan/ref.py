"""Plain PyTorch RG-LRU scan: the yardstick of the CUDA kernel.

The recurrence of Griffin / RecurrentGemma
(:mod:`repro.kernels.rglru_scan.ref`), written as the TPU kernel and the CUDA
kernel compute it:

    a_t = exp(log_a_t),   h_t = a_t * h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) * x_t,   h_0 = 0

(the JAX reference takes ``exp(2 log_a_t)`` for ``a_t^2`` and an associative
scan; the forms agree to float32 rounding).
"""

from __future__ import annotations

import torch

#: c of ``log_a = -c * softplus(Lambda) * r`` (Griffin).
RG_LRU_C = 8.0


def rglru_step(log_a_t, gated_x_t, h_prev):
    a = torch.exp(log_a_t.float())
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    h = a * h_prev + beta * gated_x_t.float()
    return h, h


def rglru_scan(log_a, gated_x):
    """log_a, gated_x: ``(B, S, W)``.  Returns h ``(B, S, W)`` float32 and the
    last h ``(B, W)``."""
    b, s, w = log_a.shape
    h = torch.zeros((b, w), dtype=torch.float32, device=log_a.device)
    out = torch.empty((b, s, w), dtype=torch.float32, device=log_a.device)
    for t in range(s):
        h, _ = rglru_step(log_a[:, t], gated_x[:, t], h)
        out[:, t] = h
    return out, h
