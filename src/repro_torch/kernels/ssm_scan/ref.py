"""Plain PyTorch Mamba-1 selective scan: the yardstick of the CUDA kernel.

The same function as :func:`repro.kernels.ssm_scan.ref.ssm_scan`, written
as the sequential recurrence the kernel runs (the JAX reference uses an
associative scan; the two agree to float32 rounding):

    h_t = exp(dtA_t) * h_{t-1} + dBx_t,   y_t = sum_n h_t[n] * C_t[n],   h_0 = 0
"""

from __future__ import annotations

import torch


def ssm_scan(dtA, dBx, C):
    """dtA, dBx: ``(B, S, D, N)``; C: ``(B, S, N)``.  Returns y ``(B, S, D)``
    float32 and the last state ``(B, D, N)`` float32."""
    b, s, d, n = dtA.shape
    h = torch.zeros((b, d, n), dtype=torch.float32, device=dtA.device)
    y = torch.empty((b, s, d), dtype=torch.float32, device=dtA.device)
    cf = C.float()
    for t in range(s):
        h = torch.exp(dtA[:, t].float()) * h + dBx[:, t].float()
        y[:, t] = (h * cf[:, t, None, :]).sum(dim=-1)
    return y, h


def ssm_step(dtA_t, dBx_t, C_t, h_prev):
    """One decode step: ``h_t = exp(dtA_t) * h_prev + dBx_t``, ``y = h_t . C_t``."""
    h = torch.exp(dtA_t.float()) * h_prev + dBx_t.float()
    y = torch.einsum("bdn,bn->bd", h, C_t.float())
    return y, h
