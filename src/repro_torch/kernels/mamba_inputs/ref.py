"""Plain PyTorch formation of the Mamba-1 scan's inputs: the yardstick of the
CUDA kernel, and what every device but the card runs.

From ``dt_pre = dt_low @ dt_proj`` ``(B, S, D)``, the bias ``(D,)``, ``A_log``
``(D, N)``, the conv's activation ``x`` ``(B, S, D)`` and ``B`` ``(B, S, N)``:

    dt  = softplus(dt_pre + dt_bias)      (the sum in the model's dtype, then float32)
    dtA = dt[..., None] * -exp(A_log)     (B, S, D, N) float32
    dBx = (dt * x)[..., None] * B[:, :, None, :]
"""

from __future__ import annotations

import torch


def softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``); ``F.softplus`` returns x itself above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_inputs(dt_pre, dt_bias, A_log, x_act, bmat):
    """Returns ``(dtA, dBx)``, both ``(B, S, D, N)`` float32."""
    dt = softplus((dt_pre + dt_bias).float())  # (B, S, D)
    a = -torch.exp(A_log.float())  # (D, N)
    dtA = dt[..., None] * a
    dBx = (dt * x_act.float())[..., None] * bmat.float()[:, :, None, :]
    return dtA, dBx
