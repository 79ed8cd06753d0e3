"""fleet_step op: one placement wave's Eq. 8 scores as torch ops on a device.

:func:`eet_scores` is :func:`.ref.eet_scores_numpy` expression for
expression, each a separate eager torch operation: ``w_scaled * p_succeed``
and ``+ wasted`` round twice, as NumPy does (no ``addcmul``, no fused
multiply-add), and the quotient divides by a device tensor (CUDA divides by a
host scalar through its reciprocal, which is not the IEEE quotient).  Masked
lanes divide by 1.0 and are replaced by ``inf``, so the scores are bitwise
those of the reference, the ``inf`` lanes included.
"""

from __future__ import annotations

import numpy as np
import torch


def _on(x, device: torch.device, dtype) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def eet_scores(p_fail, wasted, w_scaled, avail, device=None) -> torch.Tensor:
    """Eq. 8 combine for a ``(lane, type)`` wave, on ``device``.

    The inputs are NumPy arrays or tensors of one shape (``avail`` bool, the
    others float64).  ``device`` defaults to the inputs' device when they are
    tensors and to the GPU otherwise (raising when there is none); the result
    is a float64 tensor on that device: ``inf`` where ``avail`` is False or
    ``p_succeed <= 0``.
    """
    if device is None:
        if isinstance(p_fail, torch.Tensor):
            device = p_fail.device
        else:
            from repro_torch.engine.base import resolve_device

            device = resolve_device(None)
    device = torch.device(device)
    f64 = torch.float64
    p_fail, wasted, w_scaled = (_on(x, device, f64) for x in (p_fail, wasted, w_scaled))
    avail = _on(avail, device, torch.bool)
    p_succeed = 1.0 - p_fail
    ok = avail & (p_succeed > 0.0)
    den = torch.where(ok, p_succeed, torch.ones_like(p_succeed))
    num = w_scaled * p_succeed
    num = num + wasted
    return torch.where(ok, num / den, torch.full_like(num, float("inf")))
