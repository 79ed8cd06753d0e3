"""Plain PyTorch AdamW update of one leaf and a leaf's sum of squares: the
yardstick of the CUDA kernels, and what the CPU runs.

:func:`upd_block` is :func:`repro.optim.adamw.adamw_update`'s arithmetic on
one leaf (or a block of one), operation for operation in float32, each
operation one eager PyTorch op (the in-place ones on temporaries only, each
rounding exactly as its out-of-place form).  Every divisor is a float32
tensor on the leaf's device: PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal instead, which differs from a division in the
last bit.  ``step`` holds the step's ``[clip, b1c, b2c, lr]`` as float32
``(4,)`` on the leaf's device and ``consts`` the configuration's ``(b1, b2,
1 - b1, 1 - b2, eps, weight_decay)`` as Python floats, each entering the
arithmetic as its float32 rounding (JAX's weak-typed constants).
"""

from __future__ import annotations

import torch


def upd_block(p, g, mu, nu, step: torch.Tensor, consts: tuple):
    """``(new_p, new_mu, new_nu)`` in the dtypes of ``p``, ``mu`` and ``nu``;
    the inputs are left as they are."""
    clip, b1c, b2c, lr = step.unbind()
    b1, b2, one_b1, one_b2, eps, wd = (torch.full((), c, dtype=torch.float32, device=p.device) for c in consts)
    g = g.float() * clip
    mu32 = (b1 * mu.float()).add_(one_b1 * g)
    nu32 = (b2 * nu.float()).add_((one_b2 * g).mul_(g))
    del g
    delta = (mu32 / b1c).div_(torch.sqrt(nu32 / b2c).add_(eps)).add_(wd * p.float())
    new_p = p.float() - delta.mul_(lr)  # p.float() is p itself for a float32 p: no in-place here
    return new_p.to(p.dtype), mu32.to(mu.dtype), nu32.to(nu.dtype)


def sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of ``x``'s squares (a 0-dim tensor)."""
    return torch.sum(torch.square(x.float()))
