"""What both families of the reference share: float32 without TF32, the
weight product in float32 or in the float8 control, RMSNorm, RoPE, AdamW and
the cross-entropy."""

from __future__ import annotations

import contextlib
import math

import torch

PRECISIONS = ("fp32", "fp8")
_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


@contextlib.contextmanager
def exact_float32():
    """Float32 products in float32: TF32 off for matmuls and convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp8_round(x: torch.Tensor, dim: int, fmt: str = "e4m3") -> torch.Tensor:
    """``x`` rounded to float8 with one scale per slice along ``dim`` (the
    slice's largest magnitude at the format's largest value), back in float32."""
    dtype, top = _FP8[fmt]
    scale = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _FP8MatMul(torch.autograd.Function):
    """``x @ w`` with x rounded per row and w per column to e4m3; the backward's
    products take the incoming gradient rounded per row to e5m2 (as float8
    training recipes do)."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_round(x, -1), fp8_round(w, 0)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g, -1, "e5m2")
        return gq @ wq.T, xq.T @ gq


def mm(x: torch.Tensor, w: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` in float32, or through float8 for the control."""
    if precision == "fp32":
        return x @ w
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    lead = x.shape[:-1]
    return _FP8MatMul.apply(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the whole head ``(B, S, H, D)``: the first and the
    second half of each head form the rotated pairs."""
    d = x.shape[-1]
    inv_freq = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * inv_freq
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` without a cut-off."""
    return torch.logaddexp(x, torch.zeros_like(x))


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sum over positions of ``logsumexp(logits) - logits[label]``."""
    lse = torch.logsumexp(logits, dim=-1)
    return (lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]).sum()


def adamw_step(params: list, grads: list, mu: list, nu: list, step: int, opt: dict) -> float:
    """One AdamW step in place over lists of float32 tensors: the gradients
    clipped to the global norm ``opt["grad_clip"]``, decoupled weight decay.
    Returns the clip factor the gradients were multiplied by."""
    gnorm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads))
    clip = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9)) if opt["grad_clip"] else 1.0
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1.0 - b1 ** step, 1.0 - b2 ** step
    for p, g, m, v in zip(params, grads, mu, nu):
        g = g * clip
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).add_(g * g, alpha=1.0 - b2)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + opt["eps"]) + opt["weight_decay"] * p
        p.sub_(opt["lr"] * delta)
    return clip
