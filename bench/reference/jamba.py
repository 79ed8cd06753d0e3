"""A Jamba layer (AI21-Jamba2-Mini's family): pre-norm RMSNorm, a mixer, a
second RMSNorm and a feed-forward, each added to the residual stream.

The mixer is a Mamba-1 mixer (``mixer.*``) as in :mod:`bench.reference.ssm`,
with RMS norms on dt's low-rank input, B and C after ``x_proj``
(``mixer.dt_norm.scale``, ``mixer.b_norm.scale``, ``mixer.c_norm.scale``), or
grouped-query causal attention (``attn.*``) with no positional encoding.  The
feed-forward is a SwiGLU (``mlp.*``) or a mixture of experts (``moe.*``): the
float32 softmax of ``y @ moe.router`` over the experts, the ``top_k`` largest
(ties to the lower expert) and the sum of those experts' SwiGLUs, each times
its probability, not renormalised; no token is dropped.  Expert weights are
``(E, d_in, d_out)``.

At 32,768 positions the attention runs in blocks of query rows
(:func:`bench.reference.dense.causal_attention`) and the mixture of experts
an expert at a time, on the positions routed to it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import mm, rms_norm, softplus
from bench.reference.dense import causal_attention
from bench.reference.ssm import scan


def mamba(m: dict, p: dict, y: torch.Tensor, eps: float, precision: str) -> torch.Tensor:
    d = y.shape[-1]
    di, n = m.get("ssm_expand", 2) * d, m["ssm_state"]
    r = m.get("dt_rank") or math.ceil(d / 16)
    k = p["mixer.conv_w"].shape[0]
    xz = mm(y, p["mixer.in_proj"], precision)
    xi, z = xz[..., :di], xz[..., di:]
    padded = F.pad(xi, (0, 0, k - 1, 0))
    conv = sum(padded[:, i: i + xi.shape[1]] * p["mixer.conv_w"][i] for i in range(k)) + p["mixer.conv_b"]
    xa = F.silu(conv)
    proj = mm(xa, p["mixer.x_proj"], precision)
    dt_low = rms_norm(proj[..., :r], p["mixer.dt_norm.scale"], eps)
    bmat = rms_norm(proj[..., r:r + n], p["mixer.b_norm.scale"], eps)
    cmat = rms_norm(proj[..., r + n:], p["mixer.c_norm.scale"], eps)
    dt = softplus(mm(dt_low, p["mixer.dt_proj"], precision) + p["mixer.dt_bias"])
    out = scan(dt, -torch.exp(p["mixer.A_log"]), bmat, cmat, xa)
    out = (out + p["mixer.D"] * xa) * F.silu(z)
    return mm(out, p["mixer.out_proj"], precision)


def attention(m: dict, p: dict, y: torch.Tensor, precision: str) -> torch.Tensor:
    b, s, d = y.shape
    h, kv = m["n_heads"], m["n_kv_heads"]
    dh = m.get("d_head") or d // h
    q = mm(y, p["attn.wq"].reshape(d, h * dh), precision).reshape(b, s, h, dh)
    k = mm(y, p["attn.wk"].reshape(d, kv * dh), precision).reshape(b, s, kv, dh)
    v = mm(y, p["attn.wv"].reshape(d, kv * dh), precision).reshape(b, s, kv, dh)
    return mm(causal_attention(q, k, v).reshape(b, s, h * dh), p["attn.wo"].reshape(h * dh, d), precision)


def experts(m: dict, p: dict, y: torch.Tensor, precision: str) -> torch.Tensor:
    d = y.shape[-1]
    flat = y.reshape(-1, d)
    probs = torch.softmax(mm(flat, p["moe.router"], precision), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :m["top_k"]], top_e[:, :m["top_k"]]
    out = torch.zeros_like(flat)
    for e in range(p["moe.router"].shape[1]):
        rows, slot = torch.nonzero(top_e == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = flat[rows]
        h = F.silu(mm(x, p["moe.wi_gate"][e], precision)) * mm(x, p["moe.wi_up"][e], precision)
        out.index_add_(0, rows, top_w[rows, slot, None] * mm(h, p["moe.wo"][e], precision))
    return out.reshape(y.shape)


def layer(m: dict, p: dict, x: torch.Tensor, eps: float, precision: str) -> torch.Tensor:
    """One layer on the float32 residual stream ``x (B, S, d)``; ``p``'s
    tensors are float32, and its names tell the layer's kind."""
    y = rms_norm(x, p["norm1.scale"], eps)
    x = x + (mamba(m, p, y, eps, precision) if "mixer.in_proj" in p else attention(m, p, y, precision))
    y = rms_norm(x, p["norm2.scale"], eps)
    if "moe.router" in p:
        return x + experts(m, p, y, precision)
    gate = mm(y, p["mlp.wi_gate"], precision)
    return x + mm(F.silu(gate) * mm(y, p["mlp.wi_up"], precision), p["mlp.wo"], precision)
