"""A dense decoder layer (glm4-9b's family): pre-norm RMSNorm, grouped-query
causal attention with RoPE over the whole head, a SwiGLU MLP, no biases.

Parameter names and layouts are the configuration's: ``attn.wq (d, H, Dh)``,
``attn.wk`` / ``attn.wv (d, KV, Dh)``, ``attn.wo (H, Dh, d)``, ``mlp.wi_gate``
/ ``mlp.wi_up (d, F)``, ``mlp.wo (F, d)``, ``norm1.scale`` / ``norm2.scale
(d,)``.  Query head ``h`` reads key / value head ``h // (H / KV)``.
"""

from __future__ import annotations

import math

import torch

from bench.reference.common import mm, rms_norm, rope

#: Score elements one attention block holds at a time (1 GiB of float32).
SCORE_ELEMENTS = 1 << 28


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention of q ``(B, S, H, D)`` over k / v ``(B, S, KV, D)``,
    each position seeing itself and the positions before it, computed over
    blocks of query rows."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d)
    block = max(1, SCORE_ELEMENTS // (b * h * s))
    outs = []
    for lo in range(0, s, block):
        hi = min(s, lo + block)
        scores = torch.einsum("bqkgd,bckd->bkgqc", qg[:, lo:hi], k[:, :hi]) / math.sqrt(d)
        seen = torch.arange(lo, hi, device=q.device)[:, None] >= torch.arange(hi, device=q.device)[None, :]
        probs = torch.softmax(scores.masked_fill(~seen, float("-inf")), dim=-1)
        outs.append(torch.einsum("bkgqc,bckd->bqkgd", probs, v[:, :hi]))
    return torch.cat(outs, dim=1).reshape(b, s, h, d)


def layer(m: dict, p: dict, x: torch.Tensor, eps: float, precision: str) -> torch.Tensor:
    """One layer on the float32 residual stream ``x (B, S, d)``; ``p``'s
    tensors are float32."""
    b, s, d = x.shape
    h, kv = m["n_heads"], m["n_kv_heads"]
    dh = m.get("d_head") or d // h
    pos = torch.arange(s, device=x.device)
    y = rms_norm(x, p["norm1.scale"], eps)
    q = mm(y, p["attn.wq"].reshape(d, h * dh), precision).reshape(b, s, h, dh)
    k = mm(y, p["attn.wk"].reshape(d, kv * dh), precision).reshape(b, s, kv, dh)
    v = mm(y, p["attn.wv"].reshape(d, kv * dh), precision).reshape(b, s, kv, dh)
    q, k = rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"])
    o = causal_attention(q, k, v)
    x = x + mm(o.reshape(b, s, h * dh), p["attn.wo"].reshape(h * dh, d), precision)
    y = rms_norm(x, p["norm2.scale"], eps)
    gate = mm(y, p["mlp.wi_gate"], precision)
    up = mm(y, p["mlp.wi_up"], precision)
    return x + mm(torch.nn.functional.silu(gate) * up, p["mlp.wo"], precision)
