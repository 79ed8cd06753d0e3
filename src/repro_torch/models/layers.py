"""Shared layers: norms, RoPE, GQA attention (prefill and decode), MLPs, embeddings.

The port of :mod:`repro.models.layers`: plain functions over ``(config,
params, activations)`` in the JAX package's layouts (weights such as ``wq (d,
H, Dh)``, activations ``(B, S, H, Dh)``), with each init function beside its
apply function.  Prefill attention goes through the flash-attention op (the
CUDA kernel on the card); ``impl="plain"`` asks for the plain version.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamBuilder

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(b: ParamBuilder, name: str, cfg: ModelConfig):
    b.ones(f"{name}.scale", (cfg.d_model,))
    if cfg.norm != "rmsnorm":
        b.zeros(f"{name}.bias", (cfg.d_model,))


def apply_norm(cfg: ModelConfig, params, name: str, x):
    """RMSNorm (eps 1e-6) or LayerNorm (eps 1e-5, population variance) in
    float32, cast back to x's dtype."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6)
        return (y * params[f"{name}.scale"].float()).to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    y = y * params[f"{name}.scale"].float() + params[f"{name}.bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(cfg: ModelConfig, positions: torch.Tensor):
    """positions ``(...,)`` -> cos / sin ``(..., d_head // 2)`` in float32."""
    d = cfg.d_head
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d
    inv_freq = 1.0 / (cfg.rope_theta**exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x ``(B, S, H, D)``; cos / sin ``(S, D/2)``.  Rotates in float32 and
    casts back to x's dtype."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window, RoPE)
# ---------------------------------------------------------------------------


def init_attention(b: ParamBuilder, name: str, cfg: ModelConfig):
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    b.dense(f"{name}.wq", (d, h, dh))
    b.dense(f"{name}.wk", (d, kv, dh))
    b.dense(f"{name}.wv", (d, kv, dh))
    b.dense(f"{name}.wo", (h, dh, d))


def project_heads(x, w):
    """``einsum("bsd,dhe->bshe")``: x ``(B, S, d)`` times w ``(d, H, E)``."""
    b, s, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).reshape(b, s, w.shape[1], w.shape[2])


def merge_heads(o, w):
    """``einsum("bshe,hed->bsd")``: o ``(B, S, H, E)`` times w ``(H, E, d)``."""
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ w.reshape(-1, w.shape[-1])


def _qkv(cfg: ModelConfig, params, name: str, x, positions):
    q = project_heads(x, params[f"{name}.wq"])
    k = project_heads(x, params[f"{name}.wk"])
    v = project_heads(x, params[f"{name}.wv"])
    if not cfg.learned_pos:
        cos, sin = rope_frequencies(cfg, positions)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    return q, k, v


def apply_attention(cfg: ModelConfig, params, name: str, x, *, causal=True, window=0, q_block=1024,
                    kv_block=1024, impl=None):
    """Full-sequence (prefill) attention.  Returns ``(out, (k, v))``."""
    positions = torch.arange(x.shape[1], device=x.device)
    q, k, v = _qkv(cfg, params, name, x, positions)
    o = attn_ops.flash_attention(
        q, k, v, causal=causal, window=window, q_block=q_block, kv_block=kv_block, impl=impl
    )
    return merge_heads(o, params[f"{name}.wo"]), (k, v)


def apply_attention_decode(cfg: ModelConfig, params, name: str, x, cache, *, window=0):
    """One-token decode.  cache: ``{"k": (B, S_c, KV, Dh), "v": ..., "len": int}``.

    A window-sized cache (``S_c <= window``) is circular: the new token writes
    at ``len % S_c`` and every slot holds one of the last ``S_c`` positions
    (RoPE keys carry absolute positions, so the scores stay right after
    wrap-around).  The cache's k / v are updated in place (the JAX package
    returns new arrays); the returned dict holds the new ``len``.
    """
    pos = cache["len"]
    s_c = cache["k"].shape[1]
    circular = bool(window) and s_c <= window
    q = project_heads(x, params[f"{name}.wq"])
    k_new = project_heads(x, params[f"{name}.wk"])
    v_new = project_heads(x, params[f"{name}.wv"])
    if not cfg.learned_pos:
        cos, sin = rope_frequencies(cfg, torch.tensor([pos], device=x.device))
        q, k_new = apply_rope(q, cos, sin), apply_rope(k_new, cos, sin)
    write_at = pos % s_c if circular else pos
    cache["k"][:, write_at] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_at] = v_new[:, 0].to(cache["v"].dtype)
    cur = min(pos + 1, s_c) if circular else pos + 1
    o = attn_ops.decode_attention(q, cache["k"], cache["v"], cur, window=0 if circular else window)
    out = merge_heads(o, params[f"{name}.wo"])
    return out, {"k": cache["k"], "v": cache["v"], "len": pos + 1}


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": 0,
    }


# ---------------------------------------------------------------------------
# MLP (gated GLU or plain)
# ---------------------------------------------------------------------------


def init_mlp(b: ParamBuilder, name: str, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.gated_mlp:
        b.dense(f"{name}.wi_gate", (d, f))
    b.dense(f"{name}.wi_up", (d, f))
    b.dense(f"{name}.wo", (f, d))


def _act(cfg: ModelConfig, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(cfg: ModelConfig, params, name: str, x):
    up = x @ params[f"{name}.wi_up"]
    h = _act(cfg, x @ params[f"{name}.wi_gate"]) * up if cfg.gated_mlp else _act(cfg, up)
    return h @ params[f"{name}.wo"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(b: ParamBuilder, cfg: ModelConfig):
    # the vocab is padded to a multiple of 128 as in the JAX package: logits
    # span the padded ids, and greedy sampling may pick one
    v = cfg.padded_vocab
    b.dense("embed.tokens", (v, cfg.d_model), scale=1.0)
    if cfg.learned_pos:
        b.dense("embed.positions", (cfg.max_position, cfg.d_model), scale=0.02)
    if not cfg.tie_embeddings:
        b.dense("unembed", (cfg.d_model, v))


def embed_tokens(cfg: ModelConfig, params, tokens, position_offset=0):
    x = params["embed.tokens"][tokens.long()]
    if cfg.learned_pos:
        pos = torch.arange(tokens.shape[1], device=tokens.device) + position_offset
        x = x + params["embed.positions"][pos][None]
    return x


def unembed(cfg: ModelConfig, params, x):
    w = params["embed.tokens"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ w
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
