"""Shared layers: norms, RoPE, GQA attention (prefill and decode), MLPs, embeddings.

The port of :mod:`repro.models.layers`: plain functions over ``(config,
params, activations)`` in the JAX package's layouts (weights such as ``wq (d,
H, Dh)``, activations ``(B, S, H, Dh)``), with each init function beside its
apply function.  Prefill attention goes through the flash-attention op (the
CUDA kernel on the card); ``impl="plain"`` asks for the plain version.

The activations carry the JAX package's ``shard(...)`` annotations at its
places: a no-op on plain tensors, a redistribution of a DTensor (parameters
and batch placed on a mesh by :func:`repro_torch.parallel.sharding.place`) to
the placements of its logical axes.  What the layers make themselves
(positions, RoPE's tables) is made ``Replicate()`` on the input's mesh then.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamBuilder
from repro_torch.parallel import sp_decode
from repro_torch.parallel.sharding import (
    contiguous_grad, current_rules, is_placed, keep_shards, local_call, replicated_like, shard, split_index,
)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(b: ParamBuilder, name: str, cfg: ModelConfig):
    b.ones(f"{name}.scale", (cfg.d_model,), ("embed",))
    if cfg.norm != "rmsnorm":
        b.zeros(f"{name}.bias", (cfg.d_model,), ("embed",))


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
    b.dense(f"{name}.wq", (d, h, dh), ("fsdp", "heads", "head_dim"))
    b.dense(f"{name}.wk", (d, kv, dh), ("fsdp", "kv_heads", "head_dim"))
    b.dense(f"{name}.wv", (d, kv, dh), ("fsdp", "kv_heads", "head_dim"))
    b.dense(f"{name}.wo", (h, dh, d), ("heads", "head_dim", "fsdp"))


def project_heads(x, w):
    """``einsum("bsd,dhe->bshe")``: x ``(B, S, d)`` times w ``(d, H, E)``."""
    b, s, _ = x.shape
    out = (x @ w.reshape(w.shape[0], -1)).reshape(b, s, w.shape[1], w.shape[2])
    return contiguous_grad(out) if is_placed(out) else out


def merge_heads(o, w):
    """``einsum("bshe,hed->bsd")``: o ``(B, S, H, E)`` times w ``(H, E, d)``."""
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ w.reshape(-1, w.shape[-1])


def _qkv(cfg: ModelConfig, params, name: str, x, positions):
    q = project_heads(x, params[f"{name}.wq"])
    k = project_heads(x, params[f"{name}.wk"])
    v = project_heads(x, params[f"{name}.wv"])
    if not cfg.learned_pos:
        cos, sin = (replicated_like(t, x) for t in rope_frequencies(cfg, positions))
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    q = shard(q, "batch", "seq", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "kv_heads", "head_dim")
    return q, k, v


def apply_attention(cfg: ModelConfig, params, name: str, x, *, causal=True, window=0, q_block=1024,
                    kv_block=1024, impl=None):
    """Full-sequence (prefill) attention.  Returns ``(out, (k, v))``."""
    positions = torch.arange(x.shape[1], device=_device(x))
    q, k, v = _qkv(cfg, params, name, x, positions)
    o = attn_ops.flash_attention(
        q, k, v, causal=causal, window=window, q_block=q_block, kv_block=kv_block, impl=impl
    )
    return shard(merge_heads(o, params[f"{name}.wo"]), "batch", "seq", "embed"), (k, v)


def _device(x) -> torch.device:
    """The device of ``x``'s storage (a DTensor's local shard's)."""
    return x.to_local().device if hasattr(x, "to_local") else x.device


def apply_attention_decode(cfg: ModelConfig, params, name: str, x, cache, *, window=0):
    """One-token decode.  cache: ``{"k": (B, S_c, KV, Dh), "v": ..., "len": int}``.

    A window-sized cache (``S_c <= window``) is circular: the new token writes
    at ``len % S_c`` and every slot holds one of the last ``S_c`` positions
    (RoPE keys carry absolute positions, so the scores stay right after
    wrap-around).  The cache's k / v are updated in place (the JAX package
    returns new arrays); the returned dict holds the new ``len``.

    Under a mesh whose rules put ``kv_seq`` on ``model`` (see
    :func:`sp_cache_slice`) the cache is this rank's sequence slice (it also
    holds ``"seq_len"``, the whole cache's ``S_c``: :func:`init_attention_cache`
    makes it so) and the step runs the distributed flash-decoding of
    :mod:`repro_torch.parallel.sp_decode`.
    """
    pos = cache["len"]
    s_c = cache.get("seq_len", cache["k"].shape[1])
    circular = bool(window) and s_c <= window
    q = project_heads(x, params[f"{name}.wq"])
    k_new = project_heads(x, params[f"{name}.wk"])
    v_new = project_heads(x, params[f"{name}.wv"])
    if not cfg.learned_pos:
        cos, sin = rope_frequencies(cfg, torch.tensor([pos], device=x.device))
        q, k_new = apply_rope(q, cos, sin), apply_rope(k_new, cos, sin)
    sequence_parallel = sp_cache_slice(s_c, window) is not None
    if sequence_parallel != ("seq_len" in cache):
        raise ValueError("the cache was not made under this mesh and these rules (init_cache / prefill make it)")
    if sequence_parallel:
        o, k_cache, v_cache = sp_decode.sp_decode_attention_update(q, k_new, v_new, cache["k"], cache["v"], pos)
        out = merge_heads(o, params[f"{name}.wo"])
        return out, {"k": k_cache, "v": v_cache, "len": pos + 1, "seq_len": s_c}
    write_at = pos % s_c if circular else pos
    cache["k"][:, write_at] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, write_at] = v_new[:, 0].to(cache["v"].dtype)
    cur = min(pos + 1, s_c) if circular else pos + 1
    o = attn_ops.decode_attention(q, cache["k"], cache["v"], cur, window=0 if circular else window)
    out = merge_heads(o, params[f"{name}.wo"])
    return out, {"k": cache["k"], "v": cache["v"], "len": pos + 1}


def sp_cache_slice(s_c: int, window: int = 0) -> tuple[int, int] | None:
    """This rank's positions ``[start, stop)`` of an attention cache of
    ``s_c`` slots when decode runs sequence-parallel, else None: as in the JAX
    package, when the cache is not circular, the rules put ``kv_seq`` on
    ``model`` and the mesh's model axis divides ``s_c``."""
    circular = bool(window) and s_c <= window
    if circular or current_rules().get("kv_seq") != "model" or not sp_decode.sp_available(s_c):
        return None
    return sp_decode.sp_slice(s_c)


def init_attention_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device, *, window=0):
    """An empty cache of ``max_len`` slots, or, when decode runs
    sequence-parallel (:func:`sp_cache_slice`), this rank's slice of it with
    ``"seq_len": max_len``."""
    sl = sp_cache_slice(max_len, window)
    shape = (batch, max_len if sl is None else sl[1] - sl[0], cfg.n_kv_heads, cfg.d_head)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": 0,
    }
    if sl is not None:
        cache["seq_len"] = max_len
    return cache


def fill_attention_cache(cache: dict, k, v) -> None:
    """Writes a prompt's keys / values ``(B, S, KV, Dh)`` (positions ``[0,
    S)``) into a cache that is not circular: its slots ``[0, S)``, or the
    positions that fall in this rank's sequence slice."""
    s = k.shape[1]
    lo, n = 0, s
    if "seq_len" in cache:
        if s > cache["seq_len"]:
            raise ValueError(f"a prompt of {s} tokens in a cache of {cache['seq_len']} slots")
        lo = sp_decode.sp_slice(cache["seq_len"])[0]
        n = max(0, min(s - lo, cache["k"].shape[1]))
    cache["k"][:, :n] = k[:, lo:lo + n]
    cache["v"][:, :n] = v[:, lo:lo + n]
    cache["len"] = s


def attention_cache_axes() -> dict:
    return {
        "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
        "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
        "len": (),
    }


# ---------------------------------------------------------------------------
# MLP (gated GLU or plain)
# ---------------------------------------------------------------------------


def init_mlp(b: ParamBuilder, name: str, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.gated_mlp:
        b.dense(f"{name}.wi_gate", (d, f), ("fsdp", "mlp"))
    b.dense(f"{name}.wi_up", (d, f), ("fsdp", "mlp"))
    b.dense(f"{name}.wo", (f, d), ("mlp", "fsdp"))


def _act(cfg: ModelConfig, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if cfg.act == "silu" else F.gelu(x, approximate="tanh")


def apply_mlp(cfg: ModelConfig, params, name: str, x):
    up = x @ params[f"{name}.wi_up"]
    h = _act(cfg, x @ params[f"{name}.wi_gate"]) * up if cfg.gated_mlp else _act(cfg, up)
    h = shard(h, "batch", "seq", "mlp")
    return shard(h @ params[f"{name}.wo"], "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(b: ParamBuilder, cfg: ModelConfig):
    # the vocab is padded to a multiple of 128 as in the JAX package: logits
    # span the padded ids, and greedy sampling may pick one
    v = cfg.padded_vocab
    b.dense("embed.tokens", (v, cfg.d_model), ("vocab", "embed"), scale=1.0)
    if cfg.learned_pos:
        b.dense("embed.positions", (cfg.max_position, cfg.d_model), (None, "embed"), scale=0.02)
    if not cfg.tie_embeddings:
        b.dense("unembed", (cfg.d_model, v), ("embed", "vocab"))


def embed_tokens(cfg: ModelConfig, params, tokens, position_offset=0):
    table = params["embed.tokens"]
    x = _split_embedding(tokens.long(), table) if is_placed(table) else F.embedding(tokens.long(), table)
    if cfg.learned_pos:
        pos = replicated_like(torch.arange(tokens.shape[1], device=_device(tokens)) + position_offset, tokens)
        x = x + F.embedding(pos, params["embed.positions"])[None]
    return shard(x, "batch", "seq", "embed")


def _split_embedding(ids, table):
    """``F.embedding`` of placed ids in a placed table that may be split over
    the vocab: each rank looks up the ids in its block of rows (zeros for the
    others) and the ranks' rows are summed (``Partial``), so the table is
    never gathered.  (DTensor's own split lookup gives a masked partial that
    cannot take a partial cotangent back.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    table = keep_shards(table, (0,))
    mesh, t_pl = table.device_mesh, tuple(table.placements)
    ids_pl = tuple(p if p == Shard(0) and t == Replicate() else Replicate()
                   for p, t in zip(keep_shards(ids, (0,)).placements, t_pl))
    ids = ids.redistribute(mesh, ids_pl)
    index, count = split_index(table, 0)
    width = table.shape[0] // count
    lo = index * width

    def local(i, t):
        inside = (i >= lo) & (i < lo + width)
        x = F.embedding(torch.clamp(i - lo, 0, width - 1), t)
        return torch.where(inside[..., None], x, torch.zeros_like(x))

    out = tuple(Partial() if t == Shard(0) else p for p, t in zip(ids_pl, t_pl))
    # the table's gradient is each rank's part where the ids are split and the table is not
    t_grad = tuple(Partial() if p == Shard(0) else t for p, t in zip(ids_pl, t_pl))
    return local_call(local, (ids, table), out, (ids_pl, t_grad))


def unembed(cfg: ModelConfig, params, x):
    w = params["embed.tokens"].T if cfg.tie_embeddings else params["unembed"]
    logits = x @ w
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return shard(logits, "batch", "seq", "vocab")
