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

from collections.abc import Callable
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamBuilder
from repro_torch.parallel import sp_decode
from repro_torch.parallel.sharding import (
    contiguous_grad, current_rules, is_placed, keep_shards, local_call, replicated_like, shard, split_index,
    update_slice,
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


def uses_rope(cfg: ModelConfig) -> bool:
    """Whether attention rotates q and k: not with learned positions (whisper),
    nor in the ``jamba`` family, whose attention has no positional encoding."""
    return not cfg.learned_pos and cfg.family != "jamba"


def _qkv(cfg: ModelConfig, params, name: str, x, positions):
    q = project_heads(x, params[f"{name}.wq"])
    k = project_heads(x, params[f"{name}.wk"])
    v = project_heads(x, params[f"{name}.wv"])
    if uses_rope(cfg):
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
    if is_placed(cache["k"]):
        return _placed_attention_decode(cfg, params, name, x, cache, window)
    pos = cache["len"]
    s_c = cache.get("seq_len", cache["k"].shape[1])
    circular = bool(window) and s_c <= window
    q = project_heads(x, params[f"{name}.wq"])
    k_new = project_heads(x, params[f"{name}.wk"])
    v_new = project_heads(x, params[f"{name}.wv"])
    if uses_rope(cfg):
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


def _placed_attention_decode(cfg: ModelConfig, params, name: str, x, cache, window):
    """:func:`apply_attention_decode` on a cache placed by
    :func:`attention_cache_axes` (the JAX package's GSPMD decode).  The new
    token's key / value are written into each rank's shard of the cache in
    place (:func:`~repro_torch.parallel.sharding.update_slice`), and the
    decode attention runs on each rank's rows and heads
    (:func:`~repro_torch.kernels.flash_attention.ops.on_local_heads`).  When
    the rules put ``kv_seq`` on ``model`` and the cache is not circular, the
    cache is split along its slots over ``model`` and each rank runs
    :mod:`repro_torch.parallel.sp_decode`'s merge on its slice, as the JAX
    package runs its ``shard_map`` inside GSPMD."""
    pos = cache["len"]
    s_c = cache["k"].shape[1]
    circular = bool(window) and s_c <= window
    q, k_new, v_new = _qkv(cfg, params, name, x, torch.tensor([pos], device=_device(x)))
    if not circular and current_rules().get("kv_seq") == "model" and sp_decode.sp_available(s_c):
        o = _sp_decode_placed(q, k_new, v_new, cache, pos)
    else:
        write_at = pos % s_c if circular else pos
        update_slice(cache["k"], k_new, write_at)
        update_slice(cache["v"], v_new, write_at)
        cur = min(pos + 1, s_c) if circular else pos + 1
        k, v = (keep_shards(cache[n], (0, 2)) for n in ("k", "v"))  # a cache split along its slots is gathered
        o = attn_ops.on_local_heads(attn_ops.decode_attention, q, k, v, cur_len=cur, window=0 if circular else window)
    out = shard(merge_heads(o, params[f"{name}.wo"]), "batch", "seq", "embed")
    return out, {"k": cache["k"], "v": cache["v"], "len": pos + 1}


def _sp_decode_placed(q, k_new, v_new, cache, pos: int):
    """Sequence-parallel decode on a cache placed ``("batch", "kv_seq" ->
    "model", ...)``: q and the new key / value whole over ``model`` (their rows
    split as the cache's), and :func:`repro_torch.parallel.sp_decode.
    sp_decode_attention_update` on each rank's rows and slice of slots (its
    append writes the owning rank's shard of the cache in place)."""
    from torch.distributed.tensor import Shard

    mesh, pl = cache["k"].device_mesh, tuple(cache["k"].placements)
    if pl[mesh.mesh_dim_names.index("model")] != Shard(1):
        raise ValueError(f"a cache placed {pl} under rules that put kv_seq on model (place it by cache_axes)")
    rows = tuple(keep_shards(cache["k"], (0,)).placements)
    q, k_new, v_new = (t if tuple(t.placements) == rows else t.redistribute(mesh, rows) for t in (q, k_new, v_new))

    def local(ql, kn, vn, kc, vc):
        return sp_decode.sp_decode_attention_update(ql, kn, vn, kc, vc, pos)[0]

    return local_call(local, (q, k_new, v_new, cache["k"], cache["v"]), rows)


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
    S)``) into a cache: its slots ``[0, S)``, or the positions that fall in
    this rank's sequence slice; a window cache shorter than the prompt keeps
    the last positions, position p at slot ``p % slots`` (decode's circular
    indexing; a sequence slice is never circular)."""
    s = k.shape[1]
    slots = cache["k"].shape[1]
    if slots < s and "seq_len" not in cache:
        cache["k"], cache["v"] = (_window_tail(t, slots, s, cache["k"].dtype) for t in (k, v))
        cache["len"] = s
        return
    if is_placed(cache["k"]):  # each rank writes the positions in its shard (a cache split along its slots too)
        update_slice(cache["k"], k, 0)
        update_slice(cache["v"], v, 0)
        cache["len"] = s
        return
    lo, n = 0, s
    if "seq_len" in cache:
        if s > cache["seq_len"]:
            raise ValueError(f"a prompt of {s} tokens in a cache of {cache['seq_len']} slots")
        lo = sp_decode.sp_slice(cache["seq_len"])[0]
        n = max(0, min(s - lo, cache["k"].shape[1]))
    cache["k"][:, :n] = k[:, lo:lo + n]
    cache["v"][:, :n] = v[:, lo:lo + n]
    cache["len"] = s


def _window_tail(k, slots: int, s: int, dtype):
    """A window cache of ``slots`` slots from a prompt's keys / values ``(B,
    S, KV, D)``: the last ``slots`` positions, position p at slot ``p %
    slots`` (placed: on each rank's rows and heads, the sequence whole)."""
    def tail(t):
        return torch.roll(t[:, -slots:], s % slots, dims=1).to(dtype)

    if not is_placed(k):
        return tail(k)
    k = keep_shards(k, (0, 2))
    return local_call(tail, (k,), tuple(k.placements))


def attention_cache_axes() -> dict:
    return {
        "k": ("batch", "kv_seq", "kv_heads", "head_dim"),
        "v": ("batch", "kv_seq", "kv_heads", "head_dim"),
        "len": (),
    }


class Mixer(NamedTuple):
    """What mixes a layer's positions, as its module gives it: five
    operations of the same signatures for every mixer.

    ``init(b, name, cfg)`` draws its parameters under ``name``;
    ``apply(cfg, params, name, x, cache, *, q_block, kv_block, impl)`` runs it
    over a whole normed sequence ``x (B, S, d)`` and returns ``(h, cache)``:
    ``cache`` is the empty decode cache a prefill fills (None in a forward,
    where attention returns None; a scan returns its own last state);
    ``decode(cfg, params, name, x, cache, *, impl)`` runs one token and
    returns ``(h, new cache)``; ``init_cache(cfg, batch, max_len, dtype,
    device)`` makes an empty cache for ``max_len`` positions; ``cache_axes()``
    gives its logical axes."""

    init: Callable
    apply: Callable
    decode: Callable
    init_cache: Callable
    cache_axes: Callable


def attention_mixer(*, causal: bool = True, local: bool = False) -> Mixer:
    """Self-attention as a :class:`Mixer`: causal or bidirectional, over
    every position or, ``local``, the last ``cfg.window``, whose cache holds
    ``min(max_len, cfg.window)`` slots written circularly."""
    def window(cfg: ModelConfig) -> int:
        return cfg.window if local else 0

    def apply(cfg: ModelConfig, params, name: str, x, cache, *, q_block, kv_block, impl):
        h, (k, v) = apply_attention(cfg, params, name, x, causal=causal, window=window(cfg), q_block=q_block,
                                    kv_block=kv_block, impl=impl)
        if cache is not None:
            fill_attention_cache(cache, k, v)
        return h, cache

    def decode(cfg: ModelConfig, params, name: str, x, cache, *, impl):
        # the one-token attention runs no kernel
        return apply_attention_decode(cfg, params, name, x, cache, window=window(cfg))

    def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
        w = window(cfg)
        return init_attention_cache(cfg, batch, min(max_len, w) if w else max_len, dtype, device, window=w)

    return Mixer(init_attention, apply, decode, init_cache, attention_cache_axes)


ATTENTION = attention_mixer()
LOCAL_ATTENTION = attention_mixer(local=True)
BIDIRECTIONAL_ATTENTION = attention_mixer(causal=False)


def scan_mixer(init, prefill, decode, init_cache, cache_axes) -> Mixer:
    """A recurrent scan as a :class:`Mixer`, from its module's functions:
    ``prefill(cfg, params, name, x, *, impl)`` makes the decode cache itself
    (the empty one and the attention's tiles it is handed go unused),
    ``decode`` is the Mixer's own, and ``init_cache(cfg, batch, dtype,
    device)``'s state does not grow with ``max_len``."""
    def apply(cfg: ModelConfig, params, name: str, x, cache, *, q_block, kv_block, impl):
        return prefill(cfg, params, name, x, impl=impl)

    def empty_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
        return init_cache(cfg, batch, dtype, device)

    return Mixer(init, apply, decode, empty_cache, cache_axes)


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
