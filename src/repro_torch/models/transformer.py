"""Config-driven assembly of every architecture family: serving and training.

The port of :mod:`repro.models.transformer` for all its families: ``dense``,
``vlm`` (a dense backbone; precomputed ``vision_embeds`` spliced over the
token embeddings where ``vision_mask`` is set), ``moe`` (attention, then the
mixture of experts of :mod:`repro_torch.models.moe`, plus a dense MLP beside
it with ``dense_residual``), ``encdec`` (whisper: an encoder over
precomputed ``frames``, decoder layers with self- and cross-attention),
``hybrid`` (RG-LRU + local attention) and ``ssm`` (Mamba-1).  Layers are a
list of per-layer param dicts applied in a Python loop, as there; an
encoder-decoder keeps its encoder's layers in ``params["encoder"]``.

Every self-attention of a prefill or forward (the encoder's bidirectional
one included) goes through the flash-attention op; the decoder's
cross-attention over the encoder's output is the plain ``naive_attention``,
as in the JAX package, which runs it outside any Pallas kernel.

Public API: :func:`layer_kinds`, :func:`init_params`, :func:`forward`,
:func:`loss_fn`, :func:`init_cache`, :func:`prefill`, :func:`decode_step`.
:func:`forward` returns the logits only; the JAX package's ``aux`` (the MoE
layers' mean ``load_balance_loss`` and ``drop_frac``) comes from the private
:func:`_forward`, and :func:`loss_fn` returns it among its metrics.  Every entry point
runs on the GPU unless it is given ``device="cpu"`` (and raises without a GPU
otherwise); the parameters must lie on that device.  ``impl="plain"`` runs
the plain PyTorch versions of the prefill kernels (flash attention, SSM scan,
RG-LRU scan) where the kernels would run.  Decode is plain on every device,
as in the JAX package.  The cache's ``len`` is a Python int.

Training differentiates through the kernels: each runs inside a
``torch.autograd.Function`` whose backward recomputes its plain version (see
:mod:`repro_torch.kernels._launch`).  ``forward(..., remat=True)``
checkpoints each layer (``torch.utils.checkpoint``, non-reentrant), as the
JAX package's ``jax.checkpoint`` per layer does.
"""

from __future__ import annotations

import functools

import torch
from torch.utils import checkpoint as activation_checkpoint

from repro_torch.engine.base import resolve_device
from repro_torch.kernels import check_impl
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamBuilder, model_dtype

FAMILIES = ("dense", "vlm", "moe", "encdec", "hybrid", "ssm")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; known: {FAMILIES}")
    if cfg.family == "ssm":
        return ["mamba"] * cfg.n_layers
    if cfg.family == "hybrid":
        pattern = cfg.block_pattern or ("rec",)
        return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]
    if cfg.family == "moe":
        return ["moe"] * cfg.n_layers
    if cfg.family == "encdec":
        return ["decoder"] * cfg.n_layers
    return ["dense"] * cfg.n_layers  # dense | vlm


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if (cfg.family == "hybrid" and kind == "attn") else 0


def _device(params: dict, device) -> torch.device:
    """The device an entry point runs on (the GPU unless ``device`` names
    another); raises unless the parameters lie there."""
    dev = resolve_device(device)
    have = params["embed.tokens"].device
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"the parameters are on {have}, the call runs on {dev}")
    return have


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_layer(cfg: ModelConfig, kind: str, b: ParamBuilder) -> dict:
    if kind == "mamba":
        L.init_norm(b, "norm", cfg)
        S.init_mamba(b, "mixer", cfg)
    elif kind == "rec":
        L.init_norm(b, "norm1", cfg)
        R.init_rglru_block(b, "mixer", cfg)
        L.init_norm(b, "norm2", cfg)
        L.init_mlp(b, "mlp", cfg)
    elif kind == "moe":
        L.init_norm(b, "norm1", cfg)
        L.init_attention(b, "attn", cfg)
        L.init_norm(b, "norm2", cfg)
        M.init_moe(b, "moe", cfg)
        if cfg.dense_residual:
            L.init_mlp(b, "mlp", cfg)
    elif kind == "decoder":
        L.init_norm(b, "norm1", cfg)
        L.init_attention(b, "self_attn", cfg)
        L.init_norm(b, "norm_cross", cfg)
        L.init_attention(b, "cross_attn", cfg)
        L.init_norm(b, "norm2", cfg)
        L.init_mlp(b, "mlp", cfg)
    else:  # dense | attn | encoder
        L.init_norm(b, "norm1", cfg)
        L.init_attention(b, "attn", cfg)
        L.init_norm(b, "norm2", cfg)
        L.init_mlp(b, "mlp", cfg)
    return b.params


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters on ``device`` from a ``torch.Generator`` seeded with
    ``seed`` (``device="meta"`` gives their shapes and dtypes only)."""
    kinds = layer_kinds(cfg)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
    dtype = model_dtype(cfg)
    eb = ParamBuilder(gen, dev, dtype)
    L.init_embedding(eb, cfg)
    L.init_norm(eb, "final_norm", cfg)
    params = dict(eb.params)
    params["layers"] = [_init_layer(cfg, kind, ParamBuilder(gen, dev, dtype)) for kind in kinds]
    if cfg.family == "encdec":
        params["encoder"] = [_init_layer(cfg, "encoder", ParamBuilder(gen, dev, dtype))
                             for _ in range(cfg.encoder_layers)]
        nb = ParamBuilder(gen, dev, dtype)
        L.init_norm(nb, "encoder_norm", cfg)
        params.update(nb.params)
    return params


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------


def _apply_layer(cfg: ModelConfig, kind: str, p: dict, x, *, memory=None, q_block, kv_block, impl):
    """One layer over the whole sequence.  Returns ``(x, state, aux)``: the
    mixer's decode cache (Mamba / RG-LRU), the attention's ``(k, v)`` (a
    decoder adds its cross-attention's ``(k, v)`` over ``memory``, the
    encoder's output), and a MoE layer's aux (else None)."""
    if kind == "mamba":
        h, state = S.apply_mamba_prefill(cfg, p, "mixer", L.apply_norm(cfg, p, "norm", x), impl=impl)
        return x + h, state, None
    attn = dict(q_block=q_block, kv_block=kv_block, impl=impl)
    if kind == "rec":
        h, state = R.apply_rglru_prefill(cfg, p, "mixer", L.apply_norm(cfg, p, "norm1", x), impl=impl)
    elif kind == "decoder":
        h, state = L.apply_attention(cfg, p, "self_attn", L.apply_norm(cfg, p, "norm1", x), causal=True, **attn)
        x = x + h
        ck = L.project_heads(memory, p["cross_attn.wk"])
        cv = L.project_heads(memory, p["cross_attn.wv"])
        h = _cross_attention(p, "cross_attn", L.apply_norm(cfg, p, "norm_cross", x), ck, cv)
        state = (*state, ck, cv)
    else:
        h, state = L.apply_attention(
            cfg, p, "attn", L.apply_norm(cfg, p, "norm1", x), causal=kind != "encoder", window=_window(cfg, kind),
            **attn,
        )
    x, aux = _feed_forward(cfg, kind, p, x + h)
    return x, state, aux


def _feed_forward(cfg: ModelConfig, kind: str, p: dict, x):
    """The layer's second half on the residual stream x: the MLP, or a MoE
    layer's experts (plus the dense MLP beside them with ``dense_residual``).
    Returns ``(x, the MoE's aux or None)``."""
    h = L.apply_norm(cfg, p, "norm2", x)
    if kind != "moe":
        return x + L.apply_mlp(cfg, p, "mlp", h), None
    y, aux = M.apply_moe(cfg, p, "moe", h)
    if cfg.dense_residual:
        y = y + L.apply_mlp(cfg, p, "mlp", h)
    return x + y, aux


def _cross_attention(p: dict, name: str, x, k, v):
    """Dense cross-attention of x over the encoder's keys / values (short:
    whisper's 1500 frames), the plain ``naive_attention`` on every path."""
    q = L.project_heads(x, p[f"{name}.wq"])
    o = attn_ref.naive_attention(q, k, v, causal=False)
    return L.merge_heads(o, p[f"{name}.wo"])


def _layer_output(cfg: ModelConfig, kind: str, p: dict, x, memory, *, q_block, kv_block, impl):
    x, _, aux = _apply_layer(cfg, kind, p, x, memory=memory, q_block=q_block, kv_block=kv_block, impl=impl)
    return x, aux


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict, dev):
    """Token embeddings; a VLM's ``batch["vision_embeds"] (B, Tv, d)`` replace
    them where ``batch["vision_mask"] (B, S)`` is set, the i-th set position of
    a row taking the i-th embedding (the frontend is stubbed, as there)."""
    x = L.embed_tokens(cfg, params, torch.as_tensor(batch["tokens"], device=dev))
    if cfg.family == "vlm" and "vision_embeds" in batch:
        ve = torch.as_tensor(batch["vision_embeds"], device=dev).to(x.dtype)
        mask = torch.as_tensor(batch["vision_mask"], device=dev).bool()
        idx = torch.clamp(torch.cumsum(mask.int(), dim=1) - 1, 0, ve.shape[1] - 1)
        spliced = torch.gather(ve, 1, idx[..., None].expand(-1, -1, ve.shape[2]))
        x = torch.where(mask[..., None], spliced, x)
    return x


def _encode(cfg: ModelConfig, params: dict, frames, dev, *, q_block, kv_block, impl):
    """The encoder over ``frames (B, T, d)``: the learned position table of the
    decoder's embedding added (as the JAX package does), bidirectional
    self-attention layers, ``encoder_norm``."""
    x = torch.as_tensor(frames, device=dev).to(params["embed.tokens"].dtype)
    if cfg.learned_pos:
        x = x + params["embed.positions"][: x.shape[1]][None]
    for p in params["encoder"]:
        x = _apply_layer(cfg, "encoder", p, x, q_block=q_block, kv_block=kv_block, impl=impl)[0]
    return L.apply_norm(cfg, params, "encoder_norm", x)


def _forward(cfg: ModelConfig, params: dict, batch: dict, *, q_block: int = 1024, kv_block: int = 1024,
             remat: bool = False, impl=None, device=None):
    """:func:`forward`'s logits and the JAX package's aux: the MoE layers'
    mean ``load_balance_loss`` and ``drop_frac`` (float32 zeros without)."""
    check_impl(impl)
    dev = _device(params, device)
    kw = dict(q_block=q_block, kv_block=kv_block, impl=impl)
    x = _embed_inputs(cfg, params, batch, dev)
    memory = _encode(cfg, params, batch["frames"], dev, **kw) if cfg.family == "encdec" else None
    kinds = layer_kinds(cfg)
    n_moe = max(1, kinds.count("moe"))
    aux = {name: torch.zeros((), dtype=torch.float32, device=dev) for name in ("load_balance_loss", "drop_frac")}
    for kind, p in zip(kinds, params["layers"]):
        fn = functools.partial(_layer_output, cfg, kind, **kw)
        if remat:
            x, layer_aux = activation_checkpoint.checkpoint(fn, p, x, memory, use_reentrant=False)
        else:
            x, layer_aux = fn(p, x, memory)
        if layer_aux is not None:
            for name in aux:
                aux[name] = aux[name] + layer_aux[name] / n_moe
    return L.unembed(cfg, params, L.apply_norm(cfg, params, "final_norm", x)), aux


def forward(cfg: ModelConfig, params: dict, batch: dict, *, q_block: int = 1024, kv_block: int = 1024,
            remat: bool = False, impl=None, device=None):
    """Logits ``(B, S, V_pad)`` of a full forward over ``batch["tokens"]``
    (with ``frames`` for an encoder-decoder; ``vision_embeds`` and
    ``vision_mask`` for a VLM, when given).  ``remat``: keep only each layer's
    input for the backward and recompute the layer there."""
    return _forward(cfg, params, batch, q_block=q_block, kv_block=kv_block, remat=remat, impl=impl,
                    device=device)[0]


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, **fw_kwargs):
    """Next-token cross-entropy over ``batch["labels"]`` (labels < 0 are
    ignored), with the log-sum-exp in float32; a MoE model adds
    ``router_aux_weight * load_balance_loss``.  Returns ``(loss, metrics)``
    with metrics ``loss``, ``nll``, ``load_balance_loss`` and ``drop_frac``.
    ``fw_kwargs`` go to :func:`forward`."""
    logits, aux = _forward(cfg, params, batch, **fw_kwargs)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    valid = labels >= 0
    labels_c = torch.clamp_min(labels, 0).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    label_logit = torch.gather(logits, -1, labels_c[..., None])[..., 0].float()
    nll = (lse - label_logit) * valid.float()
    n_valid = torch.clamp_min(valid.sum(), 1)
    loss = nll.sum() / n_valid
    if cfg.family == "moe":
        loss = loss + cfg.router_aux_weight * aux["load_balance_loss"]
    return loss, {"loss": loss, "nll": nll.sum() / n_valid, **aux}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _attn_cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if _window(cfg, kind):
        return min(max_len, cfg.window)  # rolling window cache
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *, device=None) -> dict:
    """An empty cache for ``batch`` requests of up to ``max_len`` tokens
    (``dtype``: the model's unless given)."""
    kinds = layer_kinds(cfg)
    dev = resolve_device(device)
    dtype = dtype or model_dtype(cfg)
    caches = []
    for kind in kinds:
        if kind == "mamba":
            caches.append(S.init_mamba_cache(cfg, batch, dtype, dev))
        elif kind == "rec":
            caches.append(R.init_rglru_cache(cfg, batch, dtype, dev))
        elif kind == "decoder":
            cross = (batch, cfg.encoder_positions, cfg.n_kv_heads, cfg.d_head)
            caches.append({
                "self": L.init_attention_cache(cfg, batch, max_len, dtype, dev),
                "cross_k": torch.zeros(cross, dtype=dtype, device=dev),
                "cross_v": torch.zeros(cross, dtype=dtype, device=dev),
            })
        else:
            caches.append(L.init_attention_cache(cfg, batch, _attn_cache_len(cfg, kind, max_len), dtype, dev))
    return {"layers": caches, "len": 0}


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int, *, q_block: int = 1024,
            kv_block: int = 1024, impl=None, device=None):
    """Run the prompt ``batch["tokens"] (B, S)`` (dense, no padding), fill the
    cache at positions ``[0, S)``, and return ``(last logits (B, 1, V_pad),
    cache)``.  An encoder-decoder encodes ``batch["frames"]`` first and keeps
    each decoder layer's cross-attention keys / values in its cache; a VLM
    splices ``batch["vision_embeds"]`` over ``batch["vision_mask"]``.  A window
    cache shorter than the prompt keeps the last positions, position p at slot
    ``p % window`` (decode's circular indexing)."""
    check_impl(impl)
    dev = _device(params, device)
    kw = dict(q_block=q_block, kv_block=kv_block, impl=impl)
    s = torch.as_tensor(batch["tokens"]).shape[1]
    dtype = model_dtype(cfg)
    x = _embed_inputs(cfg, params, batch, dev)
    cache = init_cache(cfg, x.shape[0], max_len, dtype, device=dev)
    memory = _encode(cfg, params, batch["frames"], dev, **kw) if cfg.family == "encdec" else None
    new_caches = []
    for kind, p, lc in zip(layer_kinds(cfg), params["layers"], cache["layers"]):
        x, state, _ = _apply_layer(cfg, kind, p, x, memory=memory, **kw)
        if kind in ("mamba", "rec"):
            new_caches.append({"conv": state["conv"].to(dtype), "h": state["h"]})
            continue
        if kind == "decoder":
            k, v, ck, cv = state
            lc["self"]["k"][:, :s] = k
            lc["self"]["v"][:, :s] = v
            lc["self"]["len"] = s
            new_caches.append({"self": lc["self"], "cross_k": ck.to(dtype), "cross_v": cv.to(dtype)})
            continue
        k, v = state
        clen = lc["k"].shape[1]
        if clen < s:
            lc["k"] = torch.roll(k[:, -clen:], s % clen, dims=1).to(dtype)
            lc["v"] = torch.roll(v[:, -clen:], s % clen, dims=1).to(dtype)
        else:
            lc["k"][:, :s] = k
            lc["v"][:, :s] = v
        lc["len"] = s
        new_caches.append(lc)
    x = L.apply_norm(cfg, params, "final_norm", x[:, -1:])
    return L.unembed(cfg, params, x), {"layers": new_caches, "len": s}


def decode_step(cfg: ModelConfig, params: dict, tokens, cache: dict, *, device=None):
    """One decode step: tokens ``(B, 1)`` -> ``(logits (B, 1, V_pad), new
    cache)``.  The attention caches' k / v are updated in place."""
    dev = _device(params, device)
    pos = cache["len"]
    x = L.embed_tokens(cfg, params, torch.as_tensor(tokens, device=dev), position_offset=pos)
    new_caches = []
    for kind, p, lc in zip(layer_kinds(cfg), params["layers"], cache["layers"]):
        if kind == "mamba":
            h, nc = S.apply_mamba_decode(cfg, p, "mixer", L.apply_norm(cfg, p, "norm", x), lc)
            new_caches.append(nc)
            x = x + h
            continue
        if kind == "rec":
            h, nc = R.apply_rglru_decode(cfg, p, "mixer", L.apply_norm(cfg, p, "norm1", x), lc)
        elif kind == "decoder":
            h, sc = L.apply_attention_decode(cfg, p, "self_attn", L.apply_norm(cfg, p, "norm1", x), lc["self"])
            x = x + h
            h = _cross_attention(p, "cross_attn", L.apply_norm(cfg, p, "norm_cross", x), lc["cross_k"], lc["cross_v"])
            nc = {"self": sc, "cross_k": lc["cross_k"], "cross_v": lc["cross_v"]}
        else:
            h, nc = L.apply_attention_decode(
                cfg, p, "attn", L.apply_norm(cfg, p, "norm1", x), lc, window=_window(cfg, kind)
            )
        new_caches.append(nc)
        x = _feed_forward(cfg, kind, p, x + h)[0]
    logits = L.unembed(cfg, params, L.apply_norm(cfg, params, "final_norm", x))
    return logits, {"layers": new_caches, "len": pos + 1}
