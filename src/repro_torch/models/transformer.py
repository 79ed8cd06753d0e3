"""Config-driven assembly of the dense, hybrid and Mamba-1 families: serving and training.

The port of :mod:`repro.models.transformer` for families ``dense``,
``hybrid`` (RG-LRU + local attention) and ``ssm`` (Mamba-1); the others
raise ``NotImplementedError``.  Layers are a list of per-layer param dicts
applied in a Python loop, as there.

Public API: :func:`layer_kinds`, :func:`init_params`, :func:`forward`,
:func:`loss_fn`, :func:`init_cache`, :func:`prefill`, :func:`decode_step`.  Every entry point
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
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamBuilder, model_dtype

FAMILIES = ("dense", "hybrid", "ssm")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet; ported: {FAMILIES}")


def layer_kinds(cfg: ModelConfig) -> list[str]:
    _check_family(cfg)
    if cfg.family == "ssm":
        return ["mamba"] * cfg.n_layers
    if cfg.family == "hybrid":
        pattern = cfg.block_pattern or ("rec",)
        return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]
    return ["dense"] * cfg.n_layers


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
    else:  # dense | attn
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
    return params


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------


def _apply_layer(cfg: ModelConfig, kind: str, p: dict, x, *, q_block, kv_block, impl):
    """One layer over the whole sequence.  Returns ``(x, state)``: the
    mixer's decode cache (Mamba / RG-LRU) or the attention's ``(k, v)``."""
    if kind == "mamba":
        h, state = S.apply_mamba_prefill(cfg, p, "mixer", L.apply_norm(cfg, p, "norm", x), impl=impl)
        return x + h, state
    if kind == "rec":
        h, state = R.apply_rglru_prefill(cfg, p, "mixer", L.apply_norm(cfg, p, "norm1", x), impl=impl)
    else:
        h, state = L.apply_attention(
            cfg, p, "attn", L.apply_norm(cfg, p, "norm1", x), causal=True, window=_window(cfg, kind),
            q_block=q_block, kv_block=kv_block, impl=impl,
        )
    x = x + h
    return x + L.apply_mlp(cfg, p, "mlp", L.apply_norm(cfg, p, "norm2", x)), state


def _layer_output(cfg: ModelConfig, kind: str, p: dict, x, *, q_block, kv_block, impl):
    return _apply_layer(cfg, kind, p, x, q_block=q_block, kv_block=kv_block, impl=impl)[0]


def forward(cfg: ModelConfig, params: dict, batch: dict, *, q_block: int = 1024, kv_block: int = 1024,
            remat: bool = False, impl=None, device=None):
    """Logits ``(B, S, V_pad)`` of a full forward over ``batch["tokens"]``.
    ``remat``: keep only each layer's input for the backward and recompute
    the layer there."""
    check_impl(impl)
    dev = _device(params, device)
    x = L.embed_tokens(cfg, params, torch.as_tensor(batch["tokens"], device=dev))
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        fn = functools.partial(_layer_output, cfg, kind, q_block=q_block, kv_block=kv_block, impl=impl)
        x = activation_checkpoint.checkpoint(fn, p, x, use_reentrant=False) if remat else fn(p, x)
    return L.unembed(cfg, params, L.apply_norm(cfg, params, "final_norm", x))


def loss_fn(cfg: ModelConfig, params: dict, batch: dict, **fw_kwargs):
    """Next-token cross-entropy over ``batch["labels"]`` (labels < 0 are
    ignored), with the log-sum-exp in float32.  Returns ``(loss, metrics)``
    with metrics ``loss`` and ``nll``.  ``fw_kwargs`` go to :func:`forward`."""
    logits = forward(cfg, params, batch, **fw_kwargs)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    valid = labels >= 0
    labels_c = torch.clamp_min(labels, 0).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    label_logit = torch.gather(logits, -1, labels_c[..., None])[..., 0].float()
    nll = (lse - label_logit) * valid.float()
    n_valid = torch.clamp_min(valid.sum(), 1)
    loss = nll.sum() / n_valid
    return loss, {"loss": loss, "nll": nll.sum() / n_valid}


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
        else:
            caches.append(L.init_attention_cache(cfg, batch, _attn_cache_len(cfg, kind, max_len), dtype, dev))
    return {"layers": caches, "len": 0}


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int, *, q_block: int = 1024,
            kv_block: int = 1024, impl=None, device=None):
    """Run the prompt ``batch["tokens"] (B, S)`` (dense, no padding), fill the
    cache at positions ``[0, S)``, and return ``(last logits (B, 1, V_pad),
    cache)``.  A window cache shorter than the prompt keeps the last positions,
    position p at slot ``p % window`` (decode's circular indexing)."""
    check_impl(impl)
    dev = _device(params, device)
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    s = tokens.shape[1]
    dtype = model_dtype(cfg)
    cache = init_cache(cfg, tokens.shape[0], max_len, dtype, device=dev)
    x = L.embed_tokens(cfg, params, tokens)
    new_caches = []
    for kind, p, lc in zip(layer_kinds(cfg), params["layers"], cache["layers"]):
        x, state = _apply_layer(cfg, kind, p, x, q_block=q_block, kv_block=kv_block, impl=impl)
        if kind in ("mamba", "rec"):
            new_caches.append({"conv": state["conv"].to(dtype), "h": state["h"]})
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
            x = x + h
        else:
            if kind == "rec":
                h, nc = R.apply_rglru_decode(cfg, p, "mixer", L.apply_norm(cfg, p, "norm1", x), lc)
            else:
                h, nc = L.apply_attention_decode(
                    cfg, p, "attn", L.apply_norm(cfg, p, "norm1", x), lc, window=_window(cfg, kind)
                )
            x = x + h
            x = x + L.apply_mlp(cfg, p, "mlp", L.apply_norm(cfg, p, "norm2", x))
        new_caches.append(nc)
    logits = L.unembed(cfg, params, L.apply_norm(cfg, params, "final_norm", x))
    return logits, {"layers": new_caches, "len": pos + 1}
