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

Public API: :func:`layer_kinds`, :func:`init_params`, :func:`param_axes`,
:func:`abstract_params`, :func:`forward`, :func:`loss_fn`, :func:`init_cache`,
:func:`cache_axes`, :func:`prefill`, :func:`decode_step`.
:func:`forward` returns the logits only; the JAX package's ``aux`` (the MoE
layers' mean ``load_balance_loss`` and ``drop_frac``) comes from the private
:func:`_forward`, and :func:`loss_fn` returns it among its metrics.  Every entry point
runs on the GPU unless it is given ``device="cpu"`` (and raises without a GPU
otherwise); the parameters must lie on that device.  ``impl="plain"`` runs
the plain PyTorch versions of the prefill kernels (flash attention, SSM scan,
RG-LRU scan) where the kernels would run.  Decode is plain on every device,
as in the JAX package.  The cache's ``len`` is a Python int.

Under a mesh (:func:`repro_torch.parallel.use_compat_mesh`) a process is one
rank, in one of two ways:

  * Placed (the JAX package's GSPMD): the parameters and the batch are
    DTensors placed by the logical-axes rules
    (:func:`repro_torch.parallel.sharding.place` with
    :func:`~repro_torch.parallel.sharding.shard_params`' placements; tokens
    and labels by ``("batch", "seq")``, the rest by :data:`BATCH_AXES`).
    :func:`forward`, :func:`loss_fn`, :func:`prefill` and :func:`decode_step`
    run on them for every family: each layer first gathers its parameters
    over the ``fsdp`` axes (ZeRO-3: one redistribution, whose backward is the
    reduce-scatter of their gradients), the layers' ``shard`` annotations
    place the activations, DTensor inserts the collectives, and the kernels
    run on each rank's local shards; what is row-local (a MoE layer's
    dispatch, a VLM's splice) runs on each rank's rows (``local_map``).  The
    loss is the mean over the global batch.  :func:`prefill` returns a cache
    placed by :func:`cache_axes` (``init_cache(..., mesh=)`` makes an empty
    one), and :func:`decode_step` writes each rank's shard of it in place.
  * Explicit (``shard_map``): plain tensors, each rank's local shard: its
    rows of the batch, the whole parameters (a MoE layer with
    ``moe_impl="ep"`` runs its rank's experts:
    :mod:`repro_torch.models.moe_ep`), and, when the rules put ``kv_seq`` on
    ``model``, its sequence slice of every attention cache that is not
    circular (:func:`init_cache` and :func:`prefill` make it;
    :func:`decode_step` merges the ranks' attention:
    :mod:`repro_torch.parallel.sp_decode`).

Training differentiates through the kernels: each runs inside a
``torch.autograd.Function`` whose backward recomputes its plain version (see
:mod:`repro_torch.kernels._launch`).  ``forward(..., remat=True)``
checkpoints each layer (``torch.utils.checkpoint``, non-reentrant), as the
JAX package's ``jax.checkpoint`` per layer does.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils import checkpoint as activation_checkpoint

from repro_torch import obs
from repro_torch.data import threefry
from repro_torch.engine.base import resolve_device
from repro_torch.kernels import check_impl
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import moe_ep as MEP
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamBuilder, model_dtype
from repro_torch.parallel import sharding as SH

FAMILIES = ("dense", "vlm", "moe", "encdec", "hybrid", "ssm")
#: The logical axes a batch entry is placed by on a mesh (a decode step's
#: tokens ``(B, 1)`` as ``tokens``: ``"seq"`` is on no mesh axis).
BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"), "vision_mask": ("batch", "seq"),
              "vision_embeds": ("batch", None, "embed"), "frames": ("batch", None, "embed")}


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


def place_batch(mesh, batch: dict) -> dict:
    """A batch (each entry the same whole tensor on every rank) placed on
    ``mesh`` by :data:`BATCH_AXES` (a placed entry is kept as it is)."""
    out = {}
    for k, v in batch.items():
        if SH.is_placed(v):
            out[k] = v
            continue
        v = torch.as_tensor(v)
        axes = BATCH_AXES.get(k, ("batch",) + (None,) * (v.dim() - 1))
        out[k] = SH.place(v, mesh, SH.logical_sharding(mesh, axes, shape=tuple(v.shape)))
    return out


def _mesh_of(params: dict):
    """The context of an entry point: the placed parameters' mesh made ambient
    when no mesh is (a no-op off a mesh)."""
    table = params["embed.tokens"]
    if SH.is_placed(table) and SH.active_abstract_mesh().empty:
        return SH.use_compat_mesh(table.device_mesh)
    return contextlib.nullcontext()


def _device(params: dict, device) -> torch.device:
    """The device an entry point runs on (the GPU unless ``device`` names
    another); raises unless the parameters lie there (a placed parameter's
    local shard)."""
    dev = resolve_device(device)
    table = params["embed.tokens"]
    have = (table.to_local() if SH.is_placed(table) else table).device
    if have.type != dev.type or (dev.index is not None and have.index != dev.index):
        raise ValueError(f"the parameters are on {have}, the call runs on {dev}")
    return have


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_layer(cfg: ModelConfig, kind: str, b: ParamBuilder) -> ParamBuilder:
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
    return b


def init_params(cfg: ModelConfig, seed: int = 0, *, device=None) -> dict:
    """Random parameters on ``device``: the JAX package's ``init_params(cfg,
    PRNGKey(seed))``, drawn in its stream (see
    :mod:`repro_torch.models.params`); ``device="meta"`` gives their shapes
    and dtypes only."""
    return _init(cfg, seed, device)[0]


def param_axes(cfg: ModelConfig) -> dict:
    """The logical-axes tree matching :func:`init_params` (the JAX package's
    ``param_axes``), built on the meta device: nothing is allocated."""
    return _init(cfg, 0, "meta")[1]


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree as meta tensors: the shapes and dtypes of
    :func:`init_params` without storage (the JAX package's ``eval_shape``)."""
    return _init(cfg, 0, "meta")[0]


def _init(cfg: ModelConfig, seed: int, device) -> tuple[dict, dict]:
    kinds = layer_kinds(cfg)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    # the JAX package's keys: split(PRNGKey(seed), n_layers + 3) -> embeddings, each layer, ..., the encoder
    keys = [None] * (cfg.n_layers + 3) if dev.type == "meta" else threefry.split(threefry.prng_key(seed),
                                                                                  cfg.n_layers + 3)
    dtype = model_dtype(cfg)
    eb = ParamBuilder(keys[0], dev, dtype)
    L.init_embedding(eb, cfg)
    L.init_norm(eb, "final_norm", cfg)
    params, axes = dict(eb.params), dict(eb.axes)
    layers = [_init_layer(cfg, kind, ParamBuilder(keys[i + 1], dev, dtype)) for i, kind in enumerate(kinds)]
    params["layers"], axes["layers"] = [b.params for b in layers], [b.axes for b in layers]
    if cfg.family == "encdec":
        enc_keys = [None] * cfg.encoder_layers if dev.type == "meta" else threefry.split(keys[-1], cfg.encoder_layers)
        enc = [_init_layer(cfg, "encoder", ParamBuilder(k, dev, dtype)) for k in enc_keys]
        params["encoder"], axes["encoder"] = [b.params for b in enc], [b.axes for b in enc]
        nb = ParamBuilder(keys[-2], dev, dtype)
        L.init_norm(nb, "encoder_norm", cfg)
        params.update(nb.params)
        axes.update(nb.axes)
    return params, axes


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------


def _fsdp_gather(p: dict) -> dict:
    """A layer's placed parameters whole over the data axes (ZeRO-3's gather
    of the ``fsdp`` axis): every ``Shard`` on a mesh dimension that the
    rules' ``fsdp`` axes name becomes ``Replicate()``, the ``model`` split
    stays.  One redistribution per leaf; its backward reduce-scatters the
    gradient back to the leaf's own placements."""
    from torch.distributed.tensor import Replicate, Shard

    fsdp = SH.current_rules().get("fsdp") or ()
    fsdp = (fsdp,) if isinstance(fsdp, str) else tuple(fsdp)
    out = {}
    for name, w in p.items():
        names = w.device_mesh.mesh_dim_names
        want = tuple(Replicate() if isinstance(pl, Shard) and names[m] in fsdp else pl
                     for m, pl in enumerate(w.placements))
        out[name] = w if want == tuple(w.placements) else w.redistribute(w.device_mesh, want)
    return out


def _apply_layer(cfg: ModelConfig, kind: str, p: dict, x, *, memory=None, q_block, kv_block, impl):
    """One layer over the whole sequence.  Returns ``(x, state, aux)``: the
    mixer's decode cache (Mamba / RG-LRU), the attention's ``(k, v)`` (a
    decoder adds its cross-attention's ``(k, v)`` over ``memory``, the
    encoder's output), and a MoE layer's aux (else None).  Placed parameters
    are gathered over the ``fsdp`` axes first (:func:`_fsdp_gather`)."""
    if SH.is_placed(x):
        p = _fsdp_gather(p)
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
    y, aux = (MEP.apply_moe_ep if cfg.moe_impl == "ep" else M.apply_moe)(cfg, p, "moe", h)
    if cfg.dense_residual:
        y = y + L.apply_mlp(cfg, p, "mlp", h)
    return x + y, aux


def _cross_attention(p: dict, name: str, x, k, v):
    """Dense cross-attention of x over the encoder's keys / values (short:
    whisper's 1500 frames), the plain ``naive_attention`` on every path (on
    placed tensors, on each rank's rows and heads)."""
    q = L.project_heads(x, p[f"{name}.wq"])
    if SH.is_placed(q):
        o = attn_ops.on_local_heads(attn_ref.naive_attention, q, k, v, causal=False)
    else:
        o = attn_ref.naive_attention(q, k, v, causal=False)
    return SH.shard(L.merge_heads(o, p[f"{name}.wo"]), "batch", "seq", "embed")


def _layer_output(cfg: ModelConfig, kind: str, p: dict, x, memory, *, q_block, kv_block, impl):
    x, _, aux = _apply_layer(cfg, kind, p, x, memory=memory, q_block=q_block, kv_block=kv_block, impl=impl)
    return x, aux


def _embed_inputs(cfg: ModelConfig, params: dict, batch: dict, dev):
    """Token embeddings; a VLM's ``batch["vision_embeds"] (B, Tv, d)`` replace
    them where ``batch["vision_mask"] (B, S)`` is set, the i-th set position of
    a row taking the i-th embedding (the frontend is stubbed, as there)."""
    x = L.embed_tokens(cfg, params, _on(batch["tokens"], dev))
    if cfg.family == "vlm" and "vision_embeds" in batch:
        ve, mask = _on(batch["vision_embeds"], dev), _on(batch["vision_mask"], dev)
        if not SH.is_placed(x):
            return _splice(x, ve, mask)
        # the i-th set position of a row takes the row's i-th embedding: row-local, on each rank's rows
        rows = tuple(SH.keep_shards(x, (0,)).placements)
        x, ve, mask = (t if tuple(t.placements) == rows else t.redistribute(t.device_mesh, rows) for t in (x, ve, mask))
        x = SH.local_call(_splice, (x, ve, mask), rows)
    return x


def _splice(x, ve, mask):
    ve, mask = ve.to(x.dtype), mask.bool()
    idx = torch.clamp(torch.cumsum(mask.int(), dim=1) - 1, 0, ve.shape[1] - 1)
    spliced = torch.gather(ve, 1, idx[..., None].expand(-1, -1, ve.shape[2]))
    return torch.where(mask[..., None], spliced, x)


def _on(x, dev):
    """A batch entry as a tensor on ``dev`` (a placed one as it is)."""
    return x if SH.is_placed(x) else torch.as_tensor(x, device=dev)


def _encode(cfg: ModelConfig, params: dict, frames, dev, *, q_block, kv_block, impl):
    """The encoder over ``frames (B, T, d)``: the learned position table of the
    decoder's embedding added (as the JAX package does), bidirectional
    self-attention layers, ``encoder_norm``."""
    x = _on(frames, dev).to(params["embed.tokens"].dtype)
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
    if SH.is_placed(params["embed.tokens"]) and not SH.is_placed(batch["tokens"]):
        raise ValueError("placed parameters take a placed batch (tokens by ('batch', 'seq'))")
    with _mesh_of(params):
        return _forward_layers(cfg, params, batch, dev, q_block=q_block, kv_block=kv_block, remat=remat, impl=impl)


def _forward_layers(cfg: ModelConfig, params: dict, batch: dict, dev, *, q_block, kv_block, remat, impl):
    kw = dict(q_block=q_block, kv_block=kv_block, impl=impl)
    x = _embed_inputs(cfg, params, batch, dev)
    memory = _encode(cfg, params, batch["frames"], dev, **kw) if cfg.family == "encdec" else None
    kinds = layer_kinds(cfg)
    n_moe = max(1, kinds.count("moe"))
    aux = {name: SH.replicated_like(torch.zeros((), dtype=torch.float32, device=dev), x)
           for name in ("load_balance_loss", "drop_frac")}
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
    if SH.is_placed(logits):
        return _placed_loss(cfg, logits, batch["labels"], aux)
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


def _placed_loss(cfg: ModelConfig, logits, labels, aux):
    """:func:`loss_fn`'s loss on placed logits ``(B, S, V_pad)`` and labels:
    the mean over the global batch's valid labels (plus a MoE model's
    weighted load-balance loss), a ``Replicate()`` scalar (so its gradient
    starts alike on every rank)."""
    from torch.distributed.tensor import Replicate

    valid = labels >= 0
    # the log-sum-exp over the vocab split: each rank's block against the whole row's max (DTensor's
    # logsumexp would gather the whole vocabulary's float32 logits on every rank)
    x = logits.float()
    m = SH.keep_shards(x.detach().amax(dim=-1, keepdim=True), (0,))  # each partial reduced at once
    lse = torch.log(SH.keep_shards(torch.sum(torch.exp(x - m), dim=-1), (0,))) + m[..., 0]
    label_logit = _label_logits(logits, torch.clamp_min(labels, 0).long()).float()
    nll = (lse - label_logit) * valid.float()
    n_valid = torch.clamp_min(valid.sum(), 1)
    whole = [Replicate()] * logits.device_mesh.ndim
    nll = (nll.sum() / n_valid).redistribute(logits.device_mesh, whole)
    aux = {k: v.redistribute(logits.device_mesh, whole) for k, v in aux.items()}
    loss = nll + cfg.router_aux_weight * aux["load_balance_loss"] if cfg.family == "moe" else nll
    return loss, {"loss": loss, "nll": nll, **aux}


def _label_logits(logits, labels):
    """``logits[b, s, labels[b, s]]`` of placed logits split over the vocab:
    each rank looks up the labels that fall in its block of the vocab (zero
    for the others), and the ranks' results are summed (``Partial``).  (A
    ``gather`` of DTensor would all-gather the logits, or make a masked
    partial it cannot reduce.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard

    logits = SH.keep_shards(logits, (0, 2))
    mesh, pl = logits.device_mesh, tuple(logits.placements)
    labels = labels.redistribute(mesh, tuple(p if p == Shard(0) else Replicate() for p in pl))
    index, count = SH.split_index(logits, 2)
    width = logits.shape[2] // count
    lo = index * width

    def local(lg, lb):
        inside = (lb >= lo) & (lb < lo + width)
        got = torch.gather(lg, -1, torch.clamp(lb - lo, 0, width - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    out = tuple(Partial() if p == Shard(2) else p for p in pl)
    return SH.local_call(local, (logits, labels), out)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _attn_cache_len(cfg: ModelConfig, kind: str, max_len: int) -> int:
    if _window(cfg, kind):
        return min(max_len, cfg.window)  # rolling window cache
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *, device=None, mesh=None) -> dict:
    """An empty cache for ``batch`` requests of up to ``max_len`` tokens
    (``dtype``: the model's unless given).  With ``mesh`` (a ``DeviceMesh``)
    every tensor is a DTensor of zeros placed by :func:`cache_axes` under the
    ambient rules, each rank holding its shard only."""
    dtype = dtype or model_dtype(cfg)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if mesh is not None:
        from torch.utils._mode_utils import no_dispatch

        # the whole cache's shapes (no rank's sequence slice), meta tensors made outside any
        # dispatch mode: a dry run's counters see the shards only
        with SH.use_compat_mesh(SH.AbstractMesh()), no_dispatch():
            whole = init_cache(cfg, batch, max_len, dtype, device="meta")
        specs = SH.shard_params(mesh, cache_axes(cfg), abstract_tree=whole)
        return SH.tree_map_with(lambda x, pl: SH.zeros(x.shape, x.dtype, mesh, pl, dev)
                                if isinstance(x, torch.Tensor) else x, whole, specs)
    caches = []
    for kind in layer_kinds(cfg):
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
            caches.append(L.init_attention_cache(cfg, batch, _attn_cache_len(cfg, kind, max_len), dtype, dev,
                                                 window=_window(cfg, kind)))
    return {"layers": caches, "len": 0}


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical-axes tree of :func:`init_cache`'s cache (the JAX package's
    ``cache_axes``)."""
    caches = []
    for kind in layer_kinds(cfg):
        if kind == "mamba":
            caches.append(S.mamba_cache_axes())
        elif kind == "rec":
            caches.append(R.rglru_cache_axes())
        elif kind == "decoder":
            cross = ("batch", None, "kv_heads", "head_dim")
            caches.append({"self": L.attention_cache_axes(), "cross_k": cross, "cross_v": cross})
        else:
            caches.append(L.attention_cache_axes())
    return {"layers": caches, "len": ()}


def _as_cache_axes(cfg: ModelConfig, cache: dict) -> dict:
    """A placed cache's states (the scans' last states, a decoder's cross
    keys / values, a rolled window) redistributed to :func:`cache_axes`'
    placements (``shard`` on each leaf)."""
    return SH.tree_map_with(lambda x, axes: SH.shard(x, *axes) if SH.is_placed(x) else x, cache, cache_axes(cfg))


def prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int, *, q_block: int = 1024,
            kv_block: int = 1024, impl=None, device=None):
    """Run the prompt ``batch["tokens"] (B, S)`` (dense, no padding), fill the
    cache at positions ``[0, S)``, and return ``(last logits (B, 1, V_pad),
    cache)``.  An encoder-decoder encodes ``batch["frames"]`` first and keeps
    each decoder layer's cross-attention keys / values in its cache; a VLM
    splices ``batch["vision_embeds"]`` over ``batch["vision_mask"]``.  A window
    cache shorter than the prompt keeps the last positions, position p at slot
    ``p % window`` (decode's circular indexing).  On placed parameters a plain
    batch is placed by :data:`BATCH_AXES` first, and the cache comes back
    placed by :func:`cache_axes`."""
    check_impl(impl)
    dev = _device(params, device)
    table = params["embed.tokens"]
    rows, seq = batch["tokens"].shape
    with obs.current().span("prefill", rows=rows, ids=rows * seq), _mesh_of(params):
        if SH.is_placed(table):
            batch = place_batch(table.device_mesh, batch)
        return _prefill(cfg, params, batch, max_len, dev, q_block=q_block, kv_block=kv_block, impl=impl)


def _prefill(cfg: ModelConfig, params: dict, batch: dict, max_len: int, dev, *, q_block, kv_block, impl):
    kw = dict(q_block=q_block, kv_block=kv_block, impl=impl)
    dtype = model_dtype(cfg)
    x = _embed_inputs(cfg, params, batch, dev)
    s = x.shape[1]
    mesh = x.device_mesh if SH.is_placed(x) else None
    cache = init_cache(cfg, x.shape[0], max_len, dtype, device=dev, mesh=mesh)
    memory = _encode(cfg, params, batch["frames"], dev, **kw) if cfg.family == "encdec" else None
    new_caches = []
    for kind, p, lc in zip(layer_kinds(cfg), params["layers"], cache["layers"]):
        x, state, _ = _apply_layer(cfg, kind, p, x, memory=memory, **kw)
        if kind in ("mamba", "rec"):
            new_caches.append({"conv": state["conv"].to(dtype), "h": state["h"]})
            continue
        if kind == "decoder":
            k, v, ck, cv = state
            L.fill_attention_cache(lc["self"], k, v)
            new_caches.append({"self": lc["self"], "cross_k": ck.to(dtype), "cross_v": cv.to(dtype)})
            continue
        k, v = state
        clen = lc["k"].shape[1]
        if clen < s and "seq_len" not in lc:  # a rolling window cache; a sequence slice is never circular
            lc["k"], lc["v"] = (_window_tail(t, clen, s, dtype) for t in (k, v))
            lc["len"] = s
        else:
            L.fill_attention_cache(lc, k, v)
        new_caches.append(lc)
    x = L.apply_norm(cfg, params, "final_norm", x[:, -1:])
    cache = {"layers": new_caches, "len": s}
    return L.unembed(cfg, params, x), cache if mesh is None else _as_cache_axes(cfg, cache)


def _window_tail(k, clen: int, s: int, dtype):
    """A window cache of ``clen`` slots from a prompt's keys / values ``(B, S,
    KV, D)``: the last ``clen`` positions, position p at slot ``p % clen``
    (placed: on each rank's rows and heads, the sequence whole)."""
    def tail(t):
        return torch.roll(t[:, -clen:], s % clen, dims=1).to(dtype)

    if not SH.is_placed(k):
        return tail(k)
    k = SH.keep_shards(k, (0, 2))
    return SH.local_call(tail, (k,), tuple(k.placements))


def decode_step(cfg: ModelConfig, params: dict, tokens, cache: dict, *, device=None):
    """One decode step: tokens ``(B, 1)`` -> ``(logits (B, 1, V_pad), new
    cache)``.  The attention caches' k / v are updated in place.  On placed
    parameters the cache is placed (as :func:`prefill` returns it) and plain
    tokens are placed by ``("batch", None)``."""
    dev = _device(params, device)
    table = params["embed.tokens"]
    with obs.current().span("decode.step", pos=cache["len"]), _mesh_of(params):
        if SH.is_placed(table):
            tokens = place_batch(table.device_mesh, {"tokens": tokens})["tokens"]
        return _decode_step(cfg, params, _on(tokens, dev), cache)


def _decode_step(cfg: ModelConfig, params: dict, tokens, cache: dict):
    pos = cache["len"]
    x = L.embed_tokens(cfg, params, tokens, position_offset=pos)
    new_caches = []
    tel = obs.current()
    for kind, p, lc in zip(layer_kinds(cfg), params["layers"], cache["layers"]):
        if SH.is_placed(x):
            p = _fsdp_gather(p)
        if kind == "mamba":
            xn = L.apply_norm(cfg, p, "norm", x)
            with tel.span("decode.mixer"):
                h, nc = S.apply_mamba_decode(cfg, p, "mixer", xn, lc)
            new_caches.append(nc)
            x = x + h
            continue
        xn = L.apply_norm(cfg, p, "norm1", x)
        with tel.span("decode.mixer"):
            if kind == "rec":
                h, nc = R.apply_rglru_decode(cfg, p, "mixer", xn, lc)
            elif kind == "decoder":
                h, sc = L.apply_attention_decode(cfg, p, "self_attn", xn, lc["self"])
                nc = {"self": sc, "cross_k": lc["cross_k"], "cross_v": lc["cross_v"]}
            else:
                h, nc = L.apply_attention_decode(cfg, p, "attn", xn, lc, window=_window(cfg, kind))
        if kind == "decoder":
            x = x + h
            h = _cross_attention(p, "cross_attn", L.apply_norm(cfg, p, "norm_cross", x), lc["cross_k"], lc["cross_v"])
        new_caches.append(nc)
        x = _feed_forward(cfg, kind, p, x + h)[0]
    logits = L.unembed(cfg, params, L.apply_norm(cfg, params, "final_norm", x))
    cache = {"layers": new_caches, "len": pos + 1}
    return logits, _as_cache_axes(cfg, cache) if SH.is_placed(logits) else cache
