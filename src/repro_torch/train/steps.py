"""Step factories: the train step, prefill, decode and greedy sampling (the
port of :mod:`repro.train.steps`).

:func:`make_train_step` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the gradient of
:func:`repro_torch.models.transformer.loss_fn`, accumulated over microbatches
in an unrolled loop (the mean of their gradients and metrics), then one AdamW
update; the metrics add ``grad_norm`` and ``lr``.  Eager PyTorch: each step
runs the model's ops and kernels as it goes.  Gradients reach every parameter
through the kernels' autograd Functions (forward: the kernel; backward: the
recomputed plain version).  A step is the span ``train.step`` (its
``tokens``), holding ``train.forward`` and ``train.backward`` for each
microbatch, then ``train.adamw`` (:mod:`repro_torch.obs`).

On placed parameters (DTensors on a mesh; a plain batch, the same on every
rank, is placed by ``("batch", "seq")``) the step is the JAX package's step under a mesh: each
gradient is redistributed to its parameter's placements (where the parameter
is whole on a data axis, its gradient comes back as each rank's part of the
sum: this is the data-parallel all-reduce), and AdamW runs on the ranks'
shards; the new state keeps the placements, and the metrics are plain
tensors, alike on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.parallel import sharding as S


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0


def make_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, seed: int = 0, *, device=None) -> TrainState:
    """Random parameters (:func:`~repro_torch.models.transformer.init_params`
    with ``seed``) and a fresh AdamW state, on ``device`` (the card unless
    given ``"cpu"``)."""
    params = T.init_params(cfg, seed, device=device)
    return TrainState(params=params, opt_state=adamw_init(params, opt_cfg), step=0)


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    if n <= 1:
        return [batch]
    return [{k: v.reshape(n, -1, *v.shape[1:])[i] for k, v in batch.items()} for i in range(n)]


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    schedule: Callable | None = None,
    *,
    microbatches: int = 1,
    remat: bool = True,
    q_block: int = 1024,
    kv_block: int = 1024,
    impl=None,
):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, which runs on the device its parameters lie on (made there by
    :func:`make_train_state`); ``impl="plain"`` runs the plain versions of
    the kernels."""

    def loss_of(params, mb):
        return T.loss_fn(cfg, params, mb, q_block=q_block, kv_block=kv_block, remat=remat, impl=impl,
                         device=_local_device(params))

    def train_step(params, opt_state, batch):
        with obs.current().span("train.step", tokens=math.prod(batch["tokens"].shape)):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        tel = obs.current()
        table = params["embed.tokens"]
        if S.is_placed(table) and not S.is_placed(batch["tokens"]):  # the same whole batch on every rank
            batch = T.place_batch(table.device_mesh, batch)
        leaves, treedef = tree_lib.flatten(params)
        grads = metrics = None
        mbs = _split_microbatches(batch, microbatches)
        for mb in mbs:  # unrolled accumulation
            wrt = [x.detach().requires_grad_(True) for x in leaves]
            with tel.span("train.forward"):
                loss, m = loss_of(treedef.unflatten(wrt), mb)
            with tel.span("train.backward"):
                g = torch.autograd.grad(loss, wrt, allow_unused=True)
            g = [torch.zeros_like(x) if gx is None else gx for x, gx in zip(wrt, g)]  # JAX: zeros
            g = [as_placed_like(gx, x) for x, gx in zip(wrt, g)]
            m = {k: _whole(v.detach()) for k, v in m.items()}
            if grads is None:
                grads, metrics = list(g), m
            else:
                grads = [a + b for a, b in zip(grads, g)]
                metrics = {k: metrics[k] + m[k] for k in metrics}
            del wrt, loss, g
        if len(mbs) > 1:
            inv = 1.0 / len(mbs)
            grads = [x * inv for x in grads]
            metrics = {k: v * inv for k, v in metrics.items()}
        lr_scale = schedule(opt_state["step"]) if schedule is not None else 1.0
        with tel.span("train.adamw"):
            params, opt_state, opt_metrics = adamw_update(params, treedef.unflatten(grads), opt_state, opt_cfg,
                                                          lr_scale)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def state_shardings(mesh, cfg: ModelConfig, params, opt_state) -> tuple:
    """The DTensor placements of a training state ``(params, opt_state)`` on
    ``mesh`` by the ambient rules: :func:`~repro_torch.parallel.shard_params`
    over the model's ``param_axes`` and the optimizer's ``opt_state_axes``
    (the JAX package's elastic example's ``sh``); ``params`` and
    ``opt_state`` (meta tensors will do) give the shapes."""
    from repro_torch.optim.adamw import opt_state_axes

    axes = T.param_axes(cfg)
    return (S.shard_params(mesh, axes, abstract_tree=params),
            S.shard_params(mesh, opt_state_axes(axes), abstract_tree=opt_state))


def place_cache(mesh, cfg: ModelConfig, cache: dict, rules=None) -> dict:
    """A whole cache (:func:`~repro_torch.models.transformer.init_cache` made
    off a mesh, the same on every rank) placed on ``mesh`` by the model's
    ``cache_axes`` under ``rules`` (the ambient rules unless given): what
    :func:`make_decode_step`'s step takes on placed parameters."""
    rules = rules or S.current_rules()
    return S.place(cache, mesh, S.shard_params(mesh, T.cache_axes(cfg), rules, abstract_tree=cache))


def as_placed_like(g, x):
    """The gradient ``g`` of a placed parameter ``x`` redistributed to ``x``'s
    placements (a ``Partial`` sum over the ranks of a data axis is
    all-reduced, a split one reduce-scattered); ``g`` itself off a mesh."""
    if not S.is_placed(x):
        return g
    g = g.redistribute(x.device_mesh, x.placements)
    if tuple(g.placements) != tuple(x.placements):
        raise AssertionError(f"a gradient placed {g.placements} for a parameter placed {x.placements}")
    return g


def _whole(v):
    """A metric as a plain tensor: a placed one's whole value."""
    return v.full_tensor() if S.is_placed(v) else v


def make_prefill(cfg: ModelConfig, max_len: int, *, q_block: int = 1024, kv_block: int = 1024, impl=None):
    """Returns ``prefill(params, batch) -> (last logits, cache)``
    (:func:`repro_torch.models.transformer.prefill` with a cache of
    ``max_len`` slots), on the device its parameters lie on; on placed
    parameters the cache comes back placed by the model's ``cache_axes``."""

    def prefill(params, batch):
        return T.prefill(cfg, params, batch, max_len, q_block=q_block, kv_block=kv_block, impl=impl,
                         device=_local_device(params))

    return prefill


def make_decode_step(cfg: ModelConfig):
    """Returns ``decode_step(params, tokens, cache) -> (logits, cache)``
    (:func:`repro_torch.models.transformer.decode_step`), on the device its
    parameters lie on; on placed parameters the cache is placed
    (:func:`place_cache`, or the prefill's)."""

    def decode_step(params, tokens, cache):
        return T.decode_step(cfg, params, tokens, cache, device=_local_device(params))

    return decode_step


def _local_device(params) -> torch.device:
    """The device of the parameters' storage (a placed table's local shard's)."""
    table = params["embed.tokens"]
    return (table.to_local() if S.is_placed(table) else table).device


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """``(B, S, V)`` logits -> ``(B, 1)`` int32 argmax of the last position.

    The argmax runs over the padded vocabulary, as in the JAX package; ties go
    to the lowest id.  Placed logits are gathered whole first (every rank
    gets the same tokens).
    """
    if S.is_placed(logits):
        logits = logits[:, -1:].full_tensor()
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
