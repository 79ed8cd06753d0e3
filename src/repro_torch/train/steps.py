"""Step factories: the train step and greedy sampling (the port of
:mod:`repro.train.steps`).

:func:`make_train_step` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: the gradient of
:func:`repro_torch.models.transformer.loss_fn`, accumulated over microbatches
in an unrolled loop (the mean of their gradients and metrics), then one AdamW
update; the metrics add ``grad_norm`` and ``lr``.  Eager PyTorch: each step
runs the model's ops and kernels as it goes.  Gradients reach every parameter
through the kernels' autograd Functions (forward: the kernel; backward: the
recomputed plain version).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.checkpoint import tree as tree_lib
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


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
                         device=params["embed.tokens"].device)

    def train_step(params, opt_state, batch):
        leaves, treedef = tree_lib.flatten(params)
        grads = metrics = None
        mbs = _split_microbatches(batch, microbatches)
        for mb in mbs:  # unrolled accumulation
            wrt = [x.detach().requires_grad_(True) for x in leaves]
            loss, m = loss_of(treedef.unflatten(wrt), mb)
            g = torch.autograd.grad(loss, wrt, allow_unused=True)
            g = [torch.zeros_like(x) if gx is None else gx for x, gx in zip(wrt, g)]  # JAX: zeros
            m = {k: v.detach() for k, v in m.items()}
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
        params, opt_state, opt_metrics = adamw_update(params, treedef.unflatten(grads), opt_state, opt_cfg, lr_scale)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """``(B, S, V)`` logits -> ``(B, 1)`` int32 argmax of the last position.

    The argmax runs over the padded vocabulary, as in the JAX package; ties go
    to the lowest id.
    """
    return torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
