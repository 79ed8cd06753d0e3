"""The reference's training steps: the loss of :mod:`bench.reference.model`,
its gradients by autograd, and AdamW, all in float32, from the same initial
parameters and batches as the program's first steps.

:func:`follow` returns what a step of the program is compared by: each step's
loss, each leaf's norm of the first gradient as the optimizer takes it
(clipped to the global norm), and each leaf's norm of its change over the
steps.  ``half_batch`` keeps only the first half of every batch's rows, the
mean taken over them (a fault that the comparison has to catch).
"""

from __future__ import annotations

import torch

from bench.reference import model
from bench.reference.common import adamw_step, exact_float32


def named_leaves(params: dict) -> list[tuple[str, torch.Tensor]]:
    """``(name, tensor)`` of every parameter: the top-level ones by name, then
    ``layers.<i>.<name>`` in layer order."""
    out = [(k, v) for k, v in sorted(params.items()) if k != "layers"]
    for i, layer in enumerate(params.get("layers", [])):
        out += [(f"layers.{i}.{k}", v) for k, v in sorted(layer.items())]
    return out


def _rebuild(params: dict, values: dict) -> dict:
    out = {k: values[k] for k in params if k != "layers"}
    out["layers"] = [{k: values[f"layers.{i}.{k}"] for k in layer} for i, layer in enumerate(params["layers"])]
    return out


def follow(m: dict, params: dict, batches: list[dict], opt: dict, eps: float, *, precision: str = "fp32",
           half_batch: bool = False) -> dict:
    """Runs ``len(batches)`` steps from ``params`` (left as they are) and returns
    ``{"losses": [...], "grad_norms": {leaf: float}, "change_norms": {leaf: float}}``."""
    names = [n for n, _ in named_leaves(params)]
    start = {n: v.detach() for n, v in named_leaves(params)}
    cur = {n: v.detach().float().clone().requires_grad_(True) for n, v in start.items()}
    mu = {n: torch.zeros_like(v, dtype=torch.float32) for n, v in cur.items()}
    nu = {n: torch.zeros_like(v, dtype=torch.float32) for n, v in cur.items()}
    losses, grad_norms = [], {}
    with exact_float32():
        for i, batch in enumerate(batches, start=1):
            tokens, labels = batch["tokens"], batch["labels"]
            if half_batch:
                rows = tokens.shape[0] // 2
                tokens, labels = tokens[:rows], labels[:rows]
            value = model.loss(m, _rebuild(params, cur), tokens, labels, eps, precision)
            grads = torch.autograd.grad(value, [cur[n] for n in names])
            losses.append(float(value.detach()))
            del value
            with torch.no_grad():
                clip = adamw_step([cur[n] for n in names], list(grads), [mu[n] for n in names],
                                  [nu[n] for n in names], i, opt)
                for n in names:  # the parameters are kept in their own dtype, as the configuration states
                    cur[n].copy_(cur[n].to(start[n].dtype).float())
                if i == 1:
                    grad_norms = {n: float(torch.linalg.vector_norm(g.float())) * clip for n, g in zip(names, grads)}
            del grads
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(cur[n] - start[n].float())) for n in names}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
