"""AdamW with dtype-configurable moments (the port of :mod:`repro.optim.adamw`).

The state is ``{"mu": tree like params, "nu": tree like params, "step": int32
scalar}``, the JAX package's, so it moves between the packages in a
checkpoint.  Every leaf is updated in float32 and cast back to its dtype,
``moment_dtype="bfloat16"`` stores the moments in bf16, and the gradients are
clipped to a global norm.  The arithmetic follows
:func:`repro.optim.adamw.adamw_update` operation for operation; the bias
corrections ``1 - b ** step`` are taken in float32, as JAX's weak types give
them, not as Python float64.  The update runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # float32 | bfloat16


def _map(fn, tree):
    leaves, treedef = tree_lib.flatten(tree)
    return treedef.unflatten([fn(x) for x in leaves])


def adamw_init(params, cfg: AdamWConfig) -> dict:
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    step = torch.zeros((), dtype=torch.int32, device=tree_lib.leaves(params)[0].device)
    return {"mu": _map(zeros, params), "nu": _map(zeros, params), "step": step}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_lib.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)`` with
    metrics ``grad_norm`` and ``lr`` (float32 scalars)."""
    step = state["step"] + 1
    dev = step.device
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        clip = torch.minimum(_f32(1.0, dev), _f32(cfg.grad_clip, dev) / torch.maximum(gnorm, _f32(1e-9, dev)))
    else:
        clip = _f32(1.0, dev)
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, dev), stepf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, dev), stepf)
    lr = torch.as_tensor(cfg.lr * lr_scale, dtype=torch.float32, device=dev)
    # JAX's weak-typed Python constants enter its float32 arithmetic as float32
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    one_b1, one_b2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)

    def upd(p, g, mu, nu):
        # the JAX expression tree, with the in-place operations on temporaries
        # only (each rounds exactly as its out-of-place form); the inputs are
        # left as they are
        g = g.float() * clip
        mu32 = (b1 * mu.float()).add_(one_b1 * g)
        nu32 = (b2 * nu.float()).add_((one_b2 * g).mul_(g))
        del g
        delta = (mu32 / b1c).div_(torch.sqrt(nu32 / b2c).add_(eps)).add_(wd * p.float())
        new_p = p.float() - delta.mul_(lr)  # p.float() is p itself for a float32 p: no in-place here
        return new_p.to(p.dtype), mu32.to(mu.dtype), nu32.to(nu.dtype)

    flat_p, tdef = tree_lib.flatten(params)
    flat_g = tree_lib.leaves(grads)
    flat_mu = tree_lib.leaves(state["mu"])
    flat_nu = tree_lib.leaves(state["nu"])
    out = [upd(p, g, mu, nu) for p, g, mu, nu in zip(flat_p, flat_g, flat_mu, flat_nu)]
    new_params = tdef.unflatten([o[0] for o in out])
    new_state = {
        "mu": tdef.unflatten([o[1] for o in out]),
        "nu": tdef.unflatten([o[2] for o in out]),
        "step": step,
    }
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
