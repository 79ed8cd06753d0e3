"""AdamW with dtype-configurable moments (the port of :mod:`repro.optim.adamw`).

The state is ``{"mu": tree like params, "nu": tree like params, "step": int32
scalar}``, the JAX package's, so it moves between the packages in a
checkpoint.  Every leaf is updated in float32 and cast back to its dtype,
``moment_dtype="bfloat16"`` stores the moments in bf16, and the gradients are
clipped to a global norm.  The arithmetic follows
:func:`repro.optim.adamw.adamw_update` operation for operation; the bias
corrections ``1 - b ** step`` are taken in float32, as JAX's weak types give
them, not as Python float64.  The update runs under ``torch.no_grad()``.

On the card the update and the norm are one hand-written kernel each
(:mod:`repro_torch.kernels.adamw`): one launch a leaf reads the parameter, its
gradient and moments once and writes the new three once, bit for bit the
plain update's, and one launch a leaf sums the gradient's squares straight
from its bf16 or float32 storage.  That sum is float32 like the plain
``torch.sum(torch.square(x.float()))``, adds in another order (per-thread
lanes, then a fixed tree; no atomics, the same bits every call) and so may
differ from it in the last bits.  The step's clip, bias corrections and
learning rate stay on the device, and nothing in the update reads a value back
to the host.  Elsewhere (the CPU, a dry run's meta tensors) both are the plain
versions: :mod:`repro_torch.kernels.adamw.ops` picks, once a leaf.  Placed
leaves (DTensors) are updated on their local shards: a parameter, its
gradient and its moments must share
placements, the moments and the new parameters keep them, and the global norm
is one value every rank holds (each rank's local sum, then their sum).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint import tree as tree_lib
from repro_torch.kernels.adamw import ops as adamw_ops
from repro_torch.parallel.sharding import is_placed, replicated_like


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
    zeros = lambda p: torch.zeros_like(p, dtype=dt, memory_format=torch.contiguous_format)  # noqa: E731
    first = tree_lib.leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=(first.to_local() if is_placed(first) else first).device)
    return {"mu": _map(zeros, params), "nu": _map(zeros, params), "step": replicated_like(step, first)}


def opt_state_axes(param_axes) -> dict:
    """The optimizer state's logical-axes tree: each moment inherits its
    parameter's axes, the step counter is a scalar."""
    return {"mu": param_axes, "nu": param_axes, "step": ()}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares (a
    placed leaf's whole sum, a plain tensor)."""
    return torch.sqrt(torch.sum(torch.stack([_sum_of_squares(x) for x in tree_lib.leaves(tree)])))


def _sum_of_squares(x) -> torch.Tensor:
    """A leaf's float32 sum of squares; a placed leaf's is its local shard's
    summed over the mesh axes it is split on (a plain tensor)."""
    if not is_placed(x):
        return adamw_ops.sum_of_squares(x)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if any(p.is_partial() for p in x.placements):
        raise ValueError(f"a gradient placed {x.placements}: its squares cannot be summed shard by shard")
    local = adamw_ops.sum_of_squares(x.to_local())
    placements = [Partial() if p.is_shard() else Replicate() for p in x.placements]
    return DTensor.from_local(local, x.device_mesh, placements, run_check=False).full_tensor()


def _f32(x, device) -> torch.Tensor:
    """``x`` as a float32 scalar tensor on ``device``; a Python number is
    filled in there (no copy from the host, so no wait for the device)."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    return torch.full((), x, dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)`` with
    metrics ``grad_norm`` and ``lr`` (float32 scalars)."""
    step = state["step"] + 1
    step_local = step.to_local() if is_placed(step) else step
    dev = step_local.device
    gnorm = global_norm(grads)
    if cfg.grad_clip:
        clip = torch.minimum(_f32(1.0, dev), _f32(cfg.grad_clip, dev) / torch.maximum(gnorm, _f32(1e-9, dev)))
    else:
        clip = _f32(1.0, dev)
    stepf = step_local.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, dev), stepf)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, dev), stepf)
    lr = _f32(cfg.lr * lr_scale, dev)
    step_scalars = torch.stack([clip, b1c, b2c, lr])
    # JAX's weak-typed Python constants enter its float32 arithmetic as float32
    consts = (cfg.b1, cfg.b2, 1 - cfg.b1, 1 - cfg.b2, cfg.eps, cfg.weight_decay)

    def upd(p, g, mu, nu):
        # a placed leaf on its local shards (the four share placements)
        placed = is_placed(p)
        if placed and not tuple(p.placements) == tuple(g.placements) == tuple(mu.placements) == tuple(
                nu.placements):
            raise ValueError(f"placements differ: parameter {p.placements}, gradient {g.placements}, "
                             f"moments {mu.placements} / {nu.placements}")
        outs = adamw_ops.update(*(x.to_local() if placed else x for x in (p, g, mu, nu)), step_scalars, consts)
        if placed:
            from torch.distributed.tensor import DTensor

            outs = [DTensor.from_local(o, p.device_mesh, p.placements, run_check=False, shape=p.shape,
                                       stride=p.stride()) for o in outs]
        return tuple(outs)

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
