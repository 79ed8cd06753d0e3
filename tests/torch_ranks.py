"""Rank functions of the port's multi-rank tests (``tests/test_torch_sp_decode.py``,
``tests/test_torch_moe_ep.py``), run by ``repro_torch.parallel.ranks.run_ranks``.

They live in a module of their own, which imports neither JAX nor the JAX
package: each spawned rank imports the module that holds its function, and
these are cheap to import.  The test files put ``tests/`` on ``sys.path``
(pytest does, for test files without a package), which the ranks inherit.
"""

import math

import torch
import torch.distributed as dist

from repro_torch.models import moe_ep as MEP
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax
from repro_torch.parallel import sharding as S

SP_RULES = {**S.DEFAULT_RULES, "kv_seq": "model"}
DATA_AXES = ("pod", "data")


def data_axes(mesh, batch: int) -> tuple[str, ...]:
    """The data axes (``pod``, ``data``, in that order, those the mesh has) a
    batch of ``batch`` rows is split over: the longest prefix whose product
    divides ``batch`` (the JAX package's ``bspec`` of the explicit paths)."""
    kept, prod = [], 1
    for a in DATA_AXES:
        if a in mesh.sizes and batch % (prod * mesh.sizes[a]) == 0:
            kept.append(a)
            prod *= mesh.sizes[a]
    return tuple(kept)


def batch_slice(mesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch`` rows on ``mesh`` (split
    over :func:`data_axes`, the first axis outermost)."""
    axes = data_axes(mesh, batch)
    n = math.prod(mesh.sizes[a] for a in axes)
    block = 0
    for a in axes:
        block = block * mesh.sizes[a] + mesh.local_rank(a)
    rows = batch // n
    return slice(block * rows, (block + 1) * rows)


def sum_over_data(mesh, g):
    """``g`` summed over the mesh's data axes (the ranks' parts of one gradient)."""
    g = g.clone()
    for a in DATA_AXES:
        if a in mesh.sizes:
            dist.all_reduce(g, group=mesh.group(a))
    return g


def flat(tree, prefix=""):
    """``{"layers/0/attn.wq": tensor, ...}`` of a parameter tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        key = f"{prefix}{k}"
        out.update(flat(v, key + "/") if isinstance(v, (dict, list)) else {key: v})
    return out


def load(path):
    """What a test wrote with ``torch.save`` (numpy trees, configs)."""
    return torch.load(path, weights_only=False)


def sp_decode_rank(rank, path, mesh_shape, mesh_axes, max_len, block):
    """Prefill the first token, then decode the rest one token at a time under
    the mesh with ``kv_seq`` on ``model``: this rank's rows of every step's
    logits, its cache (a sequence slice of each attention cache that is not
    circular) and where its rows and slices lie.  ``path``: ``{"cfg",
    "params" (the JAX package's, numpy), "batch" (numpy: tokens, an enc-dec's
    frames)}``."""
    inputs = load(path)
    cfg, batch = inputs["cfg"], inputs["batch"]
    params = from_jax(cfg, inputs["params"], "cpu")
    mesh = S.make_compat_mesh(mesh_shape, mesh_axes, device_type="cpu")
    with S.use_compat_mesh(mesh), S.axis_rules(SP_RULES):
        am = S.active_abstract_mesh()
        rows = batch_slice(am, batch["tokens"].shape[0])
        local = {k: torch.from_numpy(v[rows]) for k, v in batch.items()}
        tok = local["tokens"]
        _, cache = T.prefill(cfg, params, {**local, "tokens": tok[:, :1]}, max_len, q_block=block,
                             kv_block=block, device="cpu")
        logits = []
        for i in range(1, tok.shape[1]):
            step, cache = T.decode_step(cfg, params, tok[:, i:i + 1], cache, device="cpu")
            logits.append(step)
        return {"rows": (rows.start, rows.stop), "model_rank": am.local_rank("model"),
                "logits": torch.cat(logits, dim=1), "cache": cache["layers"]}


def moe_ep_rank(rank, path, mesh_shape, mesh_axes):
    """``apply_moe_ep`` on this rank's rows of x under the mesh, with the JAX
    test's loss ``sum(y ** 2) + load_balance_loss`` split over the data ranks
    (each takes its rows' squares and 1/n of the shared load-balance loss): the
    gradients of the whole layer's weights summed over the data axes, and of
    this rank's rows of x.  Then the whole model with ``moe_impl="ep"`` on this
    rank's rows: its logits, and the gradients of ``loss_fn`` averaged over
    the data axes (as data parallelism averages them).  ``path``: ``{"cfg",
    "params" (one MoE block's, numpy), "x", "model_cfg", "model_params",
    "tokens", "labels"}``."""
    inputs = load(path)
    cfg, params_np, x = inputs["cfg"], inputs["params"], inputs["x"]
    mesh = S.make_compat_mesh(mesh_shape, mesh_axes, device_type="cpu")
    with S.use_compat_mesh(mesh):
        am = S.active_abstract_mesh()
        rows = batch_slice(am, x.shape[0])
        n_data = math.prod(am.sizes[a] for a in DATA_AXES if a in am.sizes)
        tp, r = am.sizes["model"], am.local_rank("model")
        params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params_np.items()}
        x_rows = torch.from_numpy(x[rows]).requires_grad_(True)
        y, aux = MEP.apply_moe_ep(cfg, params, "moe", x_rows)
        loss = torch.sum(y.float() ** 2) + aux["load_balance_loss"] / n_data
        loss.backward()
        grads = {k: sum_over_data(am, v.grad) for k, v in params.items()}
        e_loc = cfg.n_experts // tp
        # the whole model with moe_impl="ep": every MoE layer through apply_moe_ep
        model_cfg, model_params = inputs["model_cfg"], inputs["model_params"]
        batch = {"tokens": torch.from_numpy(inputs["tokens"][rows]), "labels": torch.from_numpy(inputs["labels"][rows])}
        with torch.no_grad():
            model_logits, model_aux = T._forward(model_cfg, model_params, batch, device="cpu")
        leaves = flat(model_params)
        for v in leaves.values():
            v.requires_grad_(True)
        model_loss, _ = T.loss_fn(model_cfg, model_params, batch, device="cpu")
        model_loss.backward()
        model_grads = {k: sum_over_data(am, v.grad) / n_data for k, v in leaves.items()}
        return {
            "model_logits": model_logits, "model_aux": model_aux, "model_grads": model_grads,
            "model_loss": model_loss.detach(),
            "rows": (rows.start, rows.stop), "experts": (r * e_loc, (r + 1) * e_loc),
            "y": y.detach(), "load_balance_loss": aux["load_balance_loss"].detach(),
            "drop_frac": aux["drop_frac"].detach(), "grads": grads, "dx": x_rows.grad,
        }


def collectives_rank(rank):
    """Each of :mod:`repro_torch.parallel.sharding`'s collectives over a
    one-axis mesh of the group, on x = rank + 1 with cotangent rank + 1:
    ``(value, gradient)`` of each."""
    mesh = S.make_compat_mesh((dist.get_world_size(),), ("model",), device_type="cpu")
    with S.use_compat_mesh(mesh):
        am = S.active_abstract_mesh()
        out = {}
        for name in ("psum", "pvary", "pmean_replicas"):
            x = torch.tensor(rank + 1.0, requires_grad=True)
            y = getattr(S, name)(x, am, "model")
            (y * (rank + 1.0)).backward()
            out[name] = (float(y), float(x.grad))
        total = S.psum(torch.tensor([1.5 if rank == 0 else 2.25], dtype=torch.bfloat16), am, "model")
        out["psum_bf16"] = (total.dtype, float(total[0]))
        return out
