"""Rank functions of the port's placed serving tests (``tests/test_torch_placed_serving.py``),
run by ``repro_torch.parallel.ranks.run_ranks``.

A module of its own that defines no tests and imports neither JAX nor the JAX
package: every spawned rank imports it.  Bulk inputs (the JAX package's
parameters as numpy, prompts, the tokens to decode) reach the ranks through a
file.
"""

import torch
from torch.distributed.tensor import Shard

import test_torch_mesh_ranks as mesh_ranks
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax
from repro_torch.parallel import sharding as S


def joint_slots(cfg, top_e, first, n):
    """The mutation: ``dispatch_slots`` with the capacity positions counted
    over all of a rank's rows at once (a dispatch that is not row-local)."""
    bsz, s, k = top_e.shape
    slot, keep = ROW_LOCAL_SLOTS(cfg, top_e.reshape(1, bsz * s, k), first, n)
    c = M.moe_capacity(cfg, s)
    pos = slot % M.moe_capacity(cfg, bsz * s)
    eid = torch.clamp(top_e.reshape(bsz, s * k) - first, 0, n - 1)
    brow = torch.arange(bsz)[:, None]
    keep = keep.reshape(bsz, s * k) & (pos.reshape(bsz, s * k) < c)
    slot = (eid * bsz + brow) * c + torch.clamp_max(pos.reshape(bsz, s * k), c - 1)
    return slot, keep


ROW_LOCAL_SLOTS = M.dispatch_slots


def placement_pairs(cfg, cache, mesh) -> list:
    """``(placements, the placements shard_params gives by cache_axes)`` of
    every tensor leaf of a placed cache (``None`` for a plain leaf)."""
    specs = S.shard_params(mesh, T.cache_axes(cfg), S.current_rules(), abstract_tree=cache)
    out = []
    S.tree_map_with(lambda x, pl: out.append((tuple(x.placements) if S.is_placed(x) else None, tuple(pl)))
                    if isinstance(x, torch.Tensor) else None, cache, specs)
    return out


def views_against_copies(params, specs, mesh) -> dict:
    """``place(..., copy=False)`` beside ``place``: whether every leaf's shape,
    placements and local shard are the same, how many local shards share the
    whole leaf's storage, and how many are contiguous in the whole leaf."""
    views, copies = S.place(params, mesh, specs, copy=False), S.place(params, mesh, specs)
    out = {"same": True, "shared": 0, "contiguous": 0, "leaves": 0}
    for x, v, c in zip(tree_lib.leaves(params), tree_lib.leaves(views), tree_lib.leaves(copies), strict=True):
        local = v.to_local()
        out["same"] &= (v.shape == c.shape and tuple(v.placements) == tuple(c.placements)
                        and torch.equal(local, c.to_local()))
        out["shared"] += local.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
        out["contiguous"] += x[tuple(slice(o, o + n) for o, n in zip(S.local_offset(v), local.shape))].is_contiguous()
        out["leaves"] += 1
    return out


def serve(cfg, placed, batch, tokens, max_len, block):
    """Placed prefill, then a decode step for each of ``tokens`` (the
    reference's greedy tokens): every step's logits gathered whole, and the
    cache's placements after the prefill and after the last step beside those
    of its ``cache_axes``."""
    mesh = placed["embed.tokens"].device_mesh
    logits, cache = T.prefill(cfg, placed, batch, max_len, q_block=block, kv_block=block, device="cpu")
    out = {"logits": [logits.full_tensor()], "cache_placements": [placement_pairs(cfg, cache, mesh)]}
    for tok in tokens:
        logits, cache = T.decode_step(cfg, placed, torch.as_tensor(tok), cache, device="cpu")
        out["logits"].append(logits.full_tensor())
    out["cache_placements"].append(placement_pairs(cfg, cache, mesh))
    out["cache_len"] = cache["len"]
    first = cache["layers"][0]
    k = first.get("self", first).get("k")
    out["split_slots"] = k is not None and any(p == Shard(1) for p in k.placements)  # the SP layout
    out["whole_cache"] = {n: (S.gather(v) if S.is_placed(v) else v) for n, v in first.get("self", first).items()}
    return out


def serve_rank(rank, path, mesh_shape):
    """Each serving case of the file (``{"cfg", "params", "batch", "tokens",
    "max_len", "block", "rules", "mutant"}``) on the mesh, and each gradient
    case (``grads``: :func:`test_torch_mesh_ranks.placed_grads`)."""
    mesh = mesh_ranks.cpu_mesh(mesh_shape)
    cases = mesh_ranks.load(path)
    out = {"serve": {}, "grads": {}, "views": {}}
    for name, case in cases["serve"].items():
        cfg = case["cfg"]
        params = from_jax(cfg, case["params"], "cpu")
        batch = {k: torch.as_tensor(v) for k, v in case["batch"].items()}
        if case.get("mutant"):
            M.dispatch_slots = joint_slots
        try:
            with S.use_compat_mesh(mesh), S.axis_rules({**S.DEFAULT_RULES, **case["rules"]}):
                specs = S.shard_params(mesh, T.param_axes(cfg), abstract_tree=params)
                out["views"][name] = views_against_copies(params, specs, mesh)
                placed = S.place(params, mesh, specs, copy=False)  # serving reads its parameters only
                out["serve"][name] = serve(cfg, placed, batch, case["tokens"], case["max_len"], case["block"])
        finally:
            M.dispatch_slots = ROW_LOCAL_SLOTS
    for name, case in cases["grads"].items():
        out["grads"][name] = mesh_ranks.placed_grads(mesh, case)
    return out
