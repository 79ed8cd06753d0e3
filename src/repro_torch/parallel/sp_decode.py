"""Sequence-parallel (SP) decode attention: distributed flash-decoding (the port of :mod:`repro.parallel.sp_decode`).

For decode whose KV cache is sequence-sharded over "model"
(``rules["kv_seq"] == "model"``), each rank of the model axis holds one
contiguous ``S_c / tp`` slice of the cache, computes the online-softmax
partials ``(m, l, o)`` of the query against its slice in float32, and the
ranks merge them: a MAX ``all_reduce`` of ``m``, then one SUM ``all_reduce``
of ``l * alpha`` and ``o * alpha`` (packed into one tensor) with ``alpha =
exp(m_local - m_global)``.  The wire cost a layer is O(B*H*D), not the
cache's O(B*S*KV*D).

Also the cache append: only the rank owning slot ``pos`` writes it.

The JAX package runs this in ``shard_map``; here every tensor is already this
rank's local block (its rows of the batch when the batch is split over
``pod`` / ``data``, its slice of the cache), and the collectives run on the
mesh's ``model`` group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.parallel.sharding import active_abstract_mesh

NEG_INF = -1e30


def sp_available(s_c: int) -> bool:
    mesh = active_abstract_mesh()
    if mesh.empty or "model" not in mesh.axis_names:
        return False
    return s_c % mesh.sizes["model"] == 0


def sp_slice(s_c: int) -> tuple[int, int]:
    """This rank's positions ``[start, stop)`` of a cache of ``s_c`` slots."""
    mesh = active_abstract_mesh()
    s_loc = s_c // mesh.sizes["model"]
    start = mesh.local_rank("model") * s_loc
    return start, start + s_loc


def sp_decode_attention_update(q, k_new, v_new, k_cache, v_cache, pos: int):
    """q ``(b, 1, H, D)``; k_new / v_new ``(b, 1, KV, D)``; caches ``(b, S_c / tp,
    KV, D)``, this rank's slice; ``pos``: the global append slot.

    Writes the new key / value into the cache in place on the owning rank and
    returns ``(out (b, 1, H, D), k_cache, v_cache)``; ``out`` is the same on
    every rank of the model axis."""
    mesh = active_abstract_mesh()
    group = mesh.group("model")
    b, _, h, d = q.shape
    s_loc, n_kv = k_cache.shape[1], k_cache.shape[2]
    g = h // n_kv
    start = mesh.local_rank("model") * s_loc

    # --- append: only the owning rank writes slot pos ----------------------
    local = pos - start
    if 0 <= local < s_loc:
        k_cache[:, local] = k_new[:, 0].to(k_cache.dtype)
        v_cache[:, local] = v_new[:, 0].to(v_cache.dtype)

    # --- local partial attention -------------------------------------------
    qg = q.reshape(b, n_kv, g, d).float()
    s = torch.einsum("bkgd,bckd->bkgc", qg, k_cache.float()) * (1.0 / math.sqrt(d))
    mask = (start + torch.arange(s_loc, device=q.device)) < (pos + 1)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    m_loc = s.amax(dim=-1)  # (b, k, g)
    p = torch.exp(s - m_loc[..., None])
    p = torch.where(mask[None, None, None, :], p, 0.0)
    l_loc = p.sum(dim=-1)
    o_loc = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())

    # --- combine across ranks (flash-decoding merge) -----------------------
    m_glob = m_loc.clone()
    dist.all_reduce(m_glob, op=dist.ReduceOp.MAX, group=group)
    alpha = torch.exp(m_loc - m_glob)
    lo = torch.cat([o_loc * alpha[..., None], (l_loc * alpha)[..., None]], dim=-1)
    dist.all_reduce(lo, op=dist.ReduceOp.SUM, group=group)
    o_glob, l_glob = lo[..., :d], lo[..., d]
    out = (o_glob / torch.clamp_min(l_glob, 1e-37)[..., None]).reshape(b, 1, h, d)
    return out.to(q.dtype), k_cache, v_cache
