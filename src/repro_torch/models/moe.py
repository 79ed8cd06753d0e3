"""Mixture of experts with sort-based capacity dispatch (the port of :mod:`repro.models.moe`).

Per batch row, as there:

  1. top-k routing over the float32 softmax of the router logits (weights
     normalised over the k);
  2. each assignment's position in its expert by a stable sort of the expert
     ids and the experts' exclusive offsets; an assignment at position
     ``>= capacity`` is dropped (its token falls through on the residual);
  3. the kept tokens are written into an expert-major buffer
     ``(E, B, C, d)``, the expert FFNs run as batched products over the
     experts, and each assignment reads its expert's output back;
  4. a token's output is the sum of its k weighted contributions.

The JAX package's scatters become index writes and gathers whose result does
not depend on the order of the device's threads, so a prefill on the card
gives the same bits every run:

  * ``jax.lax.top_k`` keeps the lower expert on a tie; a stable descending
    sort does the same (``torch.topk`` promises no order);
  * the dispatch writes each kept assignment to its own slot (kept slots are
    distinct) and every dropped one to a spare row past the buffer, which is
    cut off (the JAX package adds the dropped, zeroed rows onto slot
    ``C - 1``: the same values);
  * the combine gathers each token's k contributions and adds them in
    ascending expert order (the order of the JAX package's sorted scatter-add)
    in the activations' dtype, in place of an atomic scatter-add.

No Pallas kernel runs here in the JAX package; the expert products are plain
batched matmuls.  Aux outputs: the GShard load-balance loss and the fraction
of dropped assignments.

``moe_impl="dropless"`` (:func:`apply_moe_dropless`, the ``jamba`` family)
drops nothing: the assignments of the whole batch are sorted stably by
expert, each expert's products run on its own contiguous segment (one
grouped matmul a weight where the installed torch has ``torch._grouped_mm``,
else one matmul an expert), and each token's weighted outputs are gathered
back and added in ascending expert order, as :func:`combine` does.  The
``jamba`` family's router does not renormalise its top-k weights.

While a :class:`repro_torch.obs.Telemetry` collector is active, a layer on
plain tensors counts ``moe.assignments`` and ``moe.dropped`` and sets the
gauge ``moe.load_max_over_mean`` (its busiest expert's assignments over the
mean); without one nothing is read back from the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamBuilder
from repro_torch.parallel.sharding import is_placed, keep_shards, local_call, shard


def silu(x):
    """``x * 1 / (1 + exp(-x))``, each operation rounded to x's dtype: how XLA
    evaluates ``jax.nn.silu`` in bfloat16 on the CPU, bit for bit.  The experts'
    activations are large (their weights' fan-in is the expert count, as in the
    JAX package), so a bf16 ulp of difference here would show in the logits."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def init_moe(b: ParamBuilder, name: str, cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    b.dense(f"{name}.router", (d, e), ("embed", None), scale=0.02)
    if cfg.gated_mlp:
        b.dense(f"{name}.wi_gate", (e, d, f), ("experts", "fsdp", "mlp"))
    b.dense(f"{name}.wi_up", (e, d, f), ("experts", "fsdp", "mlp"))
    b.dense(f"{name}.wo", (e, f, d), ("experts", "mlp", "fsdp"))


def moe_capacity(cfg: ModelConfig, tokens_per_row: int) -> int:
    ideal = tokens_per_row * cfg.top_k / cfg.n_experts
    return max(1, int(ideal * cfg.capacity_factor + 0.5))


def route(cfg: ModelConfig, params, name: str, x):
    """Router probabilities ``(B, S, E)`` (float32) and the top-k weights and
    experts ``(B, S, k)``, ties to the lower expert.  The weights are
    normalised over the k, but in the ``jamba`` family."""
    logits = (x @ params[f"{name}.router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., : cfg.top_k], top_e[..., : cfg.top_k]
    if cfg.family != "jamba":
        top_w = top_w / torch.clamp_min(top_w.sum(dim=-1, keepdim=True), 1e-9)
    return probs, top_w, top_e


def apply_moe(cfg: ModelConfig, params, name: str, x):
    """x ``(B, S, d)`` -> ``(out, aux)`` with aux ``{"load_balance_loss",
    "drop_frac", "top_e"}`` (float32 scalars; ``top_e (B, S, k)`` the chosen
    experts).  On a placed x (:func:`_apply_moe_placed`) the same values,
    placed."""
    if is_placed(x):
        return _apply_moe_placed(cfg, params, name, x)
    probs, top_w, top_e = route(cfg, params, name, x)
    y, keep = run_experts(cfg, params, name, x, top_w, top_e, 0, cfg.n_experts)
    lb_loss = load_balance_loss(cfg, probs, top_e)
    drop_frac = 1.0 - keep.float().mean()
    record(cfg, top_e, keep)
    return y, {"load_balance_loss": lb_loss, "drop_frac": drop_frac, "top_e": top_e}


def apply_moe_dropless(cfg: ModelConfig, params, name: str, x):
    """:func:`apply_moe` without a capacity: every assignment runs through
    its expert's SwiGLU.  x ``(B, S, d)`` -> ``(out, aux)``, aux as
    :func:`apply_moe`'s (``drop_frac`` 0).
    The batch's assignments (assignment j of token t at ``t * k + j``) are
    sorted stably by expert, so an expert's segment keeps the tokens' order;
    the same input gives the same bits every run (no atomic adds)."""
    if is_placed(x):
        raise NotImplementedError("the dropless mixture of experts runs on plain tensors only")
    bsz, s, d = x.shape
    k, e = cfg.top_k, cfg.n_experts
    probs, top_w, top_e = route(cfg, params, name, x)
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    ends = torch.searchsorted(flat_e[order], torch.arange(e, device=x.device), right=True)
    rows = x.reshape(-1, d)[order // k]  # (B * S * k, d), expert by expert
    h = F.silu(grouped_products(rows, params[f"{name}.wi_gate"], ends)) * grouped_products(
        rows, params[f"{name}.wi_up"], ends)
    del rows
    out = grouped_products(h, params[f"{name}.wo"], ends)
    del h
    back = torch.empty_like(out).index_copy_(0, order, out).view(bsz, s, k, d)  # assignment order
    back = back * top_w[..., None].to(out.dtype)
    back = torch.gather(back, 2, torch.argsort(top_e, dim=-1)[..., None].expand(-1, -1, -1, d))
    y = back[:, :, 0]
    for j in range(1, k):
        y = y + back[:, :, j]
    record(cfg, top_e)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return y, {"load_balance_loss": load_balance_loss(cfg, probs, top_e), "drop_frac": zero, "top_e": top_e}


def grouped_products(rows, w, ends):
    """``rows[lo:hi] @ w[e]`` for each expert e's segment ``[ends[e - 1],
    ends[e])`` of ``rows (A, K)`` (sorted by expert), w ``(E, K, N)``: one
    ``torch._grouped_mm`` where the installed torch has it and can take these
    operands (bf16 on the card; rows of K and N a multiple of 16 bytes), else
    one matmul an expert (reading the segments' sizes on the host)."""
    aligned = all(n * rows.element_size() % 16 == 0 for n in (rows.shape[1], w.shape[2]))
    if hasattr(torch, "_grouped_mm") and aligned and (rows.device.type == "cpu" or rows.dtype == torch.bfloat16):
        return torch._grouped_mm(rows, w, offs=ends.to(torch.int32))
    sizes = torch.diff(ends, prepend=ends.new_zeros(1)).tolist()
    return torch.cat([seg @ w[i] for i, seg in enumerate(torch.split(rows, sizes))])


def record(cfg: ModelConfig, top_e, keep=None) -> None:
    """The layer's counters and gauge, only while a collector is active:
    ``moe.assignments`` (tokens times ``top_k``), ``moe.dropped`` (those
    ``keep`` leaves out; none on the dropless path) and
    ``moe.load_max_over_mean``."""
    tel = obs.current()
    if not tel.enabled or is_placed(top_e):
        return
    n = top_e.numel()
    load = torch.bincount(top_e.reshape(-1), minlength=cfg.n_experts)
    tel.count("moe.assignments", n)
    tel.count("moe.dropped", 0 if keep is None else n - int(keep.sum()))
    tel.gauge("moe.load_max_over_mean", float(load.max()) * cfg.n_experts / n)


def run_experts(cfg: ModelConfig, params, name: str, x, top_w, top_e, first: int, n: int):
    """The experts ``first .. first + n - 1`` (the rows the expert weights in
    ``params`` hold) on x ``(B, S, d)`` routed to ``top_e`` with weights
    ``top_w`` ``(B, S, k)``.  Returns ``(y, keep)``: y ``(B, S, d)``, each
    token's weighted outputs of these experts summed in ascending expert order
    (0 for a token none of them takes), and keep ``(B, S * k)``, the
    assignments they kept (assignment j of token t at ``t * k + j``).  An
    assignment to another expert goes to an overflow bucket ``n``, which keeps
    nothing; capacity positions count only these experts' assignments, so a
    kept assignment is the one the whole layer keeps."""
    slot, keep = dispatch_slots(cfg, top_e, first, n)
    buf = dispatch(cfg, x, slot, keep, n)
    out_buf = expert_ffn(cfg, params, name, buf)
    return combine(out_buf, slot, keep, top_w, top_e), keep


def dispatch_slots(cfg: ModelConfig, top_e, first: int, n: int):
    """Each assignment's row ``(e * B + b) * C + pos`` in the expert-major
    buffer of experts ``first .. first + n - 1`` and whether it is kept:
    ``(slot, keep)``, both ``(B, S * k)``.  Row-local: positions count within
    one batch row (a stable sort of the expert ids and the experts' exclusive
    offsets)."""
    bsz, s, k = top_e.shape
    c = moe_capacity(cfg, s)
    tk = s * k
    dev = top_e.device
    eid = top_e.reshape(bsz, tk) - first
    owned = (eid >= 0) & (eid < n)
    eid = torch.where(owned, eid, n)
    sort_idx = torch.argsort(eid, dim=1, stable=True)
    sorted_eid = torch.gather(eid, 1, sort_idx)
    counts = torch.zeros((bsz, n + 1), dtype=torch.int64, device=dev).scatter_add_(1, eid, torch.ones_like(eid))
    offsets = torch.cumsum(counts, dim=1) - counts  # exclusive
    pos_sorted = torch.arange(tk, device=dev)[None, :] - torch.gather(offsets, 1, sorted_eid)
    pos = torch.empty_like(pos_sorted).scatter_(1, sort_idx, pos_sorted)  # back in assignment order
    keep = owned & (pos < c)
    brow = torch.arange(bsz, device=dev)[:, None]
    slot = (torch.clamp_max(eid, n - 1) * bsz + brow) * c + torch.clamp_max(pos, c - 1)
    return slot, keep


def dispatch(cfg: ModelConfig, x, slot, keep, n: int):
    """The kept tokens of x ``(B, S, d)`` written into their rows of the
    expert-major buffer ``(n, B * C, d)`` (each kept slot is written once; the
    dropped ones go to a spare row past the buffer, which is cut off)."""
    bsz, s, d = x.shape
    spare = n * bsz * moe_capacity(cfg, s)
    buf = torch.zeros((spare + 1, d), dtype=x.dtype, device=x.device)
    src = x.repeat_interleave(cfg.top_k, dim=1).reshape(-1, d)  # token t * k + j is token t
    buf[torch.where(keep, slot, spare).reshape(-1)] = src
    return buf[:spare].view(n, -1, d)


def expert_ffn(cfg: ModelConfig, params, name: str, buf):
    """The expert FFNs on the buffer ``(E, rows, d)``, batched over the experts."""
    up = torch.bmm(buf, params[f"{name}.wi_up"])
    if cfg.gated_mlp:
        h = silu(torch.bmm(buf, params[f"{name}.wi_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.bmm(h, params[f"{name}.wo"])


def combine(out_buf, slot, keep, top_w, top_e):
    """Each token's k weighted rows of ``out_buf`` ``(n, B * C, d)``, added in
    ascending expert order in the activations' dtype: y ``(B, S, d)``."""
    bsz, s, k = top_e.shape
    d = out_buf.shape[-1]
    back = out_buf.reshape(-1, d)[slot.reshape(-1)].view(bsz, s, k, d) * keep.view(bsz, s, k, 1).to(out_buf.dtype)
    back = back * top_w[..., None].to(out_buf.dtype)
    order = torch.argsort(top_e, dim=-1)
    back = torch.gather(back, 2, order[..., None].expand(-1, -1, -1, d))
    y = back[:, :, 0]
    for j in range(1, k):
        y = y + back[:, :, j]
    return y


def _apply_moe_placed(cfg: ModelConfig, params, name: str, x):
    """:func:`apply_moe` on x ``(B, S, d)`` placed by ``("batch", "seq",
    "embed")`` and the layer's weights placed by the rules (gathered over
    ``fsdp``).  What is row-local runs on each rank's rows (``local_map``):
    the routing, the slots and the dispatch into the rank's rows of the
    expert-major buffer ``(E, B * C, d)`` (split over the data axes as x's
    rows are).  The expert products run on the buffer placed as the expert
    weights are (``experts`` on ``model``: each rank its experts' slice of its
    rows, no communication), their outputs are gathered over the experts, and
    the combine runs on each rank's rows again.  The aux values are the whole
    batch's."""
    from torch.distributed.tensor import Partial, Shard

    rows = tuple(keep_shards(x, (0,)).placements)
    x = x if tuple(x.placements) == rows else x.redistribute(x.device_mesh, rows)
    router = params[f"{name}.router"]
    mesh = x.device_mesh
    # the router is whole on every rank; each rank's rows give their part of its gradient
    router_grad = tuple(Partial() if p == Shard(0) else r for p, r in zip(rows, router.placements))
    probs, top_w, top_e = local_call(
        lambda xl, rl: route(cfg, {f"{name}.router": rl}, name, xl), (x, router), (rows, rows, rows),
        (rows, router_grad))
    n = cfg.n_experts
    slot, keep = local_call(lambda e: dispatch_slots(cfg, e, 0, n), (top_e,), (rows, rows))
    buf_rows = tuple(Shard(1) if p == Shard(0) else p for p in rows)
    buf = local_call(lambda xl, sl, kl: dispatch(cfg, xl, sl, kl, n), (x, slot, keep), buf_rows)
    # the buffer split over the experts where the weights are, its rows as x's
    w_pl = params[f"{name}.wi_up"].placements
    on_experts = tuple(Shard(0) if w == Shard(0) else b for b, w in zip(buf_rows, w_pl))
    out_buf = expert_ffn(cfg, params, name, buf.redistribute(mesh, on_experts))
    out_buf = out_buf.redistribute(mesh, buf_rows)  # every expert's rows of this rank's tokens
    y = local_call(combine, (out_buf, slot, keep, top_w, top_e), rows)
    lb_loss = load_balance_loss(cfg, probs, top_e)
    drop_frac = 1.0 - keep.float().mean()
    return shard(y, "batch", "seq", "embed"), {"load_balance_loss": lb_loss, "drop_frac": drop_frac, "top_e": top_e}


def load_balance_loss(cfg: ModelConfig, probs, top_e):
    """The GShard load-balance loss: ``E * mean_b sum_e (share of the row's
    assignments to e) * (mean router probability of e)`` (placed: each row's
    counts on its rank, the mean over the whole batch)."""
    bsz, s, k = top_e.shape
    counts = (_expert_counts(cfg, top_e) if not is_placed(top_e) else
              local_call(lambda e: _expert_counts(cfg, e), (top_e,), tuple(top_e.placements)))
    frac_tokens = counts.float() / (s * k)
    frac_probs = probs.mean(dim=1)
    return cfg.n_experts * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))


def _expert_counts(cfg: ModelConfig, top_e):
    """Each row's assignments to each expert ``(B, E)``."""
    bsz, s, k = top_e.shape
    eid = top_e.reshape(bsz, s * k)
    counts = torch.zeros((bsz, cfg.n_experts), dtype=torch.int64, device=eid.device)
    return counts.scatter_add_(1, eid, torch.ones_like(eid))
