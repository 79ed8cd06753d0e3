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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamBuilder


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
    experts ``(B, S, k)``, ties to the lower expert."""
    logits = (x @ params[f"{name}.router"]).float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., : cfg.top_k], top_e[..., : cfg.top_k]
    top_w = top_w / torch.clamp_min(top_w.sum(dim=-1, keepdim=True), 1e-9)
    return probs, top_w, top_e


def apply_moe(cfg: ModelConfig, params, name: str, x):
    """x ``(B, S, d)`` -> ``(out, aux)`` with aux ``{"load_balance_loss",
    "drop_frac", "top_e"}`` (float32 scalars; ``top_e (B, S, k)`` the chosen
    experts)."""
    probs, top_w, top_e = route(cfg, params, name, x)
    y, keep = run_experts(cfg, params, name, x, top_w, top_e, 0, cfg.n_experts)
    lb_loss = load_balance_loss(cfg, probs, top_e)
    drop_frac = 1.0 - keep.float().mean()
    return y, {"load_balance_loss": lb_loss, "drop_frac": drop_frac, "top_e": top_e}


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
    bsz, s, d = x.shape
    k = cfg.top_k
    c = moe_capacity(cfg, s)
    tk = s * k
    dev = x.device

    # ---- position-in-expert via a stable sort (row-local) -------------------
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

    # ---- dispatch: row (e * B + b) * C + pos of an expert-major buffer --------
    brow = torch.arange(bsz, device=dev)[:, None]
    slot = (torch.clamp_max(eid, n - 1) * bsz + brow) * c + torch.clamp_max(pos, c - 1)
    spare = n * bsz * c
    buf = torch.zeros((spare + 1, d), dtype=x.dtype, device=dev)
    src = x.repeat_interleave(k, dim=1).reshape(-1, d)  # token t * k + j is token t
    buf[torch.where(keep, slot, spare).reshape(-1)] = src
    buf = buf[:spare].view(n, bsz * c, d)

    # ---- expert FFN (batched over the experts) ------------------------------
    up = torch.bmm(buf, params[f"{name}.wi_up"])
    if cfg.gated_mlp:
        h = silu(torch.bmm(buf, params[f"{name}.wi_gate"])) * up
    else:
        h = F.gelu(up, approximate="tanh")
    out_buf = torch.bmm(h, params[f"{name}.wo"]).view(-1, d)

    # ---- combine: gather, weight, add in ascending expert order ---------------
    back = out_buf[slot.reshape(-1)].view(bsz, s, k, d) * keep.view(bsz, s, k, 1).to(x.dtype)
    back = back * top_w[..., None].to(x.dtype)
    order = torch.argsort(top_e, dim=-1)
    back = torch.gather(back, 2, order[..., None].expand(-1, -1, -1, d))
    y = back[:, :, 0]
    for j in range(1, k):
        y = y + back[:, :, j]
    return y, keep


def load_balance_loss(cfg: ModelConfig, probs, top_e):
    """The GShard load-balance loss: ``E * mean_b sum_e (share of the row's
    assignments to e) * (mean router probability of e)``."""
    bsz, s, k = top_e.shape
    eid = top_e.reshape(bsz, s * k)
    counts = torch.zeros((bsz, cfg.n_experts), dtype=torch.int64, device=eid.device)
    counts.scatter_add_(1, eid, torch.ones_like(eid))
    frac_tokens = counts.float() / (s * k)
    frac_probs = probs.mean(dim=1)
    return cfg.n_experts * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))
