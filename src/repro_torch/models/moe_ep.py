"""Expert-parallel MoE over the mesh's model axis (the port of :mod:`repro.models.moe_ep`).

The same math as :func:`repro_torch.models.moe.apply_moe`, with explicit
locality:

  * activations are replicated along "model" (the batch is split over the
    data axes, d is whole), so every rank of the model axis computes the
    routing itself (:func:`repro_torch.models.moe.route`, the stable-sort
    top-k) — no communication;
  * rank r of the model axis runs only its ``E / tp`` local experts, rows
    ``r * E / tp .. (r + 1) * E / tp`` of the layer (an assignment to another
    rank's expert goes to the overflow bucket ``E / tp``), and adds their
    weighted outputs into a local ``(B, S, d)`` buffer;
  * one SUM over "model" combines the experts' outputs — the wire cost of a
    dense TP FFN's all-reduce, O(B*S*d) a layer, not O(B*E*C*d).

The JAX package runs this in ``shard_map``; here each rank calls it on its
own rows of the batch, and the sums run on the mesh's groups.  Gradients
follow ``shard_map``'s transposes: the output's sum over "model"
(:func:`repro_torch.parallel.sharding.psum`) passes each rank's cotangent to
its own experts, and x and the routing weights enter the local experts
through :func:`repro_torch.parallel.sharding.pvary`, whose backward sums the
experts' parts over "model" — so every rank of the model axis ends with the
whole gradient of x and of the router, the routing and the load-balance loss
counted once.  The aux values are the load-balance loss and the dropped
fraction of the whole batch, means over the data axes
(:func:`repro_torch.parallel.sharding.pmean_replicas`): averaging the
gradients over the data axes (as data parallelism does) gives the gradient
of the whole batch's mean loss.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import apply_moe, load_balance_loss, route, run_experts
from repro_torch.parallel import sharding

EXPERT_WEIGHTS = ("wi_gate", "wi_up", "wo")


def _mesh_for_ep():
    mesh = sharding.active_abstract_mesh()
    if mesh.empty or "model" not in mesh.axis_names:
        return None
    return mesh


def local_experts(params: dict, name: str, rank: int, tp: int) -> dict:
    """``params`` with the expert weights of MoE block ``name`` cut to rank
    ``rank``'s ``E / tp`` rows (views of the whole layer's, as ``init_params``
    or ``from_jax`` make them); every other entry as it is."""
    out = dict(params)
    for w in EXPERT_WEIGHTS:
        key = f"{name}.{w}"
        if key in params:
            e = params[key].shape[0]
            if e % tp:
                raise ValueError(f"{key}: {e} experts over {tp} ranks")
            out[key] = params[key][rank * (e // tp):(rank + 1) * (e // tp)]
    return out


def apply_moe_ep(cfg: ModelConfig, params, name: str, x):
    """Drop-in for :func:`repro_torch.models.moe.apply_moe` on this rank's
    rows x ``(b, S, d)``: ``(y, {"load_balance_loss", "drop_frac"})``, y the
    same on every rank of the model axis.  ``params`` hold the layer's
    experts whole, as ``init_params`` or ``from_jax`` make them; each rank
    runs its rows (:func:`local_experts`).  Off a mesh with a model axis, or
    when that axis does not divide the expert count, it is ``apply_moe``, as
    in the JAX package."""
    mesh = _mesh_for_ep()
    tp = 0 if mesh is None else mesh.sizes["model"]
    if mesh is None or cfg.n_experts % tp:
        return apply_moe(cfg, params, name, x)
    e_loc = cfg.n_experts // tp
    rank = mesh.local_rank("model")
    params = local_experts(params, name, rank, tp)
    bsz, s, _ = x.shape

    probs, top_w, top_e = route(cfg, params, name, x)  # the same on every model rank
    shared_x, shared_w = (sharding.pvary(t, mesh, "model") for t in (x, top_w))
    y, keep = run_experts(cfg, params, name, shared_x, shared_w, top_e, rank * e_loc, e_loc)
    y = sharding.psum(y, mesh, "model")

    # aux: replicated along model; the mean over the data axes (ranks that hold
    # the same rows give the same values, so this is the JAX package's mean over
    # the axes the batch is split on)
    lb = load_balance_loss(cfg, probs, top_e)
    kept_n = sharding.psum(keep.float().sum(), mesh, "model")
    drop = 1.0 - kept_n / (bsz * s * cfg.top_k)
    data = tuple(a for a in ("pod", "data") if a in mesh.sizes)
    if data:
        lb, drop = (sharding.pmean_replicas(t, mesh, data) for t in (lb, drop))
    return y, {"load_balance_loss": lb, "drop_frac": drop}
