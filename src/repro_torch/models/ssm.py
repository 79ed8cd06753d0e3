"""Mamba-1 block (falcon-mamba-7b): causal conv + selective state-space scan.

The port of :mod:`repro.models.ssm`.  The prefill scan goes through the SSM
scan op (the CUDA kernel on the card); the decode step is plain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels.ssm_scan import ops as ssm_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamBuilder
from repro_torch.parallel.sharding import shard


def softplus(x):
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it (``logaddexp(x,
    0)``); ``F.softplus`` returns x itself above 20."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba(b: ParamBuilder, name: str, cfg: ModelConfig):
    d, di, n, r, kc = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank, cfg.ssm_conv
    b.dense(f"{name}.in_proj", (d, 2 * di), ("fsdp", "mlp"))
    b.dense(f"{name}.conv_w", (kc, di), ("conv", "mlp"), scale=0.5)
    b.zeros(f"{name}.conv_b", (di,), ("mlp",))
    b.dense(f"{name}.x_proj", (di, r + 2 * n), ("mlp", None))
    b.dense(f"{name}.dt_proj", (r, di), (None, "mlp"))
    b.zeros(f"{name}.dt_bias", (di,), ("mlp",))
    # A_log: log of 1..N per channel (S4D-real init)
    a = torch.arange(1, n + 1, dtype=torch.float32).repeat(di, 1)
    b.const(f"{name}.A_log", torch.log(a), ("mlp", "state"))
    b.ones(f"{name}.D", (di,), ("mlp",), dtype=torch.float32)
    b.dense(f"{name}.out_proj", (di, d), ("mlp", "fsdp"))


def conv_tail(x, k: int):
    """The last ``k - 1`` positions of x ``(B, S, D)``, left-padded with zeros
    when ``S < k - 1``: the decode conv state after a prefill."""
    b, s, d = x.shape
    if s >= k - 1:
        return x[:, s - (k - 1) :]
    return torch.cat([x.new_zeros((b, k - 1 - s, d)), x], dim=1)


def causal_conv(x, w, bias, state=None):
    """Depthwise causal conv over time.  x ``(B, S, D)``; w ``(K, D)``;
    ``state``: the ``(B, K-1, D)`` left context (decode).  Returns ``(out,
    new state)``.

    The K products are summed left to right in x's dtype, as the JAX
    package's ``sum(...)`` does, so bf16 rounds at the same places.
    """
    k = w.shape[0]
    s = x.shape[1]
    pad = x.new_zeros((x.shape[0], k - 1, x.shape[2])) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S+K-1, D)
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i : i + s] * w[i]
    new_state = xp[:, -(k - 1) :] if k > 1 else None
    return out + bias, new_state


def ssm_inputs(cfg: ModelConfig, params, name: str, x_act):
    """x_act ``(B, S, D)`` -> ``(dtA, dBx, C)`` of the scan: dtA and dBx
    ``(B, S, D, N)`` float32, C ``(B, S, N)`` in x_act's dtype."""
    n, r = cfg.ssm_state, cfg.dt_rank
    # summed over the channels once here, before it is cut into dt_low, B and C (a
    # no-op on plain tensors; on placed ones the split channels leave a partial sum)
    proj = shard(x_act @ params[f"{name}.x_proj"], "batch", "seq", None)
    dt_low, bmat, cmat = proj[..., :r], proj[..., r : r + n], proj[..., r + n :]
    dt = dt_low @ params[f"{name}.dt_proj"] + params[f"{name}.dt_bias"]
    dt = softplus(dt.float())  # (B, S, D)
    a = -torch.exp(params[f"{name}.A_log"].float())  # (D, N)
    dtA = dt[..., None] * a
    dBx = (dt * x_act.float())[..., None] * bmat.float()[:, :, None, :]
    return dtA, dBx, cmat


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device):
    di, n, kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {
        "conv": torch.zeros((batch, kc - 1, di), dtype=dtype, device=device),
        "h": torch.zeros((batch, di, n), dtype=torch.float32, device=device),
    }


def mamba_cache_axes() -> dict:
    return {"conv": ("batch", "conv", "mlp"), "h": ("batch", "mlp", "state")}


def apply_mamba_prefill(cfg: ModelConfig, params, name: str, x, *, impl=None):
    """Full-sequence Mamba mixer of a normed input ``(B, S, d)``.  Returns
    ``(out, cache)`` with the decode cache (conv tail and last state)."""
    # the split output annotated before it is cut, as GSPMD propagates the einsum's split to it: its
    # cotangent comes back split too (a no-op on plain tensors and in the forward)
    xz = shard(x @ params[f"{name}.in_proj"], "batch", "seq", "mlp")
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_in = shard(x_in, "batch", "seq", "mlp")
    x_conv, _ = causal_conv(x_in, params[f"{name}.conv_w"], params[f"{name}.conv_b"])
    x_act = F.silu(x_conv)
    with obs.current().span("prefill.ssm_inputs"):
        dtA, dBx, cmat = ssm_inputs(cfg, params, name, x_act)
    y, h_last = ssm_ops.ssm_scan(dtA, dBx, cmat.contiguous(), impl=impl)
    del dtA, dBx
    y = y + params[f"{name}.D"] * x_act.float()
    y = shard(y.to(x.dtype) * F.silu(z), "batch", "seq", "mlp")
    out = shard(y @ params[f"{name}.out_proj"], "batch", "seq", "embed")
    return out, {"conv": conv_tail(x_in, cfg.ssm_conv), "h": h_last}


def apply_mamba_decode(cfg: ModelConfig, params, name: str, x, cache):
    """One-token step.  x ``(B, 1, d)``; cache ``{"conv": (B, K-1, D), "h":
    (B, D, N)}``.  Returns ``(out, new cache)``."""
    x_in, z = torch.chunk(x @ params[f"{name}.in_proj"], 2, dim=-1)
    x_conv, conv_state = causal_conv(x_in, params[f"{name}.conv_w"], params[f"{name}.conv_b"], cache["conv"])
    x_act = F.silu(x_conv)
    dtA, dBx, cmat = ssm_inputs(cfg, params, name, x_act)
    y, h = ssm_ops.ssm_step(dtA[:, 0], dBx[:, 0], cmat[:, 0], cache["h"])
    y = y + params[f"{name}.D"] * x_act[:, 0].float()
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    out = y @ params[f"{name}.out_proj"]
    return out, {"conv": conv_state.to(cache["conv"].dtype), "h": h}

