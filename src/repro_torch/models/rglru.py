"""RecurrentGemma recurrent block: causal conv + RG-LRU gated linear recurrence.

The port of :mod:`repro.models.rglru` (Griffin's layout: linear x / gate
branches, a short causal conv on the x branch, the RG-LRU recurrence, a gated
output projection).  The prefill scan goes through the RG-LRU scan op (the
CUDA kernel on the card); the decode step is plain.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.kernels.rglru_scan.ref import RG_LRU_C
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamBuilder
from repro_torch.models.ssm import causal_conv, conv_tail, softplus
from repro_torch.parallel.sharding import shard


def init_rglru_block(b: ParamBuilder, name: str, cfg: ModelConfig):
    d, w, kc = cfg.d_model, cfg.rnn_width, cfg.ssm_conv
    b.dense(f"{name}.in_x", (d, w), ("fsdp", "rnn"))
    b.dense(f"{name}.in_gate", (d, w), ("fsdp", "rnn"))
    b.dense(f"{name}.conv_w", (kc, w), ("conv", "rnn"), scale=0.5)
    b.zeros(f"{name}.conv_b", (w,), ("rnn",))
    b.dense(f"{name}.w_a", (w, w), ("rnn", None), scale=0.02)
    b.dense(f"{name}.w_i", (w, w), ("rnn", None), scale=0.02)
    # Lambda so that a^c lies in (0.9, 0.999) at r = 1 (Griffin's appendix)
    b.const(f"{name}.Lambda", torch.full((w,), 0.7, dtype=torch.float32), ("rnn",))
    b.dense(f"{name}.out_proj", (w, d), ("rnn", "fsdp"))


def gates(cfg: ModelConfig, params, name: str, x_act):
    """``(log_a, i)`` of the recurrence, both float32."""
    # each gate summed over the split rnn columns once, back onto them (a no-op on plain tensors)
    r = torch.sigmoid(shard(x_act @ params[f"{name}.w_a"], "batch", "seq", "rnn").float())
    i = torch.sigmoid(shard(x_act @ params[f"{name}.w_i"], "batch", "seq", "rnn").float())
    lam = softplus(params[f"{name}.Lambda"].float())
    log_a = -RG_LRU_C * lam * r
    return log_a, i


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype, device):
    w, kc = cfg.rnn_width, cfg.ssm_conv
    return {
        "conv": torch.zeros((batch, kc - 1, w), dtype=dtype, device=device),
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
    }


def rglru_cache_axes() -> dict:
    return {"conv": ("batch", "conv", "rnn"), "h": ("batch", "rnn")}


def apply_rglru_prefill(cfg: ModelConfig, params, name: str, x, *, impl=None):
    """Full-sequence recurrent mixer of a normed input ``(B, S, d)``.  Returns
    ``(out, cache)`` with the decode cache (conv tail and last state)."""
    xb = x @ params[f"{name}.in_x"]
    gate = x @ params[f"{name}.in_gate"]
    xb = shard(xb, "batch", "seq", "rnn")
    x_conv, _ = causal_conv(xb, params[f"{name}.conv_w"], params[f"{name}.conv_b"])
    x_act = F.silu(x_conv)
    log_a, i = gates(cfg, params, name, x_act)
    h, h_last = rglru_ops.rglru_scan(log_a, i * x_act.float(), impl=impl)
    y = shard(h.to(x.dtype) * F.silu(gate), "batch", "seq", "rnn")
    out = shard(y @ params[f"{name}.out_proj"], "batch", "seq", "embed")
    return out, {"conv": conv_tail(xb, cfg.ssm_conv), "h": h_last}


def apply_rglru_decode(cfg: ModelConfig, params, name: str, x, cache):
    """One-token step.  x ``(B, 1, d)``; cache ``{"conv": (B, K-1, W), "h":
    (B, W)}``.  Returns ``(out, new cache)``."""
    xb = x @ params[f"{name}.in_x"]
    gate = x @ params[f"{name}.in_gate"]
    x_conv, conv_state = causal_conv(xb, params[f"{name}.conv_w"], params[f"{name}.conv_b"], cache["conv"])
    x_act = F.silu(x_conv)
    log_a, i = gates(cfg, params, name, x_act)
    h, _ = rglru_ops.rglru_step(log_a[:, 0], (i * x_act.float())[:, 0], cache["h"])
    y = h[:, None, :].to(x.dtype) * F.silu(gate)
    out = y @ params[f"{name}.out_proj"]
    return out, {"conv": conv_state.to(cache["conv"].dtype), "h": h}
