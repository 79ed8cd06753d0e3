"""A dense decoder (glm4-9b's family): grouped-query causal attention and a
(gated) MLP in every layer, no scan."""

from __future__ import annotations

from bench.roofline.counts import visible_pairs


def _d_head(m: dict) -> int:
    return m.get("d_head") or m["d_model"] // m["n_heads"]


def matmul_params(m: dict) -> int:
    d, h, kv, dh, f = m["d_model"], m["n_heads"], m["n_kv_heads"], _d_head(m), m["d_ff"]
    mlp = d * f * (3 if m.get("gated_mlp", True) else 2)
    return m["n_layers"] * (d * h * dh + 2 * d * kv * dh + h * dh * d + mlp)


def attention_flops(m: dict, batch: int, seq: int) -> float:
    return 4.0 * _d_head(m) * visible_pairs(seq, seq) * m["n_heads"] * batch * m["n_layers"]


def scan_layers(m: dict) -> int:
    return 0
