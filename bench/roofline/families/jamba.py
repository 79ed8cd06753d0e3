"""Jamba (AI21-Jamba2-Mini's family): layer ``i`` is of the kind
``block_pattern[i % len(block_pattern)]``, a mixer (``mamba`` or ``attn``) and
a feed-forward (``moe`` or ``mlp``), each counted by its kind: a Mamba-1
mixer's four products, the attention's four projections and its causal
scores, the router and ``top_k`` experts of a mixture of experts, a SwiGLU."""

from __future__ import annotations

import math

from bench.roofline.counts import visible_pairs


def _kinds(m: dict) -> list[tuple[str, str]]:
    pattern = m["block_pattern"]
    return [tuple(pattern[i % len(pattern)].split("_")) for i in range(m["n_layers"])]


def _d_head(m: dict) -> int:
    return m.get("d_head") or m["d_model"] // m["n_heads"]


def matmul_params(m: dict) -> int:
    d, f = m["d_model"], m["d_ff"]
    di, n, r = m.get("ssm_expand", 2) * d, m["ssm_state"], m.get("dt_rank") or math.ceil(d / 16)
    h, kv, dh = m["n_heads"], m["n_kv_heads"], _d_head(m)
    mixer = {"mamba": d * 2 * di + di * (r + 2 * n) + r * di + di * d, "attn": 2 * d * h * dh + 2 * d * kv * dh}
    mlp = d * f * (3 if m.get("gated_mlp", True) else 2)
    ffn = {"moe": d * m["n_experts"] + m["top_k"] * mlp, "mlp": mlp}
    return sum(mixer[a] + ffn[b] for a, b in _kinds(m))


def attention_flops(m: dict, batch: int, seq: int) -> float:
    layers = sum(a == "attn" for a, _ in _kinds(m))
    return 4.0 * _d_head(m) * visible_pairs(seq, seq) * m["n_heads"] * batch * layers


def scan_layers(m: dict) -> int:
    return sum(a == "mamba" for a, _ in _kinds(m))
