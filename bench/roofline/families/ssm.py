"""Mamba-1 (falcon-mamba-7b's family): a selective-scan mixer in every layer,
no attention."""

from __future__ import annotations

import math


def matmul_params(m: dict) -> int:
    d = m["d_model"]
    di, n, r = m.get("ssm_expand", 2) * d, m["ssm_state"], m.get("dt_rank") or math.ceil(d / 16)
    return m["n_layers"] * (d * 2 * di + di * (r + 2 * n) + r * di + di * d)


def attention_flops(m: dict, batch: int, seq: int) -> float:
    return 0.0


def scan_layers(m: dict) -> int:
    return m["n_layers"]
