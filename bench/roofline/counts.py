"""Operations and bytes from shapes: a model step's model FLOPs and a kernel
call's least time on the chip.

``visible_pairs``, ``attention_bound`` and ``scan_bound`` are frozen copies of
``chip_smoke.py``'s, taking shapes instead of tensors.  The model counts take
the ``"model"`` block of a configuration file (a plain dict), and count the
work the inputs need: every weight product once per token (the forward's 2
operations per weight, the training step's 6), the attention's two products
over the (query, key) pairs a causal mask leaves, and no element-wise work.
"""

from __future__ import annotations

import math

import numpy as np

from bench.roofline import peaks


def _dims(m: dict) -> dict:
    d = m["d_model"]
    out = dict(m)
    if m.get("n_heads"):
        out["d_head"] = m.get("d_head") or d // m["n_heads"]
    if m["family"] == "ssm":
        out["d_inner"] = m.get("ssm_expand", 2) * d
        out["dt_rank"] = m.get("dt_rank") or math.ceil(d / 16)
    return out


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 128) * 128


def layer_matmul_params(m: dict) -> int:
    """Weights one layer multiplies each token by (no norm, bias or conv)."""
    m = _dims(m)
    d = m["d_model"]
    if m["family"] == "ssm":
        di, n, r = m["d_inner"], m["ssm_state"], m["dt_rank"]
        return d * 2 * di + di * (r + 2 * n) + r * di + di * d
    if m["family"] != "dense":
        raise ValueError(f"no count for family {m['family']!r}")
    h, kv, dh, f = m["n_heads"], m["n_kv_heads"], m["d_head"], m["d_ff"]
    mlp = d * f * (3 if m.get("gated_mlp", True) else 2)
    return d * h * dh + 2 * d * kv * dh + h * dh * d + mlp


def visible_pairs(sq: int, sk: int, causal: bool = True, window: int = 0, q_offset: int = 0) -> int:
    """The (q, k) pairs that attention scores: k <= q + q_offset if causal, k > q +
    q_offset - window with a window."""
    qp = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(qp, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_flops(m: dict, batch: int, seq: int) -> float:
    """Forward operations of every layer's causal self-attention over ``batch``
    rows of ``seq`` tokens: 4 * D per visible pair and query head (QK^T, PV)."""
    m = _dims(m)
    if m["family"] != "dense":
        return 0.0
    return 4.0 * m["d_head"] * visible_pairs(seq, seq) * m["n_heads"] * batch * m["n_layers"]


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 per weight and token (forward and
    backward) over the layers and the output head, plus 3 times the
    attention's forward."""
    tokens = batch * seq
    weights = m["n_layers"] * layer_matmul_params(m) + m["d_model"] * padded_vocab(m)
    return 6.0 * weights * tokens + 3.0 * attention_flops(m, batch, seq)


def prefill_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens: 2 per
    weight and token through the layers, the output head on the last position
    only, and the attention's forward where the model has one."""
    layers = 2.0 * m["n_layers"] * layer_matmul_params(m) * batch * seq
    head = 2.0 * m["d_model"] * padded_vocab(m) * batch
    return layers + head + attention_flops(m, batch, seq)


def attention_bound(batch: int, sq: int, sk: int, heads: int, kv_heads: int, d: int, elem_bytes: int = 2,
                    causal: bool = True, window: int = 0, q_offset: int = 0) -> tuple[float, str]:
    """Least seconds for one attention: 4 * D tensor-core operations per visible (q, k)
    pair and head at the bf16 rate, or q, k, v read and o written once at HBM
    bandwidth, whichever is larger."""
    ops = 4 * d * visible_pairs(sq, sk, causal, window, q_offset) * batch * heads
    nbytes = elem_bytes * (2 * batch * sq * heads * d + 2 * batch * sk * kv_heads * d)
    ops_s, bytes_s = ops / peaks.BF16_TENSOR_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")


def scan_bound(batch: int, seq: int, d: int, n: int, c_bytes: int = 2) -> tuple[float, str]:
    """Least seconds for one Mamba-1 selective scan: dtA and dBx (float32, (B, S, D,
    N)) and C ((B, S, N)) read once, y ((B, S, D), float32) and the last state ((B,
    D, N), float32) written once at HBM bandwidth, or 5 float32 operations per state
    element at the non-tensor rate, whichever is larger."""
    elems = batch * seq * d * n
    nbytes = 4 * 2 * elems + c_bytes * batch * seq * n + 4 * (batch * seq * d + batch * d * n)
    ops = 5 * elems
    ops_s, bytes_s = ops / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S
    return (ops_s, "operations") if ops_s > bytes_s else (bytes_s, "bytes")
