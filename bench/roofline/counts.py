"""Operations and bytes from shapes: a model step's model FLOPs and a kernel
call's least time on the chip.

``visible_pairs``, ``attention_bound`` and ``scan_bound`` are frozen copies of
``chip_smoke.py``'s, taking shapes instead of tensors.  The model counts take
the ``"model"`` block of a configuration file (a plain dict), and count the
work the inputs need: every weight product once per token (the forward's 2
operations per weight, the training step's 6), the attention's two products
over the (query, key) pairs a causal mask leaves, and no element-wise work.
What differs by family (the weights a token meets, the attention, the scans)
is its module's under :mod:`bench.roofline.families`, found by name.
"""

from __future__ import annotations

import numpy as np

from bench.family import find
from bench.roofline import peaks


def family(m: dict):
    """The module of ``bench/roofline/families/`` named by the model block's
    ``family``: its ``matmul_params``, ``attention_flops`` and ``scan_layers``."""
    return find("bench.roofline.families", m["family"], "matmul_params")


def padded_vocab(m: dict) -> int:
    return -(-m["vocab_size"] // 128) * 128


def matmul_params(m: dict) -> int:
    """Weights each token is multiplied by, summed over the layers (no norm,
    bias, conv or head; a mixture of experts' router and ``top_k`` experts)."""
    return family(m).matmul_params(m)


def scan_layers(m: dict) -> int:
    """Mamba-1 selective scans one forward runs."""
    return family(m).scan_layers(m)


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
    return family(m).attention_flops(m, batch, seq)


def train_step_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 per weight and token (forward and
    backward) over the layers and the output head, plus 3 times the
    attention's forward."""
    tokens = batch * seq
    weights = matmul_params(m) + m["d_model"] * padded_vocab(m)
    return 6.0 * weights * tokens + 3.0 * attention_flops(m, batch, seq)


def prefill_flops(m: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``seq`` tokens: 2 per
    weight and token through the layers, the output head on the last position
    only, and the attention's forward where the model has one."""
    layers = 2.0 * matmul_params(m) * batch * seq
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
