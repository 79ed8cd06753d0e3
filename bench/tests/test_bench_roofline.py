"""The frozen counts equal hand counts at tiny shapes, and the counts of the
benchmark's own configurations equal the integers they were frozen at."""

from __future__ import annotations

import json

import pytest

from bench.roofline import counts, peaks
from conftest import DENSE, ROOT, SSM


def test_visible_pairs():
    assert counts.visible_pairs(4, 4) == 10
    assert counts.visible_pairs(4, 4, causal=False) == 16
    assert counts.visible_pairs(4, 4, window=2) == 7
    assert counts.visible_pairs(2, 6, q_offset=4) == 5 + 6


def test_dense_counts():
    d, h, kv, dh, f, v = 64, 4, 2, 16, 160, 256
    per_layer = d * h * dh + 2 * d * kv * dh + h * dh * d + 3 * d * f
    assert counts.matmul_params(DENSE) == 2 * per_layer  # two layers
    attn = 4 * dh * (8 * 9 // 2) * h * 3 * 2  # batch 3, seq 8, two layers
    assert counts.attention_flops(DENSE, 3, 8) == attn
    assert counts.train_step_flops(DENSE, 3, 8) == 6 * (2 * per_layer + d * v) * 24 + 3 * attn
    assert counts.prefill_flops(DENSE, 3, 8) == 2 * 2 * per_layer * 24 + 2 * d * v * 3 + attn
    assert counts.scan_layers(DENSE) == 0


def test_ssm_counts():
    d, di, n, r, v = 64, 128, 4, 4, 256
    per_layer = d * 2 * di + di * (r + 2 * n) + r * di + di * d
    assert counts.matmul_params(SSM) == 2 * per_layer  # two layers
    assert counts.attention_flops(SSM, 2, 8) == 0
    assert counts.prefill_flops(SSM, 2, 8) == 2 * 2 * per_layer * 16 + 2 * d * v * 2
    assert counts.scan_layers(SSM) == 2


#: config -> (train_step_flops at 2 x 4096, prefill_flops at 8 x 2048, 2 x 8192, 1 x 16384, scan_layers):
#: the integers the counts gave when the benchmark's cells were first measured.
FROZEN = {
    "glm4-9b": (73908602535936, (27841857060864, 31132942860288, 35529747857408), 0),
    "falcon-mamba-7b": (343769182371840, (220456342781952, 220453146722304, 220452614045696), 64),
}


@pytest.mark.parametrize("name", list(FROZEN))
def test_the_configurations_counts_are_frozen(name):
    m = json.loads((ROOT / "bench" / "configs" / f"{name}.json").read_text())["model"]
    train, prefills, scans = FROZEN[name]
    assert counts.train_step_flops(m, 2, 4096) == train
    assert [counts.prefill_flops(m, b, s) for b, s in ((8, 2048), (2, 8192), (1, 16384))] == list(prefills)
    assert counts.scan_layers(m) == scans


def test_bounds():
    s, by = counts.scan_bound(2, 8, 16, 4, c_bytes=2)
    nbytes = 4 * 2 * (2 * 8 * 16 * 4) + 2 * 2 * 8 * 4 + 4 * (2 * 8 * 16 + 2 * 16 * 4)
    assert by == "bytes" and s == pytest.approx(nbytes / peaks.HBM_BYTES_PER_S)
    s, by = counts.attention_bound(1, 4096, 4096, 32, 2, 128)
    assert by == "operations" and s == pytest.approx(4 * 128 * (4096 * 4097 // 2) * 32 / peaks.BF16_TENSOR_FLOPS)
    # glm4-9b's step at 2 x 4096 and 4 layers: 7.39e13 model FLOPs
    glm = dict(DENSE, n_layers=4, d_model=4096, n_heads=32, n_kv_heads=2, d_head=128, d_ff=13696, vocab_size=151552)
    assert counts.train_step_flops(glm, 2, 4096) == pytest.approx(7.39e13, rel=2e-3)
