"""The ``jamba`` family in the benchmark, on the CPU: a tiny jamba cell added
by files alone is served ``correct`` by the harness; its model-FLOP counts equal
a hand count to the integer; the benchmark's reference layers agree with the
program's own plain reference (``repro_torch/models/jamba_ref.py``) on seeded
weights; and the configuration's counts are those of one published period."""

from __future__ import annotations

import json

import pytest
import torch

from bench.harness import cell, weights
from bench.reference import model
from bench.roofline import counts
from conftest import ROOT, SERVE
from repro_torch.models import jamba_ref
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

PERIOD = ["mamba_mlp", "mamba_moe", "mamba_mlp", "mamba_moe", "attn_mlp", "mamba_moe", "mamba_mlp", "mamba_moe"]
JAMBA = {"name": "jamba-tiny", "family": "jamba", "n_layers": 8, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "d_head": 16, "d_ff": 96, "vocab_size": 256, "n_experts": 4, "top_k": 2, "moe_impl": "dropless",
         "ssm_state": 4, "dt_rank": 8, "block_pattern": PERIOD, "dtype": "float32"}
SEED = 2**33 + 29


def _params(m, seed=SEED):
    return weights.make(T.abstract_params(ModelConfig(**m)), seed, "cpu")


def test_a_tiny_jamba_cell_is_added_by_files_alone_and_runs_correct(tiny_root):
    (tiny_root / "bench" / "configs" / "jamba-tiny.json").write_text(json.dumps({"model": JAMBA, "norm_eps": 1e-6}))
    (tiny_root / "bench" / "limits" / "jamba-tiny.serve-tiny.json").write_text(
        json.dumps({"limits": {"token_gap": 1e-4}}))
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "jamba-tiny", "source": "test", "file": "bench/configs/jamba-tiny.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "jamba-tiny.serve-tiny", "config": "jamba-tiny", "traffic": "serve-tiny",
                                  "chips": 1, "why": "test"})
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if "jamba2-mini.serve-longdoc" in metric.get("workloads", ()):
            metric["workloads"].append("jamba-tiny.serve-tiny")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for traced in (False, True):
        result, notes = cell.run(tiny_root, "jamba-tiny.serve-tiny", SEED, 0.3, traced, "cpu")
        assert result["correct"], result["compared"]
        assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"serve_tokens_per_s", "ttft_mean_ms"} <= set(
        cell.run(tiny_root, "jamba-tiny.serve-tiny", SEED, 0.3, False, "cpu")[0]["metrics"])
    assert notes["checked"] and all(n in {k["prompt"] for k in SERVE["cycle"]} for n, _ in notes["checked"])


def test_jamba_counts():
    d, h, kv, dh, f, v, e, k = 64, 4, 2, 16, 96, 256, 4, 2
    di, n, r = 128, 4, 8
    mamba = d * 2 * di + di * (r + 2 * n) + r * di + di * d
    attn = d * h * dh + 2 * d * kv * dh + h * dh * d
    mlp = 3 * d * f
    moe = d * e + k * mlp
    layers = 7 * mamba + attn + 4 * moe + 4 * mlp
    assert counts.matmul_params(JAMBA) == layers
    assert counts.scan_layers(JAMBA) == 7
    pairs = 8 * 9 // 2
    assert counts.attention_flops(JAMBA, 3, 8) == 4 * dh * pairs * h * 3  # one attention layer
    assert counts.prefill_flops(JAMBA, 3, 8) == 2 * layers * 24 + 2 * d * v * 3 + 4 * dh * pairs * h * 3


def test_the_configurations_counts_are_one_published_period():
    m = json.loads((ROOT / "bench" / "configs" / "jamba2-mini.json").read_text())["model"]
    assert counts.matmul_params(m) == 2_891_972_608
    assert counts.scan_layers(m) == 7
    cfg = ModelConfig(**m)
    assert cfg.param_count() == 13_295_237_088
    assert T.layer_kinds(cfg) == PERIOD


@pytest.mark.parametrize("precision", ["fp32", "fp8"])
def test_the_reference_layers_agree_with_the_programs_plain_reference(precision):
    params = _params(JAMBA)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, JAMBA["vocab_size"], (2, 40), generator=gen)
    got = model.logits_at(JAMBA, params, tokens, range(40), 1e-6, precision)
    want = jamba_ref.forward(ModelConfig(**JAMBA), params, tokens)
    gap = float((got - want).abs().max() / want.abs().max())
    if precision == "fp32":
        assert gap < 1e-5
    else:  # the float8 control has to lie well away from the float32 model
        assert gap > 1e-2
