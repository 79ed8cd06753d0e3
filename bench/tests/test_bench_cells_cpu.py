"""Whole runs of tiny cells on the CPU, through the same code as a run on the
card but for the look for a card: the serve driver on a dense and an SSM
configuration, the train driver on both, traced and not; and a cell, a
configuration, a traffic mix and a per-layer metric added as files alone."""

from __future__ import annotations

import json
import math

import pytest

from bench.harness import cell
from bench.harness.manifest import Manifest

SEED = 2**33 + 17


@pytest.mark.parametrize("workload", ["dense-tiny.serve-tiny", "ssm-tiny.serve-tiny", "dense-tiny.train-tiny",
                                      "ssm-tiny.train-tiny"])
@pytest.mark.parametrize("traced", [False, True])
def test_tiny_cell_runs_and_is_correct(tiny_root, workload, traced):
    result, notes = cell.run(tiny_root, workload, SEED, 0.5, traced, "cpu")
    assert result["correct"], result["compared"]
    assert list(result)[-1] == "compared" and result["attempted"] >= 1 and result["failed"] == 0
    m = Manifest(tiny_root)
    want = m.per_layer(workload) if traced else m.end_to_end(workload)
    if traced:  # the device readers find no device operation on the CPU and report nothing
        assert {"mfu.train", "mfu.prefill", "decode_step_ms"} & set(result["metrics"])
        assert "busy_s" in result["device"] and "breakdown" in result
    else:
        assert set(result["metrics"]) == {s["name"] for s in want}
    for v in result["metrics"].values():
        assert math.isfinite(v["value"]) and v["value"] > 0
    json.dumps(result)


def test_a_cell_is_added_by_files_alone(tiny_root):
    """A new configuration, traffic mix, limit file and per-layer metric reader,
    with their BENCHMARK.json entries, are found by name: no file of the
    harness changes."""
    conf = json.loads((tiny_root / "bench" / "configs" / "dense-tiny.json").read_text())
    conf["model"] = dict(conf["model"], name="dense-wide", d_model=96, n_heads=6, n_kv_heads=3)
    (tiny_root / "bench" / "configs" / "dense-wide.json").write_text(json.dumps(conf))
    traffic = json.loads((tiny_root / "bench" / "traffic" / "serve-tiny.json").read_text())
    traffic["cycle"] = [{"prompt": 24, "batch": 2, "count": 2}]
    (tiny_root / "bench" / "traffic" / "serve-other.json").write_text(json.dumps(traffic))
    (tiny_root / "bench" / "limits" / "dense-wide.serve-other.json").write_text(
        json.dumps({"limits": {"token_gap": 1e-4}}))
    (tiny_root / "bench" / "metrics" / "prefills_per_s.py").write_text(
        "def read(run):\n    p = [s for s in run.spans if s.name == 'prefill']\n"
        "    return len(p) / sum(s.seconds for s in p) if p else None\n")
    manifest = json.loads((tiny_root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "dense-wide", "source": "test", "file": "bench/configs/dense-wide.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "dense-wide.serve-other", "config": "dense-wide", "traffic": "serve-other",
                                  "chips": 1, "why": "test"})
    for metric in manifest["end_to_end"]:
        if metric["name"] in ("serve_tokens_per_s", "ttft_mean_ms"):
            metric["workloads"].append("dense-wide.serve-other")
    manifest["per_layer"].append({"name": "prefills_per_s", "unit": "1/s", "better": "higher", "source": "host_clock",
                                  "layer": "prefill", "moves": "ttft_mean_ms", "workloads": ["dense-wide.serve-other"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(manifest))
    result, _ = cell.run(tiny_root, "dense-wide.serve-other", SEED, 0.3, True, "cpu")
    assert result["correct"] and result["metrics"]["prefills_per_s"]["value"] > 0
    result, _ = cell.run(tiny_root, "dense-wide.serve-other", SEED, 0.3, False, "cpu")
    assert set(result["metrics"]) == {"serve_tokens_per_s", "ttft_mean_ms", "setup_s"}
