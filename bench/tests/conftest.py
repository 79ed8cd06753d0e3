"""Shared set-up of the benchmark's CPU tests: the checkout's root and the
program on the import path, and a tiny copy of the benchmark (two small
configurations, a train and a serve traffic, their limits) in a temporary
directory, which ``bench.harness.cell.run`` takes as its root."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

DENSE = {"name": "dense-tiny", "family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "d_ff": 160, "vocab_size": 256, "rope_theta": 1e6, "dtype": "float32"}
SSM = {"name": "ssm-tiny", "family": "ssm", "n_layers": 2, "d_model": 64, "n_heads": 0, "n_kv_heads": 0, "d_ff": 0,
       "vocab_size": 256, "ssm_state": 4, "dtype": "float32"}
TRAIN = {"driver": "train", "batch": 2, "seq": 16, "mean_doc_len": 8, "eos": 0, "remat": False, "check_steps": 3,
         "optimizer": {"lr": 1e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0,
                       "moment_dtype": "float32"}}
SERVE = {"driver": "serve", "cycle": [{"prompt": 8, "batch": 4, "count": 2}, {"prompt": 16, "batch": 2, "count": 1},
                                      {"prompt": 32, "batch": 1, "count": 1}],
         "new_tokens": 4, "mean_doc_len": 8, "eos": 0, "check": {"served_tokens": 16, "prompt_tokens": 256}}
#: Limits of the tiny cells: the program and the reference both run in float32 on the CPU.
LIMITS = {"train": {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-4}, "serve": {"token_gap": 1e-4}}


def make_tiny_root(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` and ``bench/`` with the tiny cells
    ``{dense,ssm}-tiny.{train,serve}-tiny`` added by files and entries alone."""
    (dest / "bench").mkdir(parents=True)
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "bench" / sub, dest / "bench" / sub)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in (DENSE, SSM):
        (dest / "bench" / "configs" / f"{m['name']}.json").write_text(json.dumps({"model": m, "norm_eps": 1e-6}))
        manifest["configs"].append({"name": m["name"], "source": "test", "file": f"bench/configs/{m['name']}.json",
                                    "reduced": [], "why": "test"})
    for name, t in (("train-tiny", TRAIN), ("serve-tiny", SERVE)):
        (dest / "bench" / "traffic" / f"{name}.json").write_text(json.dumps(t))
    added = []
    for m in (DENSE, SSM):
        for kind in ("train", "serve"):
            w = f"{m['name']}.{kind}-tiny"
            added.append((w, kind))
            manifest["workloads"].append({"name": w, "config": m["name"], "traffic": f"{kind}-tiny", "chips": 1,
                                          "why": "test"})
            (dest / "bench" / "limits" / f"{w}.json").write_text(json.dumps({"limits": LIMITS[kind]}))
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in metric:
            kind = "train" if any(".train" in w for w in metric["workloads"]) else "serve"
            metric["workloads"] += [w for w, k in added if k == kind]
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return dest


@pytest.fixture()
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path / "checkout")
