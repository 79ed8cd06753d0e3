"""On the card: every cell of BENCHMARK.json runs once, at a short window, to
a correct result with its metrics (``--trace 0``), and the trace of the
first cell is read (``--trace 1``).  Marked ``cuda``; skips without a card.

    python3 -m pytest -q bench/tests/test_bench_cuda.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT

pytestmark = pytest.mark.cuda
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(workload: str, trace: int) -> dict:
    proc = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"), "--workload", workload, "--seed",
                           str(2**31 + 99), "--seconds", "5", "--trace", str(trace)],
                          capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_runs_correct_on_the_card(card, workload):
    result = _run(workload, 0)
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu" and "setup_s" in result["metrics"]


def test_a_traced_run_reads_the_device(card):
    result = _run(MANIFEST["workloads"][0]["name"], 1)
    assert result["device"]["busy_s"] > 0 and result["metrics"]
