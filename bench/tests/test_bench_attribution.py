"""The program spans' attribution: device operations charged to every program
range open on the host when their launch call ran (any thread, never by
device-time overlap), launch calls counted once each, the idle gaps split by
the innermost program span, and whole traced runs of the tiny cells read
through ``bench/program_spans.py``; on the card (marked ``cuda``), both
cells' readings.

    python3 -m pytest -q bench/tests/test_bench_attribution.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from bench import program_spans
from bench.harness import attribution, trace
from conftest import ROOT

MS = 1_000_000


def _rng(name, s, e, thread=1):
    return (name, "range", s * MS, e * MS, thread, 0)


def _call(s, corr, thread=1):
    return ("cudaLaunchKernel", "call", s * MS, s * MS + 1000, thread, corr)


def _op(s, e, corr):
    return ("kernel", "device", s * MS, e * MS, 0, corr)


CASES = {
    # a launch from autograd's thread while the step's thread waits inside its range
    "second_thread": ([_rng("train.backward", 0, 10, thread=1), _rng("kernel.x.recompute", 2, 8, thread=2),
                       _call(3, 7, thread=2), _op(4, 6, 7)],
                      {"train.backward": (1, 2.0, 1), "kernel.x.recompute": (1, 2.0, 1)}),
    # nested ranges: the op counts in both, the outer one's other op in it alone
    "nested": ([_rng("decode.step", 0, 10), _rng("decode.mixer", 1, 4), _call(2, 1), _op(2, 5, 1), _call(6, 2),
                _op(6, 7, 2)],
               {"decode.step": (1, 4.0, 2), "decode.mixer": (1, 3.0, 1)}),
    # an op whose launch falls outside every range belongs to none
    "outside": ([_rng("prefill", 0, 5), _call(6, 3), _op(6, 8, 3)], {"prefill": (1, 0.0, 0)}),
    # the host ran ahead: the op runs on the device after its range closed, and still counts there
    "late_op": ([_rng("train.forward", 0, 5), _rng("train.adamw", 5, 9), _call(4, 9), _op(7, 12, 9)],
                {"train.forward": (1, 5.0, 1), "train.adamw": (1, 0.0, 0)}),
    # a graph launch: one call, three ops
    "graph": ([_rng("decode.step", 0, 10), _call(1, 5), _op(2, 3, 5), _op(3, 5, 5), _op(5, 6, 5)],
              {"decode.step": (1, 4.0, 1)}),
    # a call that enqueued nothing (a synchronize) is no launch; two ranges of one name count twice
    "no_work": ([_rng("decode.step", 0, 3), _rng("decode.step", 4, 8), ("cudaStreamSynchronize", "call", 1 * MS,
                 2 * MS, 1, 4), _call(5, 6), _op(5, 6, 6)],
                {"decode.step": (2, 1.0, 1)}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_attribute_synthetic_events(case):
    evts, want = CASES[case]
    got = attribution.attribute(evts)
    assert set(got) == set(want)
    for name, (count, device_ms, launches) in want.items():
        assert got[name]["count"] == count
        assert got[name]["device_s"] == pytest.approx(device_ms * 1e-3)
        assert got[name]["launches"] == launches
    hosts = {name: sum(e - s for n, k, s, e, _, _ in evts if k == "range" and n == name) * 1e-9 for name in want}
    assert {n: r["host_s"] for n, r in got.items()} == pytest.approx(hosts)


def test_readings_per_step_and_missing_spans():
    program = {"train.step": {"count": 4, "host_s": 2.0, "device_s": 2.0, "launches": 400},
               "train.forward": {"count": 4, "host_s": 0.4, "device_s": 0.2, "launches": 100},
               "kernel.flash_attention_backward": {"count": 16, "host_s": 0.01, "device_s": 0.036, "launches": 64},
               "decode.step": {"count": 10, "host_s": 0.7, "device_s": 0.1, "launches": 30_000}}
    assert attribution.reading(program, "train_forward_ms") == pytest.approx(50.0)
    assert attribution.reading(program, "attention_backward_ms") == pytest.approx(9.0)  # 4 calls a step
    assert attribution.reading(program, "decode_device_ms") == pytest.approx(10.0)
    assert attribution.reading(program, "decode_launches_per_step") == pytest.approx(3000.0)
    assert attribution.reading(program, "train_adamw_ms") is None
    assert attribution.reading(program, "ssm_inputs_ms") is None  # no prefill span to divide by
    assert attribution.reading(None, "train_forward_ms") is None
    assert attribution.reading({}, "decode_device_ms") is None


def test_idle_split_by_the_innermost_program_span_on_the_window_thread():
    evts = [(trace.WINDOW, "window", 0, 100 * MS, 1, 0), _rng("decode.step", 10, 50), _rng("decode.mixer", 20, 30),
            _rng("kernel.x.recompute", 60, 90, thread=2), _op(0, 10, 1), _op(25, 30, 2)]
    idle = dict(attribution.idle_by_span(evts))
    assert idle["decode.step"] == pytest.approx(0.030)  # 10-20 and 30-50 ms
    assert idle["decode.mixer"] == pytest.approx(0.005)  # 20-25 ms
    assert idle["none"] == pytest.approx(0.050)  # 50-100 ms: the other thread's range does not count
    assert attribution.idle_by_span([_rng("prefill", 0, 1)]) is None


def test_the_profiler_events_carry_the_program_ranges():
    from repro_torch import obs

    prof = trace.profiler("cpu")
    prof.start()
    with torch.profiler.record_function(trace.WINDOW):
        with obs.current().span("decode.step", pos=3):
            with obs.current().span("decode.mixer"):
                torch.ones(8).sum()
    prof.stop()
    evts = attribution.events(prof)
    ranges = sorted(name for name, kind, *_ in evts if kind == "range")
    assert ranges == ["decode.mixer", "decode.step"]
    assert [kind for _, kind, *_ in evts].count("window") == 1
    got = attribution.attribute(evts)
    assert got["decode.step"]["count"] == 1 and got["decode.step"]["launches"] == 0  # no device on the CPU


@pytest.mark.parametrize("workload, spans", [
    ("dense-tiny.train-tiny", ("train.step", "train.forward", "train.backward", "train.adamw")),
    ("ssm-tiny.serve-tiny", ("prefill", "prefill.ssm_inputs", "decode.step", "decode.mixer")),
])
def test_a_traced_tiny_run_reads_the_program_spans(tiny_root, workload, spans):
    line = program_spans.run(tiny_root, workload, 2**33 + 5, 0.5, "cpu")
    assert line["correct"]
    program = line["program"]
    assert set(spans) <= set(program)
    outer, inner = program[spans[0]], program[spans[1]]
    if workload.endswith("train-tiny"):
        assert outer["count"] == line["notes"]["steps_done"] == program["train.adamw"]["count"]
    else:
        assert outer["count"] == len(line["notes"]["batches"]) and inner["count"] == 2 * outer["count"]
        assert program["decode.step"]["count"] == line["notes"]["decode_steps"]
    assert all(r["device_s"] == 0.0 and r["launches"] == 0 for r in program.values())  # the CPU launches nothing
    assert line["idle_by_program_span"] is not None


CARD_READINGS = {
    "glm4-9b.train-4k": ("train_forward_ms", "train_backward_ms", "attention_backward_ms", "train_adamw_ms"),
    "falcon-mamba-7b.serve-longdoc-16k": ("ssm_inputs_ms", "decode_device_ms", "decode_launches_per_step"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", list(CARD_READINGS))
def test_the_cells_read_their_program_spans_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run([sys.executable, str(ROOT / "bench" / "program_spans.py"), "--workload", workload,
                           "--seed", str(2**31 + 99), "--seconds", "5"], capture_output=True, text=True, cwd=ROOT,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    readings = line["readings"]
    assert line["correct"] and all(readings[m] is not None and readings[m] > 0 for m in CARD_READINGS[workload])
    if "train_forward_ms" in CARD_READINGS[workload]:
        busy_ms = 1e3 * line["device"]["busy_s"] / line["program"]["train.step"]["count"]
        split_ms = readings["train_forward_ms"] + readings["train_backward_ms"] + readings["train_adamw_ms"]
        assert abs(split_ms - busy_ms) <= 0.1 * busy_ms, (split_ms, busy_ms)
        assert readings["attention_backward_ms"] <= readings["train_backward_ms"]
