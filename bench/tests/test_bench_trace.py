"""The trace reader: busy time as the union of device operations inside the
window, idle gaps named by the innermost open host span, and the profiler's
own events read in memory."""

from __future__ import annotations

import pytest
import torch

from bench.harness import trace
from bench.harness.spans import Spans


def test_summarize_synthetic_events():
    ms = 1_000_000
    evts = [("bench.window", "span", 0, 100 * ms), ("bench.step", "span", 0, 60 * ms),
            ("bench.host_copy", "span", 40 * ms, 60 * ms), ("bench.data", "span", 60 * ms, 100 * ms),
            ("gemm", "device", 10 * ms, 30 * ms), ("add", "device", 20 * ms, 35 * ms),
            ("gemm", "device", 70 * ms, 80 * ms), ("late", "device", 95 * ms, 120 * ms)]
    s = trace.summarize(evts)
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.025 + 0.010 + 0.005)
    assert s["device_ops"][0] == ["gemm", pytest.approx(0.030)]
    idle = dict(s["idle_gaps"])
    assert idle["step"] == pytest.approx(0.015)  # 0-10 and 35-40 ms
    assert idle["host_copy"] == pytest.approx(0.020)  # 40-60 ms
    assert idle["data"] == pytest.approx(0.025)  # 60-70 and 80-95 ms
    assert trace.summarize([("gemm", "device", 0, 1)]) is None


def test_the_profiler_is_read_in_memory():
    spans = Spans(traced=True)
    prof = trace.profiler("cpu")
    prof.start()
    with spans.span("window"):
        with spans.span("step"):
            x = torch.randn(64, 64)
            (x @ x).sum()
    prof.stop()
    evts = trace.events(prof)
    names = {n for n, kind, _, _ in evts if kind == "span"}
    assert {"bench.window", "bench.step"} <= names
    s = trace.summarize(evts)
    assert s["busy_s"] == 0.0 and s["window_s"] > 0
    assert [n for n, _ in s["idle_gaps"]] == ["step"] or s["idle_gaps"][0][0] in ("step", "window", "none")
