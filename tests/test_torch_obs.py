"""The port's telemetry exporters against ``repro.obs.exporters``.

The same recorded spans, events, counters and gauges written by both
packages give the same JSONL log, the same Chrome trace and the same
summary table, byte for byte; a live serving run exports a trace that
parses.
"""

import json

import pytest

from repro.obs import telemetry as ref_telemetry
from repro.obs import exporters as ref_exporters

from repro_torch import obs
from repro_torch.obs import exporters
from repro_torch.obs import telemetry
from repro_torch.serving import ServingScenario, run_serving


def recorded(mod):
    """One collector of ``mod`` holding a fixed record (no clock reads)."""
    tel = mod.Telemetry()
    sim = mod.Span("sim", 0.25, 0.5, {"impl": "plain"})
    bill = mod.Span("bill", 0.75, 0.125, {"scheme": "hour", "obj": object.__name__})
    tel.spans = [mod.Span("engine.run", 0.125, 1.0, {"engine": "torch", "cells": 12}, [sim, bill]),
                 mod.Span("serving.run", 1.5, 0.0625)]
    tel.events = [mod.SimEvent("E_ckpt", 3600.0, {"step": 7}, 0.2), mod.SimEvent("E_launch", 0.0, {}, 0.1)]
    tel.counters = {"serving.scale_out": 42, "engine.kills": 3, "market.cleared_period_cells": 1.5}
    tel.gauges = {"util": 0.75}
    return tel


@pytest.mark.parametrize("writer", ["write_jsonl", "write_chrome_trace"])
def test_files_equal_the_reference(tmp_path, writer):
    getattr(exporters, writer)(recorded(telemetry), tmp_path / "port")
    getattr(ref_exporters, writer)(recorded(ref_telemetry), tmp_path / "ref")
    assert (tmp_path / "port").read_text() == (tmp_path / "ref").read_text()


def test_summary_equals_the_reference_and_methods_delegate(tmp_path):
    tel = recorded(telemetry)
    assert exporters.summary_table(tel) == ref_exporters.summary_table(recorded(ref_telemetry))
    assert tel.summary() == exporters.summary_table(tel)
    tel.write_jsonl(tmp_path / "a.jsonl")
    exporters.write_jsonl(tel, tmp_path / "b.jsonl")
    assert (tmp_path / "a.jsonl").read_text() == (tmp_path / "b.jsonl").read_text()
    lines = [json.loads(x) for x in (tmp_path / "a.jsonl").read_text().splitlines()]
    assert [x["type"] for x in lines] == ["span"] * 4 + ["event"] * 2 + ["counter"] * 3 + ["gauge"]
    assert exporters.summary_table(telemetry.Telemetry()) == "" and obs.summary_table is exporters.summary_table


def test_live_run_exports_a_trace(tmp_path):
    with obs.Telemetry() as tel:
        run_serving(ServingScenario(horizon_days=0.125, seeds=(0,), max_spot=4), device="cpu")
        tel.gauge("cells", 3.0)
    assert [s.name for s in tel.iter_spans()] == ["serving.run"] and len(tel.find_spans("serving.run")) == 1
    tel.write_chrome_trace(tmp_path / "trace.json")
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert "serving.run" in names and "serving.scale_out" in names
    assert "cells" in tel.summary()
    obs.NULL.gauge("ignored", 1.0)
    assert not obs.NULL.gauges
