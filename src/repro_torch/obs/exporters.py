"""Telemetry exporters: JSONL event log, Chrome trace, plain-text summary.

The port's copy of :mod:`repro.obs.exporters`: the same records in the same
formats.  Three views of one :class:`~repro_torch.obs.telemetry.Telemetry`
collector:

  * :func:`write_jsonl` — one self-describing JSON object per line
    (``{"type": "span" | "event" | "counter" | "gauge", ...}``), the
    machine-readable log for ad-hoc analysis;
  * :func:`write_chrome_trace` — the Chrome ``trace_event`` format
    (load in ``chrome://tracing`` or https://ui.perfetto.dev): spans become
    complete (``"X"``) slices on the wall-clock track, simulation-time
    events become instants on a separate *simulation* process so virtual
    hours don't stretch the wall-clock timeline;
  * :func:`summary_table` — the human-readable roll-up (per-span-name call
    counts and wall totals, then counters and gauges).
"""

from __future__ import annotations

import json
import pathlib
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from repro_torch.obs.telemetry import Telemetry

__all__ = ["summary_table", "write_chrome_trace", "write_jsonl"]


def _span_rows(tel: "Telemetry"):
    """(depth, span) pairs in depth-first emission order."""

    def walk(spans, depth):
        for s in spans:
            yield depth, s
            yield from walk(s.children, depth + 1)

    return walk(tel.spans, 0)


def write_jsonl(tel: "Telemetry", path) -> None:
    """Write every record as one JSON object per line."""
    lines = []
    for depth, s in _span_rows(tel):
        lines.append(
            json.dumps(
                {
                    "type": "span",
                    "name": s.name,
                    "t0_s": s.t0,
                    "dur_s": s.dur,
                    "depth": depth,
                    **({"attrs": s.attrs} if s.attrs else {}),
                }
            )
        )
    for e in tel.events:
        lines.append(
            json.dumps(
                {
                    "type": "event",
                    "name": e.name,
                    "sim_t_s": e.t,
                    "wall_s": e.wall,
                    **({"attrs": e.attrs} if e.attrs else {}),
                }
            )
        )
    for name, v in sorted(tel.counters.items()):
        lines.append(json.dumps({"type": "counter", "name": name, "value": v}))
    for name, v in sorted(tel.gauges.items()):
        lines.append(json.dumps({"type": "gauge", "name": name, "value": v}))
    pathlib.Path(path).write_text("\n".join(lines) + ("\n" if lines else ""))


def write_chrome_trace(tel: "Telemetry", path) -> None:
    """Write the Chrome ``trace_event`` JSON for timeline viewing.

    Wall-clock spans land on pid 1 ("wall clock"); simulation-time events
    land on pid 2 ("simulation") with one microsecond per simulated second,
    so a 30-day campaign reads as a ~2.6 s timeline next to the real run.
    """
    events: list[dict] = [
        {"ph": "M", "pid": 1, "name": "process_name", "args": {"name": "wall clock"}},
        {"ph": "M", "pid": 2, "name": "process_name", "args": {"name": "simulation (1us = 1s)"}},
    ]
    for _, s in _span_rows(tel):
        events.append(
            {
                "name": s.name,
                "ph": "X",
                "pid": 1,
                "tid": 1,
                "ts": s.t0 * 1e6,  # trace_event timestamps are microseconds
                "dur": s.dur * 1e6,
                "args": {k: _jsonable(v) for k, v in s.attrs.items()},
            }
        )
    for e in tel.events:
        events.append(
            {
                "name": e.name,
                "ph": "i",
                "s": "p",
                "pid": 2,
                "tid": 1,
                "ts": e.t,  # 1 us of timeline per simulated second
                "args": {"sim_t_s": e.t, **{k: _jsonable(v) for k, v in e.attrs.items()}},
            }
        )
    for name, v in sorted(tel.counters.items()):
        events.append(
            {"name": name, "ph": "C", "pid": 1, "tid": 1, "ts": 0, "args": {name: v}}
        )
    payload = {"traceEvents": events, "displayTimeUnit": "ms"}
    pathlib.Path(path).write_text(json.dumps(payload, indent=1) + "\n")


def _jsonable(v):
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


def summary_table(tel: "Telemetry") -> str:
    """Aggregate roll-up: span wall totals by name, then counters, gauges."""
    agg: dict[str, tuple[int, float]] = {}
    for s in tel.iter_spans():
        n, total = agg.get(s.name, (0, 0.0))
        agg[s.name] = (n + 1, total + s.dur)
    lines = []
    if agg:
        lines.append(f"{'span':<28} {'calls':>7} {'total_s':>10} {'mean_ms':>10}")
        for name, (n, total) in sorted(agg.items(), key=lambda kv: -kv[1][1]):
            lines.append(f"{name:<28} {n:>7d} {total:>10.4f} {1e3 * total / n:>10.2f}")
    if tel.events:
        kinds: dict[str, int] = {}
        for e in tel.events:
            kinds[e.name] = kinds.get(e.name, 0) + 1
        lines.append("")
        lines.append(f"{'event':<28} {'count':>7}")
        for name, n in sorted(kinds.items()):
            lines.append(f"{name:<28} {n:>7d}")
    if tel.counters:
        lines.append("")
        lines.append(f"{'counter':<28} {'value':>12}")
        for name, v in sorted(tel.counters.items()):
            lines.append(f"{name:<28} {v:>12g}")
    if tel.gauges:
        lines.append("")
        lines.append(f"{'gauge':<28} {'value':>12}")
        for name, v in sorted(tel.gauges.items()):
            lines.append(f"{name:<28} {v:>12g}")
    return "\n".join(lines)
