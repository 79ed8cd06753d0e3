"""Trend view: metric drift per scenario hash across git history.

The port's copy of :mod:`repro.suite.trend`.

The run store accumulates runs of the *same* scenario content produced at
different commits (a re-run only happens when the schema version or engine
id changes the key, or the store was produced on another sha before the
cell was cached — plus explicit ``--rerun``-style invalidations by bumping
:data:`repro_torch.suite.hashing.SCHEMA_VERSION`).  :func:`compute_trends` groups
the index by ``(scenario_hash, engine)``, orders each group by creation
time, and reports how every summary metric moved between the first and the
latest run — with the git shas involved, and, where
``BENCH_history.jsonl`` (written by ``benchmarks/engine_bench.py``) has an
entry for those shas, the backend speedups measured at the same commit.
That joins *what the simulation says* with *how fast the backends ran it*
per sha: a metric drift with an unchanged bench points at semantics, a
bench regression with unchanged metrics at performance.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import pathlib
from typing import Any, Mapping, Sequence

from repro_torch.suite.store import RunRecord, RunStore

__all__ = ["TrendGroup", "compute_trends", "load_bench_history", "render_trends", "trend_report"]

log = logging.getLogger("repro_torch.suite.trend")

DEFAULT_HISTORY = "BENCH_history.jsonl"


def load_bench_history(path: str | pathlib.Path = DEFAULT_HISTORY) -> dict[str, dict]:
    """``sha -> bench record`` from BENCH_history.jsonl (last run per sha wins)."""
    p = pathlib.Path(path)
    out: dict[str, dict] = {}
    if not p.exists():
        return out
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            row = json.loads(line)
        except json.JSONDecodeError:
            log.warning("skipping malformed bench history line: %.80s", line)
            continue
        if row.get("sha"):
            out[row["sha"]] = row
    return out


def _speedups(bench: Mapping[str, Any] | None) -> dict[str, float]:
    if not bench:
        return {}
    return {
        name: entry["speedup"]
        for name, entry in bench.get("backends", {}).items()
        if entry.get("speedup") is not None
    }


@dataclasses.dataclass(frozen=True)
class TrendGroup:
    """All stored runs of one (scenario content, engine) identity."""

    scenario_hash: str
    engine: str
    kind: str
    suite: str | None  # most recent non-null suite label
    runs: tuple[RunRecord, ...]  # ordered oldest -> newest

    @property
    def shas(self) -> list[str | None]:
        return [r.sha for r in self.runs]

    @property
    def first(self) -> RunRecord:
        return self.runs[0]

    @property
    def last(self) -> RunRecord:
        return self.runs[-1]

    def drift(self) -> dict[str, tuple[float, float, float]]:
        """Per-metric ``(first, last, delta)`` between oldest and newest run."""
        out: dict[str, tuple[float, float, float]] = {}
        for name, last_v in self.last.metrics.items():
            first_v = self.first.metrics.get(name)
            if first_v is None:
                continue
            delta = last_v - first_v
            if math.isnan(last_v) and math.isnan(first_v):
                delta = 0.0
            out[name] = (first_v, last_v, delta)
        return out

    def bench_join(self, bench_by_sha: Mapping[str, dict]) -> dict[str, dict[str, float]]:
        """Backend speedups measured at this group's first/last shas."""
        out = {}
        for which, rec in (("first", self.first), ("last", self.last)):
            sp = _speedups(bench_by_sha.get(rec.sha or ""))
            if sp:
                out[which] = sp
        return out


def compute_trends(
    records: Sequence[RunRecord], bench_by_sha: Mapping[str, dict] | None = None
) -> list[TrendGroup]:
    """Group index records by scenario identity, oldest-first within groups."""
    groups: dict[tuple[str, str], list[RunRecord]] = {}
    for rec in sorted(records, key=lambda r: r.created_at):
        groups.setdefault((rec.scenario_hash, rec.engine), []).append(rec)
    out = []
    for (shash, engine), runs in sorted(groups.items()):
        suite = next((r.suite for r in reversed(runs) if r.suite), None)
        out.append(
            TrendGroup(
                scenario_hash=shash,
                engine=engine,
                kind=runs[-1].kind,
                suite=suite,
                runs=tuple(runs),
            )
        )
    return out


def _fmt_delta(first: float, last: float, delta: float) -> str:
    if math.isnan(delta):
        return "nan"
    if delta == 0.0:
        return "unchanged"
    pct = f" ({delta / first:+.2%})" if first and not math.isnan(first) else ""
    return f"{first:.4g} -> {last:.4g}{pct}"


def render_trends(
    groups: Sequence[TrendGroup], bench_by_sha: Mapping[str, dict] | None = None
) -> str:
    """Plain-text trend report (one block per scenario identity)."""
    bench_by_sha = bench_by_sha or {}
    if not groups:
        return "# trend: empty run store"
    lines = [f"# trend: {len(groups)} scenario identities"]
    for g in groups:
        label = f" suite={g.suite}" if g.suite else ""
        lines.append(
            f"{g.scenario_hash[:12]} engine={g.engine} kind={g.kind}{label} "
            f"runs={len(g.runs)} shas={[s[:9] if s else None for s in dict.fromkeys(g.shas)]}"
        )
        if len(g.runs) < 2:
            lines.append("    single run — no drift to report")
        else:
            for name, (first, last, delta) in sorted(g.drift().items()):
                lines.append(f"    {name:<18} {_fmt_delta(first, last, delta)}")
        joined = g.bench_join(bench_by_sha)
        for which, speedups in joined.items():
            sp = "  ".join(f"{k}={v:.1f}x" for k, v in sorted(speedups.items()))
            lines.append(f"    bench@{which:<5} {sp}")
    return "\n".join(lines)


def trend_report(
    store: RunStore, history_path: str | pathlib.Path = DEFAULT_HISTORY
) -> str:
    """The ``python -m repro_torch.suite trend`` surface: store index x bench history."""
    bench = load_bench_history(history_path)
    return render_trends(compute_trends(store.records(), bench), bench)
