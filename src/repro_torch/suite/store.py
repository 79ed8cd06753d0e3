"""Content-addressed run store: JSONL index + per-run npz payloads.

The port's copy of :mod:`repro.suite.store`, in the JAX package's format:
the same index lines, the same npz entries, the same sha256 integrity, so
``verify --parity`` compares a store of either package with one of the
other bit for bit on the runs they share.

Layout (default root ``results/store/``, gitignored)::

    results/store/
      index.jsonl          # one RunRecord per line, append-only
      runs/<run_key>.npz   # the result payload, one file per run

The index is the queryable surface — every line carries the run key, the
scenario content hash, engine id, schema version, git sha, creation time,
wall time, and a small summary-metrics dict — so listing and trend analysis
never open a payload.  Payloads are plain ``npz`` archives (structure-of-
arrays outcome grids for :class:`~repro_torch.engine.base.EngineResult`, per-cell
attempt-record columns for fleet grids, SLO/price grids for
:class:`~repro_torch.serving.ServingResult`) with one JSON header entry; floats
ride either in float64 arrays or through JSON's exact shortest-round-trip
repr, so a store round trip is bit-for-bit.

Crash safety: the payload is written to a temp file and renamed, and the
index line is appended (and flushed) only afterwards — an interrupted run
leaves either a complete entry or no entry, never a torn one.  Re-appending
the same key later simply supersedes the older line (last wins on load);
:meth:`RunStore.gc` compacts superseded lines away and deletes payload
files nothing references (``python -m repro_torch.suite gc``).

Integrity: every payload's sha256 is computed over the exact bytes the
record describes and stored in the index line, so a torn write, bit rot, or
a foreign file under ``runs/`` is *detected* rather than surfacing as a raw
``zipfile.BadZipFile`` three layers up: :meth:`RunStore.load` verifies the
checksum (and wraps every decode failure) into a typed
:class:`StoreCorruptionError` carrying the run key and payload path, and
:meth:`RunStore.verify` sweeps the whole store — with ``repair=True``
quarantining corrupt entries under ``quarantine/`` and dropping their index
lines so the next ``run`` simply re-simulates them (``python -m
repro_torch.suite verify [--repair]``).  The fault-injection sites
``store.payload_write`` (raise | torn) and ``store.index_append`` (raise)
of :mod:`repro_torch.faults` live on this module's write path (registered
here).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
import os
import pathlib
import subprocess
import time
import zipfile
from typing import Any, Mapping

import numpy as np

from repro_torch import faults
from repro_torch.core.billing import Termination
from repro_torch.core.provision import SLA
from repro_torch.core.schemes import Scheme
from repro_torch.engine.base import EngineResult, PhaseTimings, SchemePhases
from repro_torch.engine.fleetgrid import FleetGridResult
from repro_torch.engine.scenario import FleetScenario, MarketCell, Scenario
from repro_torch.fleet.controller import AttemptRecord, FleetResult, JobOutcome
from repro_torch.fleet.sweep import SweepCell
from repro_torch.fleet.workload import Job
from repro_torch.obs import telemetry as obs
from repro_torch.serving import ServingResult, ServingScenario
from repro_torch.suite.hashing import SCHEMA_VERSION, run_key, scenario_hash

__all__ = [
    "GcStats",
    "RunRecord",
    "RunStore",
    "StoreCorruptionError",
    "VerifyStats",
    "DEFAULT_ROOT",
]

DEFAULT_ROOT = "results/store"

faults.register_site("store.payload_write", "one hit per RunStore payload flush (raise | torn)")
faults.register_site("store.index_append", "one hit per index line append (raise)")

#: Header keys that legitimately differ between two runs of the same cell
#: (wall-clock measurements); payload parity ignores them.
_VOLATILE_HEADER_KEYS = ("wall_s", "timings")


class StoreCorruptionError(RuntimeError):
    """A stored payload failed its checksum or could not be decoded.

    Carries the run key and payload path so callers (and the
    ``verify`` workflow) can quarantine the exact entry instead
    of crashing on a raw ``zipfile.BadZipFile``/``KeyError``.
    """

    def __init__(self, run_key: str, payload: "pathlib.Path | str", reason: str):
        self.run_key = run_key
        self.payload = str(payload)
        self.reason = reason
        super().__init__(f"corrupt run {run_key} ({self.payload}): {reason}")


def _git_sha() -> str | None:
    """Current commit sha, or None outside a usable git checkout."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=10
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


@dataclasses.dataclass(frozen=True)
class RunRecord:
    """One index line: everything about a run except its bulk payload."""

    run_key: str
    scenario_hash: str
    engine: str
    schema_version: int
    kind: str  # "scenario" | "fleet" | "serving"
    created_at: float  # unix seconds
    sha: str | None  # git commit the run was produced at
    payload: str  # path relative to the store root
    wall_s: float
    n_cells: int
    metrics: dict[str, float]
    suite: str | None = None
    cell: str | None = None
    sha256: str | None = None  # checksum of the payload bytes (None: pre-checksum record)

    def asdict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "RunRecord":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclasses.dataclass(frozen=True)
class GcStats:
    """What :meth:`RunStore.gc` reclaimed (or would reclaim, on a dry run)."""

    index_lines_before: int
    index_lines_after: int
    index_bytes_reclaimed: int
    payloads_deleted: list[str]  # store-relative paths
    payload_bytes_reclaimed: int
    dry_run: bool

    @property
    def bytes_reclaimed(self) -> int:
        return self.index_bytes_reclaimed + self.payload_bytes_reclaimed

    def summary(self) -> str:
        verb = "would reclaim" if self.dry_run else "reclaimed"
        return (
            f"index: {self.index_lines_before} -> {self.index_lines_after} lines; "
            f"{len(self.payloads_deleted)} orphaned payloads; "
            f"{verb} {self.bytes_reclaimed} bytes"
        )


@dataclasses.dataclass(frozen=True)
class VerifyStats:
    """What :meth:`RunStore.verify` found (and, with ``repair``, moved)."""

    n_records: int
    n_ok: int
    n_unchecksummed: int  # pre-checksum index lines: decode-checked only when deep
    corrupt: list[tuple[str, str]]  # (run_key, reason)
    quarantined: list[str]  # store-relative paths moved under quarantine/
    repaired: bool
    deep: bool

    @property
    def ok(self) -> bool:
        return not self.corrupt

    def summary(self) -> str:
        mode = "deep" if self.deep else "checksum"
        head = (
            f"{self.n_records} records ({mode} verify): {self.n_ok} ok, "
            f"{len(self.corrupt)} corrupt"
        )
        if self.n_unchecksummed:
            head += f", {self.n_unchecksummed} without checksums"
        if self.repaired:
            head += f"; quarantined {len(self.quarantined)} payloads"
        return head


class RunStore:
    """A persistent, content-addressed database of simulation runs."""

    def __init__(self, root: str | pathlib.Path = DEFAULT_ROOT):
        self.root = pathlib.Path(root)
        self.index_path = self.root / "index.jsonl"
        self.runs_dir = self.root / "runs"
        self.quarantine_dir = self.root / "quarantine"
        self._records: dict[str, RunRecord] = {}
        self._sha: str | None | bool = False  # False = not yet resolved
        self.reload()

    # -- index --------------------------------------------------------------

    def reload(self) -> None:
        """Re-read the index from disk (last line wins per key)."""
        self._records = {}
        if not self.index_path.exists():
            return
        for line in self.index_path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = RunRecord.from_dict(json.loads(line))
            except (json.JSONDecodeError, TypeError):
                continue  # torn/foreign line: ignorable, the payload re-runs
            self._records[rec.run_key] = rec

    def records(self) -> list[RunRecord]:
        """All index entries, oldest first."""
        return sorted(self._records.values(), key=lambda r: r.created_at)

    def get(self, key: str) -> RunRecord | None:
        return self._records.get(key)

    def has(self, key: str) -> bool:
        """True when the key is indexed *and* its payload file exists."""
        rec = self._records.get(key)
        return rec is not None and (self.root / rec.payload).exists()

    def __contains__(self, key: str) -> bool:
        return self.has(key)

    def __len__(self) -> int:
        return len(self._records)

    def _resolve_sha(self, sha: str | None) -> str | None:
        if sha is not None:
            return sha
        if self._sha is False:
            self._sha = _git_sha()
        return self._sha

    def _flush(self, rec: RunRecord, payload: dict[str, np.ndarray]) -> RunRecord:
        """Write payload-then-index (the interrupt-safety order).

        The payload is serialized in memory first so the index line's sha256
        describes the *intended* bytes — a write torn between serialization
        and disk (crash, or the ``store.payload_write`` fault site) is then
        detectable by :meth:`load`/:meth:`verify` instead of silent.
        """
        self.runs_dir.mkdir(parents=True, exist_ok=True)
        buf = io.BytesIO()
        np.savez_compressed(buf, **payload)
        data = buf.getvalue()
        rec = dataclasses.replace(rec, sha256=hashlib.sha256(data).hexdigest())
        final = self.root / rec.payload
        tmp = final.with_suffix(".tmp.npz")
        action = faults.current().fire("store.payload_write", key=rec.run_key)
        if action is not None and action.kind == "raise":
            # crash mid-write: a stale tmp file is left behind (gc's problem),
            # the final payload and the index are untouched
            tmp.write_bytes(data[: len(data) // 2])
            raise faults.InjectedFault(action)
        if action is not None and action.kind == "torn":
            # torn write the OS never reported: the commit completes but the
            # payload on disk is truncated — only the checksum can tell
            tmp.write_bytes(data[: len(data) // 2])
        else:
            tmp.write_bytes(data)
        os.replace(tmp, final)
        faults.current().check("store.index_append", key=rec.run_key)
        with self.index_path.open("a") as f:
            f.write(json.dumps(rec.asdict()) + "\n")
            f.flush()
        self._records[rec.run_key] = rec
        return rec

    # -- maintenance --------------------------------------------------------

    def gc(self, *, dry_run: bool = False) -> "GcStats":
        """Compact the index and delete orphaned payloads.

        The append-only index accumulates one superseded line per re-run of
        a key, and a superseded payload (or a run whose index append was
        interrupted) leaves an ``npz`` nothing references.  ``gc`` rewrites
        the index with only the surviving record per key (oldest first, via
        tmp-file + ``os.replace`` so a crash leaves the old or the new index,
        never a torn one) and unlinks every file under ``runs/`` no surviving
        record points to — including stale ``.tmp.npz`` leftovers.

        ``dry_run=True`` reports what would be reclaimed without touching
        disk.  Returns :class:`GcStats`.
        """
        self.reload()
        lines_before = 0
        index_bytes_before = 0
        if self.index_path.exists():
            text = self.index_path.read_text()
            index_bytes_before = len(text.encode())
            lines_before = sum(1 for ln in text.splitlines() if ln.strip())
        recs = self.records()
        new_text = "".join(json.dumps(r.asdict()) + "\n" for r in recs)
        referenced = {(self.root / r.payload).resolve() for r in recs}
        orphans = []
        if self.runs_dir.is_dir():
            orphans = sorted(
                p for p in self.runs_dir.glob("*.npz") if p.resolve() not in referenced
            )
        payload_bytes = sum(p.stat().st_size for p in orphans)
        if not dry_run:
            if self.index_path.exists():
                tmp = self.index_path.with_suffix(".jsonl.tmp")
                tmp.write_text(new_text)
                os.replace(tmp, self.index_path)
            for p in orphans:
                p.unlink()
        return GcStats(
            index_lines_before=lines_before,
            index_lines_after=len(recs),
            index_bytes_reclaimed=index_bytes_before - len(new_text.encode()),
            payloads_deleted=[str(p.relative_to(self.root)) for p in orphans],
            payload_bytes_reclaimed=payload_bytes,
            dry_run=dry_run,
        )

    # -- put ----------------------------------------------------------------

    def put_engine_result(
        self,
        scenario: Scenario,
        result: EngineResult,
        *,
        engine: str | None = None,
        suite: str | None = None,
        cell: str | None = None,
        sha: str | None = None,
    ) -> RunRecord:
        """Persist one single-scenario run; returns its index record."""
        engine = engine or result.engine
        key = run_key(scenario, engine)
        rec = RunRecord(
            run_key=key,
            scenario_hash=scenario_hash(scenario),
            engine=engine,
            schema_version=SCHEMA_VERSION,
            kind="scenario",
            created_at=time.time(),
            sha=self._resolve_sha(sha),
            payload=f"runs/{key}.npz",
            wall_s=float(result.wall_s),
            n_cells=result.n_cells,
            metrics=_engine_metrics(result),
            suite=suite,
            cell=cell,
        )
        return self._flush(rec, _pack_engine_result(scenario, result))

    def put_fleet_result(
        self,
        scenario: FleetScenario,
        grid: FleetGridResult,
        *,
        suite: str | None = None,
        cell: str | None = None,
        sha: str | None = None,
    ) -> RunRecord:
        """Persist one fleet-grid run (engine id ``"fleet"``: the host
        controller's results, as the JAX package keys them)."""
        key = run_key(scenario, "fleet")
        rec = RunRecord(
            run_key=key,
            scenario_hash=scenario_hash(scenario),
            engine="fleet",
            schema_version=SCHEMA_VERSION,
            kind="fleet",
            created_at=time.time(),
            sha=self._resolve_sha(sha),
            payload=f"runs/{key}.npz",
            wall_s=float(grid.wall_s),
            n_cells=len(grid.cells),
            metrics=_fleet_metrics(grid),
            suite=suite,
            cell=cell,
        )
        return self._flush(rec, _pack_fleet_grid(scenario, grid))

    def put_serving_result(
        self,
        scenario: ServingScenario,
        result: ServingResult,
        *,
        engine: str | None = None,
        suite: str | None = None,
        cell: str | None = None,
        sha: str | None = None,
    ) -> RunRecord:
        """Persist one serving-grid run; returns its index record."""
        engine = engine or result.engine
        key = run_key(scenario, engine)
        rec = RunRecord(
            run_key=key,
            scenario_hash=scenario_hash(scenario),
            engine=engine,
            schema_version=SCHEMA_VERSION,
            kind="serving",
            created_at=time.time(),
            sha=self._resolve_sha(sha),
            payload=f"runs/{key}.npz",
            wall_s=float(result.wall_s),
            n_cells=result.n_cells,
            metrics=_serving_metrics(result),
            suite=suite,
            cell=cell,
        )
        return self._flush(rec, _pack_serving_result(scenario, result))

    # -- load ---------------------------------------------------------------

    def load(
        self,
        record_or_key: RunRecord | str,
        scenario: Scenario | FleetScenario | None = None,
    ) -> EngineResult | FleetGridResult:
        """Reconstruct a stored result.

        Pass the materialized ``scenario`` when you have it (the runner
        does) to get it attached to the result; without it the result's
        ``scenario`` is ``None`` and market cells carry no trace — the
        outcome arrays and metadata are complete either way.  Engine-result
        payloads store the SoA grid only: per-run ``sim_results`` lists (a
        reference-engine debugging aid) are not persisted.
        """
        rec = record_or_key if isinstance(record_or_key, RunRecord) else self._records[record_or_key]
        data = self._read_verified(rec)
        try:
            with np.load(io.BytesIO(data)) as z:
                if rec.kind == "fleet":
                    return _unpack_fleet_grid(z, scenario)
                if rec.kind == "serving":
                    return _unpack_serving_result(z)
                return _unpack_engine_result(z, scenario)
        except (zipfile.BadZipFile, KeyError, ValueError, EOFError, OSError,
                json.JSONDecodeError) as e:
            raise StoreCorruptionError(
                rec.run_key, self.root / rec.payload, f"undecodable payload: {e!r}"
            ) from e

    def _read_verified(self, rec: RunRecord) -> bytes:
        """The payload bytes, checksum-verified when the record carries one."""
        path = self.root / rec.payload
        try:
            data = path.read_bytes()
        except OSError as e:
            raise StoreCorruptionError(rec.run_key, path, f"unreadable payload: {e}") from e
        if rec.sha256 is not None:
            got = hashlib.sha256(data).hexdigest()
            if got != rec.sha256:
                raise StoreCorruptionError(
                    rec.run_key, path,
                    f"checksum mismatch: index has {rec.sha256[:12]}…, payload is {got[:12]}…",
                )
        return data

    # -- verify / repair -----------------------------------------------------

    def verify(self, *, repair: bool = False, deep: bool = False) -> VerifyStats:
        """Sweep every indexed record for corruption.

        The default pass checks payload existence and sha256 (fast: no
        decode); ``deep=True`` additionally decodes every payload through the
        full codec.  With ``repair=True`` each corrupt entry is *quarantined*
        instead of left to crash a future load: its payload (when present)
        moves to ``quarantine/<run_key>.npz`` and its index line is dropped
        (tmp-file + ``os.replace``, same crash-safety as :meth:`gc`), so the
        next suite pass treats the cell as missing and re-simulates it.
        Counts ``store.quarantined`` per quarantined entry.
        """
        self.reload()
        n_records = len(self._records)
        corrupt: list[tuple[str, str]] = []
        quarantined: list[str] = []
        n_unchecksummed = 0
        for rec in self.records():
            n_unchecksummed += rec.sha256 is None
            try:
                data = self._read_verified(rec)
                if deep:
                    with np.load(io.BytesIO(data)) as z:
                        if rec.kind == "fleet":
                            _unpack_fleet_grid(z, None)
                        elif rec.kind == "serving":
                            _unpack_serving_result(z)
                        else:
                            _unpack_engine_result(z, None)
            except StoreCorruptionError as e:
                corrupt.append((rec.run_key, e.reason))
            except (zipfile.BadZipFile, KeyError, ValueError, EOFError, OSError,
                    json.JSONDecodeError) as e:
                corrupt.append((rec.run_key, f"undecodable payload: {e!r}"))
        if repair and corrupt:
            tel = obs.current()
            bad_keys = {k for k, _ in corrupt}
            for key in sorted(bad_keys):
                rec = self._records[key]
                src = self.root / rec.payload
                if src.exists():
                    self.quarantine_dir.mkdir(parents=True, exist_ok=True)
                    dst = self.quarantine_dir / f"{rec.run_key}.npz"
                    os.replace(src, dst)
                    quarantined.append(str(dst.relative_to(self.root)))
                tel.count("store.quarantined")
                del self._records[key]
            survivors = "".join(json.dumps(r.asdict()) + "\n" for r in self.records())
            tmp = self.index_path.with_suffix(".jsonl.tmp")
            tmp.write_text(survivors)
            os.replace(tmp, self.index_path)
        return VerifyStats(
            n_records=n_records,
            n_ok=n_records - len(corrupt),
            n_unchecksummed=n_unchecksummed,
            corrupt=corrupt,
            quarantined=quarantined,
            repaired=repair,
            deep=deep,
        )

    # -- parity --------------------------------------------------------------

    def parity(self, other: "RunStore") -> dict[str, str]:
        """Bitwise payload comparison against ``other`` on the shared keys.

        Returns ``{run_key: reason}`` for every divergence (empty = parity).
        Array entries must match bit for bit; the JSON header is compared
        after dropping wall-clock fields (``wall_s``, ``timings``, per-cell
        ``wall_s``) that legitimately differ between runs.  The chaos CI job
        uses this to assert a faulted-then-repaired store converges to the
        never-faulted baseline.
        """
        mismatches: dict[str, str] = {}
        shared = sorted(set(self._records) & set(other._records))
        for key in shared:
            try:
                mine = dict(np.load(io.BytesIO(self._read_verified(self._records[key]))))
                theirs = dict(np.load(io.BytesIO(other._read_verified(other._records[key]))))
            except StoreCorruptionError as e:
                mismatches[key] = f"corrupt: {e.reason}"
                continue
            if set(mine) != set(theirs):
                mismatches[key] = (
                    f"entry sets differ: {sorted(set(mine) ^ set(theirs))}"
                )
                continue
            for name in sorted(mine):
                if name == "header":
                    if _comparable_header(mine[name]) != _comparable_header(theirs[name]):
                        mismatches[key] = "header differs beyond wall-clock fields"
                        break
                elif not np.array_equal(mine[name], theirs[name]):
                    mismatches[key] = f"array {name!r} differs"
                    break
        return mismatches


def _comparable_header(header_entry: np.ndarray) -> dict:
    """A payload header with wall-clock fields stripped, for parity checks."""
    header = json.loads(str(header_entry[()]))
    for key in _VOLATILE_HEADER_KEYS:
        header.pop(key, None)
    for cell in header.get("cells", []):  # fleet SweepCells carry wall_s too
        if isinstance(cell, dict):
            cell.pop("wall_s", None)
    return header


# ---------------------------------------------------------------------------
# Summary metrics (index-row payload: the trend view reads only these)
# ---------------------------------------------------------------------------


def _engine_metrics(res: EngineResult) -> dict[str, float]:
    done = res.completed.astype(bool)
    mean_cost = float(np.mean(res.cost[done])) if done.any() else math.nan
    mean_time_h = float(np.mean(res.completion_time[done]) / 3600.0) if done.any() else math.nan
    return {
        "completion_rate": float(done.mean()),
        "mean_cost": mean_cost,
        "mean_completion_h": mean_time_h,
        "total_kills": float(res.n_kills.sum()),
        "total_checkpoints": float(res.n_checkpoints.sum()),
    }


def _fleet_metrics(grid: FleetGridResult) -> dict[str, float]:
    cells = grid.cells
    if not cells:
        return {"mean_total_cost": math.nan, "mean_kill_rate": math.nan, "completion_rate": math.nan}
    n_jobs = sum(c.n_jobs for c in cells)
    return {
        "mean_total_cost": float(np.mean([c.total_cost for c in cells])),
        "mean_kill_rate": float(np.mean([c.kill_rate for c in cells])),
        "completion_rate": sum(c.n_completed for c in cells) / max(1, n_jobs),
        "mean_migrations": float(np.mean([c.n_migrations for c in cells])),
    }


def _serving_metrics(res: ServingResult) -> dict[str, float]:
    with np.errstate(invalid="ignore"):
        finite_cost = res.cost_per_mreq[np.isfinite(res.cost_per_mreq)]
    return {
        "mean_availability": float(res.availability.mean()),
        "mean_slo_violation_s": float(res.slo_violation_s.mean()),
        "mean_cost_per_mreq": float(finite_cost.mean()) if finite_cost.size else math.nan,
        "total_preempted": float(res.n_preempted.sum()),
        "total_boot_lost": float(res.n_boot_lost.sum()),
    }


# ---------------------------------------------------------------------------
# Engine-result codec
# ---------------------------------------------------------------------------

_ENGINE_ARRAYS = (
    "completed",
    "completion_time",
    "cost",
    "n_checkpoints",
    "n_kills",
    "n_self_terminations",
    "work_lost_s",
)


def _pack_engine_result(scenario: Scenario, res: EngineResult) -> dict[str, np.ndarray]:
    header = {
        "engine": res.engine,
        "wall_s": res.wall_s,
        "bids": [float(b) for b in res.bids],
        "schemes": [s.value for s in res.schemes],
        "markets": [
            {"label": m.label, "seed": int(m.seed), "on_demand": float(m.on_demand)}
            for m in res.markets
        ],
        "timings": _timings_dict(res.timings) if res.timings is not None else None,
        "scenario": scenario.canonical(),
    }
    out = {name: getattr(res, name) for name in _ENGINE_ARRAYS}
    out["header"] = np.array(json.dumps(header))
    return out


def _timings_dict(t: PhaseTimings) -> dict:
    d = dataclasses.asdict(t)
    d["per_scheme"] = {k: dataclasses.asdict(v) for k, v in t.per_scheme.items()}
    return d


def _known(cls, d: Mapping[str, Any]) -> dict:
    """The entries of ``d`` that are fields of ``cls`` (the JAX package's
    timings carry phases the port's record does not have)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _unpack_engine_result(z, scenario: Scenario | None) -> EngineResult:
    header = json.loads(str(z["header"][()]))
    timings = None
    if header["timings"] is not None:
        t = _known(PhaseTimings, header["timings"])
        t["per_scheme"] = {k: SchemePhases(**_known(SchemePhases, v)) for k, v in t["per_scheme"].items()}
        timings = PhaseTimings(**t)
    return EngineResult(
        scenario=scenario,
        engine=str(header["engine"]),
        markets=[
            MarketCell(m["label"], int(m["seed"]), None, float(m["on_demand"]))
            for m in header["markets"]
        ],
        bids=tuple(float(b) for b in header["bids"]),
        schemes=tuple(Scheme(s) for s in header["schemes"]),
        wall_s=float(header["wall_s"]),
        timings=timings,
        **{name: z[name] for name in _ENGINE_ARRAYS},
    )


# ---------------------------------------------------------------------------
# Serving-result codec
# ---------------------------------------------------------------------------

_SERVING_ARRAYS = (
    "availability",
    "p99_latency_s",
    "slo_violation_s",
    "cost",
    "served_requests",
    "offered_requests",
    "cost_per_mreq",
    "n_preempted",
    "n_scale_out",
    "n_scale_in",
    "n_boot_lost",
    "capacity_rps",
    "spot_price",
    "rates",
)


def _pack_serving_result(scenario: ServingScenario, res: ServingResult) -> dict[str, np.ndarray]:
    header = {
        "engine": res.engine,
        "wall_s": res.wall_s,
        "policies": [str(p) for p in res.policies],
        "bid_margins": [float(m) for m in res.bid_margins],
        "seeds": [int(s) for s in res.seeds],
        "spot_types": [str(t) for t in res.spot_types],
        "scenario": scenario.canonical(),
    }
    out = {name: getattr(res, name) for name in _SERVING_ARRAYS}
    out["header"] = np.array(json.dumps(header))
    return out


def _unpack_serving_result(z) -> ServingResult:
    header = json.loads(str(z["header"][()]))
    return ServingResult(
        policies=tuple(str(p) for p in header["policies"]),
        bid_margins=tuple(float(m) for m in header["bid_margins"]),
        seeds=tuple(int(s) for s in header["seeds"]),
        spot_types=tuple(str(t) for t in header["spot_types"]),
        engine=str(header["engine"]),
        wall_s=float(header["wall_s"]),
        **{name: z[name] for name in _SERVING_ARRAYS},
    )


# ---------------------------------------------------------------------------
# Fleet-grid codec
# ---------------------------------------------------------------------------

_RECORD_COLUMNS = (
    ("job_id", np.int64),
    ("replica", np.int64),
    ("instance", None),  # unicode
    ("bid", np.float64),
    ("launch", np.float64),
    ("end", np.float64),
    ("termination", None),  # unicode enum value
    ("cost", np.float64),
    ("work_start", np.float64),
    ("initial_saved_ref", np.float64),
    ("saved_after_ref", np.float64),
    ("killed", np.bool_),
    ("completed", np.bool_),
    ("cancelled", np.bool_),
    ("self_terminated", np.bool_),
)


def _str_array(values: list[str]) -> np.ndarray:
    return np.array(values, dtype="U1") if not values else np.array(values)


def _job_dict(job: Job) -> dict:
    return {
        "id": job.id,
        "arrival_s": job.arrival_s,
        "work_s": job.work_s,
        "deadline_s": job.deadline_s,
        "sla": {
            "min_compute_units": job.sla.min_compute_units,
            "regions": list(job.sla.regions),
            "os": job.sla.os,
        },
    }


def _job_from_dict(d: Mapping[str, Any]) -> Job:
    return Job(
        id=int(d["id"]),
        arrival_s=float(d["arrival_s"]),
        work_s=float(d["work_s"]),
        deadline_s=None if d["deadline_s"] is None else float(d["deadline_s"]),
        sla=SLA(
            min_compute_units=float(d["sla"]["min_compute_units"]),
            regions=tuple(d["sla"]["regions"]),
            os=d["sla"]["os"],
        ),
    )


def _pack_fleet_grid(scenario: FleetScenario, grid: FleetGridResult) -> dict[str, np.ndarray]:
    payload: dict[str, np.ndarray] = {}
    results_meta = []
    for i, ((policy, margin, seed), res) in enumerate(sorted(grid.results.items())):
        index_of = {id(r): j for j, r in enumerate(res.records)}
        results_meta.append(
            {
                "key": [policy, margin, seed],
                "policy": res.policy,
                "scheme": res.scheme.value,
                "horizon": res.horizon,
                "outcomes": [
                    {
                        "job": _job_dict(o.job),
                        "completed": o.completed,
                        "completion_time": o.completion_time,
                        "cost": o.cost,
                        "n_kills": o.n_kills,
                        "n_migrations": o.n_migrations,
                        # attempts are shared with the records list: persist
                        # indices so reloading restores the same sharing
                        "attempts": [index_of[id(r)] for r in o.attempts],
                    }
                    for _, o in sorted(res.outcomes.items())
                ],
            }
        )
        for col, dtype in _RECORD_COLUMNS:
            values = [getattr(r, col) for r in res.records]
            if col == "termination":
                payload[f"r{i}_{col}"] = _str_array([v.value for v in values])
            elif dtype is None:
                payload[f"r{i}_{col}"] = _str_array([str(v) for v in values])
            else:
                payload[f"r{i}_{col}"] = np.array(values, dtype=dtype)
    header = {
        "wall_s": grid.wall_s,
        "cells": [dataclasses.asdict(c) for c in grid.cells],
        "results": results_meta,
        "scenario": scenario.canonical(),
    }
    payload["header"] = np.array(json.dumps(header))
    return payload


def _unpack_fleet_grid(z, scenario: FleetScenario | None) -> FleetGridResult:
    header = json.loads(str(z["header"][()]))
    results: dict[tuple[str, float, int], FleetResult] = {}
    for i, meta in enumerate(header["results"]):
        cols = {col: z[f"r{i}_{col}"] for col, _ in _RECORD_COLUMNS}
        n = len(cols["job_id"])
        records = [
            AttemptRecord(
                job_id=int(cols["job_id"][j]),
                replica=int(cols["replica"][j]),
                instance=str(cols["instance"][j]),
                bid=float(cols["bid"][j]),
                launch=float(cols["launch"][j]),
                end=float(cols["end"][j]),
                termination=Termination(str(cols["termination"][j])),
                cost=float(cols["cost"][j]),
                work_start=float(cols["work_start"][j]),
                initial_saved_ref=float(cols["initial_saved_ref"][j]),
                saved_after_ref=float(cols["saved_after_ref"][j]),
                killed=bool(cols["killed"][j]),
                completed=bool(cols["completed"][j]),
                cancelled=bool(cols["cancelled"][j]),
                self_terminated=bool(cols["self_terminated"][j]),
            )
            for j in range(n)
        ]
        outcomes: dict[int, JobOutcome] = {}
        for o in meta["outcomes"]:
            job = _job_from_dict(o["job"])
            outcomes[job.id] = JobOutcome(
                job=job,
                completed=bool(o["completed"]),
                completion_time=float(o["completion_time"]),
                cost=float(o["cost"]),
                n_kills=int(o["n_kills"]),
                n_migrations=int(o["n_migrations"]),
                attempts=[records[j] for j in o["attempts"]],
            )
        policy, margin, seed = meta["key"]
        results[(str(policy), float(margin), int(seed))] = FleetResult(
            policy=str(meta["policy"]),
            scheme=Scheme(meta["scheme"]),
            outcomes=outcomes,
            records=records,
            horizon=float(meta["horizon"]),
        )
    return FleetGridResult(
        scenario=scenario,
        cells=[SweepCell(**c) for c in header["cells"]],
        results=results,
        wall_s=float(header["wall_s"]),
    )
