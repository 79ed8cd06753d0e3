"""Suite control plane: declarative scenario suites over a persistent store.

The port of :mod:`repro.suite`: the orchestration layer above
:mod:`repro_torch.engine`, :func:`repro_torch.engine.run_fleet` and
:func:`repro_torch.serving.run_serving`, in the JAX package's store format
(a store of either package verifies against one of the other with
``verify --parity``).  Four pieces:

  * **specs** (:mod:`repro_torch.suite.spec`, :mod:`repro_torch.suite.layers`) —
    TOML/JSON suite files with layered overrides (``base`` ← ``suite`` ←
    ``cell`` ← ``cli``) and per-field provenance, expanded via axis products
    into frozen :class:`~repro_torch.engine.scenario.Scenario` /
    ``FleetScenario`` / ``ServingScenario`` cells;
  * **content-addressed store** (:mod:`repro_torch.suite.store`,
    :mod:`repro_torch.suite.hashing`) — runs keyed by the sha256 of the canonical
    scenario form + engine id + schema version; JSONL index + npz payloads
    under ``results/store/``; re-running an identical cell is a cache hit
    that performs zero simulation;
  * **resumable runner** (:mod:`repro_torch.suite.runner`) — executes only
    missing cells on the GPU unless ``device="cpu"``, flushes each as it
    completes (interrupt-safe), counts ``suite.cell`` / ``suite.cache_hit``
    / ``suite.cache_miss`` via :mod:`repro_torch.obs`;
  * **trend view** (:mod:`repro_torch.suite.trend`) — metric drift per
    scenario hash across git shas, joined with ``BENCH_history.jsonl``.

CLI: ``python -m repro_torch.suite run|list|gc|verify|trend``.
"""

from repro_torch.suite.hashing import SCHEMA_VERSION, canonical_json, run_key, scenario_hash
from repro_torch.suite.layers import Layer, Resolved, merge_layers, parse_override
from repro_torch.suite.runner import (
    CellOutcome,
    RetryPolicy,
    SuiteReport,
    run_fleet_stored,
    run_serving_stored,
    run_stored,
    run_suite,
)
from repro_torch.suite.spec import Suite, SuiteCell, build_scenario, load_suite
from repro_torch.suite.store import (
    DEFAULT_ROOT,
    GcStats,
    RunRecord,
    RunStore,
    StoreCorruptionError,
    VerifyStats,
)
from repro_torch.suite.trend import compute_trends, load_bench_history, render_trends, trend_report

__all__ = [
    "SCHEMA_VERSION",
    "CellOutcome",
    "DEFAULT_ROOT",
    "GcStats",
    "Layer",
    "Resolved",
    "RetryPolicy",
    "RunRecord",
    "RunStore",
    "StoreCorruptionError",
    "Suite",
    "SuiteCell",
    "SuiteReport",
    "VerifyStats",
    "build_scenario",
    "canonical_json",
    "compute_trends",
    "load_bench_history",
    "load_suite",
    "merge_layers",
    "parse_override",
    "render_trends",
    "run_fleet_stored",
    "run_key",
    "run_serving_stored",
    "run_stored",
    "run_suite",
    "scenario_hash",
    "trend_report",
]
