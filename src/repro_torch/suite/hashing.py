"""Content-addressed run keys: canonical scenario hashes.

The port's copy of :mod:`repro.suite.hashing`: the same canonical JSON and
the same keys, so a scenario of either package that describes the same
study has the same :func:`scenario_hash`, and a store written by either
package keys its runs alike.

The run store (:mod:`repro_torch.suite.store`) is keyed by *what was simulated*,
never by when or by whom: the key is the sha256 of the canonical JSON form
of the materialized scenario (:meth:`repro_torch.engine.scenario.Scenario.canonical`
— field-order independent, numerically normalized, traces as content
digests) combined with the engine id and the store schema version.  Two
suite files that expand to the same frozen scenario collide on the same key
— which is the point: re-running an identical cell is a cache hit that
performs zero simulation.

``SCHEMA_VERSION`` is bumped whenever the meaning of a stored payload
changes (new result fields, changed billing semantics, ...); old entries
then simply stop matching and re-simulate on demand instead of being
silently misread.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any

__all__ = ["SCHEMA_VERSION", "canonical_json", "run_key", "scenario_hash"]

#: Version of the (canonical form, payload layout) pair.  Part of every run
#: key: bumping it invalidates the whole store without deleting anything.
SCHEMA_VERSION = 1


def canonical_json(obj: Any) -> str:
    """Deterministic JSON: sorted keys, no whitespace, exact float repr."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"), allow_nan=True)


def _canonical(scenario: Any) -> dict:
    """Accept a Scenario/FleetScenario or an already-canonical dict."""
    if isinstance(scenario, dict):
        return scenario
    return scenario.canonical()


def scenario_hash(scenario: Any) -> str:
    """sha256 of the scenario's canonical form (engine-independent).

    This is the identity the trend view groups by: the same simulated world
    across git history, whatever backend or code version evaluated it.
    """
    return hashlib.sha256(canonical_json(_canonical(scenario)).encode()).hexdigest()


def run_key(scenario: Any, engine: str, schema_version: int = SCHEMA_VERSION) -> str:
    """The store key: scenario content + engine id + payload schema version."""
    payload = {
        "scenario": _canonical(scenario),
        "engine": str(engine),
        "schema_version": int(schema_version),
    }
    return hashlib.sha256(canonical_json(payload).encode()).hexdigest()
