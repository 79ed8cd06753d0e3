"""Build and trace registry: how often each compiled program was produced.

Every place that compiles something reports it here, keyed by a
``(scope, detail...)`` tuple.  The kernel build
(:mod:`repro_torch.kernels._build`) records one entry per ``nvcc`` build
under scope ``"torch_port.build"``, detail the source digest.  A build is
*expected* once per source digest; a second one for the same digest is an
accidental rebuild.

:func:`retrace_guard` turns that into a loud check::

    with retrace_guard("torch_port.build"):
        repro_torch.engine.run(scenario)   # must reuse the built library

``allow=N`` permits up to ``N`` records (e.g. one expected cold build);
``allow=None`` only observes.  Each record also increments the
``builds`` counter on the active :class:`~repro_torch.obs.telemetry.Telemetry`.
"""

from __future__ import annotations

from typing import Hashable, Iterable

from repro_torch.obs.telemetry import current

__all__ = ["RetraceError", "RetraceGuard", "record_trace", "retrace_guard", "trace_count"]

#: (scope, detail...) -> number of times that program has been produced.
_TRACE_COUNTS: dict[tuple, int] = {}


def _key(scope: str, detail: Iterable[Hashable] | None) -> tuple:
    return (scope,) + (tuple(detail) if detail is not None else ())


def record_trace(scope: str, detail: Iterable[Hashable] | None = None) -> None:
    """Report one build (or trace) of the program ``(scope, detail...)``."""
    key = _key(scope, detail)
    _TRACE_COUNTS[key] = _TRACE_COUNTS.get(key, 0) + 1
    current().count("builds")


def trace_count(scope: str, detail: Iterable[Hashable] | None = None) -> int:
    """Total records for one program, or for a whole scope when ``detail``
    is omitted."""
    if detail is not None:
        return _TRACE_COUNTS.get(_key(scope, detail), 0)
    return sum(v for k, v in _TRACE_COUNTS.items() if k[0] == scope)


def _snapshot(scope: str | None) -> dict[tuple, int]:
    return {k: v for k, v in _TRACE_COUNTS.items() if scope is None or k[0] == scope}


class RetraceError(AssertionError):
    """A guarded region rebuilt a program it should have reused."""


class RetraceGuard:
    """Context manager asserting a bounded number of builds in its extent."""

    def __init__(self, scope: str | None = None, allow: int | None = 0):
        self.scope = scope
        self.allow = allow
        self.new_traces = 0
        self.traced: dict[tuple, int] = {}
        self._before: dict[tuple, int] = {}

    def __enter__(self) -> "RetraceGuard":
        self._before = _snapshot(self.scope)
        return self

    def __exit__(self, exc_type, exc, tb):
        after = _snapshot(self.scope)
        self.traced = {
            k: v - self._before.get(k, 0) for k, v in after.items() if v > self._before.get(k, 0)
        }
        self.new_traces = sum(self.traced.values())
        if exc_type is None and self.allow is not None and self.new_traces > self.allow:
            scope = self.scope or "<all scopes>"
            detail = ", ".join(f"{k}: +{n}" for k, n in sorted(self.traced.items()))
            raise RetraceError(
                f"{self.new_traces} build(s) under scope {scope!r} "
                f"(allowed {self.allow}): {detail} — a re-run must reuse the "
                "compiled program"
            )
        return False


def retrace_guard(scope: str | None = None, allow: int | None = 0) -> RetraceGuard:
    """Guard a region against accidental rebuilds (see module docs)."""
    return RetraceGuard(scope, allow)
