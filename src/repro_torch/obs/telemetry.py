"""Telemetry core: hierarchical wall-clock spans and monotonic counters.

Instrumented code never takes a telemetry object as an argument: it calls
:func:`current`, which returns the innermost *activated* collector or the
module-level :data:`NULL` no-op.  Activation is a context manager (or the
:class:`Telemetry` object itself).

With nothing activated, every instrumentation site costs one global read
plus either a predicate check (counters) or a shared do-nothing context
manager (spans): no allocation, no clock read.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Iterator

__all__ = ["NULL", "Span", "Telemetry", "activate", "current"]


@dataclasses.dataclass
class Span:
    """One finished (or in-flight) wall-clock phase.

    ``t0`` is seconds since the owning collector's epoch (its creation);
    ``dur`` is filled on exit.  ``children`` nest in emission order.
    """

    name: str
    t0: float
    dur: float = 0.0
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    children: list["Span"] = dataclasses.field(default_factory=list)

    @property
    def self_dur(self) -> float:
        """Exclusive time: ``dur`` minus the children's total."""
        return self.dur - sum(c.dur for c in self.children)

    def find(self, name: str) -> Iterator["Span"]:
        """Depth-first search of this subtree by span name."""
        if self.name == name:
            yield self
        for c in self.children:
            yield from c.find(name)


class _NullSpanCtx:
    """Shared no-op span context (the disabled fast path)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN_CTX = _NullSpanCtx()


class _SpanCtx:
    """Context manager produced by :meth:`Telemetry.span`."""

    __slots__ = ("_tel", "_span")

    def __init__(self, tel: "Telemetry", span: Span):
        self._tel = tel
        self._span = span

    def __enter__(self) -> Span:
        tel = self._tel
        span = self._span
        stack = tel._stack
        (stack[-1].children if stack else tel.spans).append(span)
        stack.append(span)
        span.t0 = time.perf_counter() - tel.epoch
        return span

    def __exit__(self, *exc):
        span = self._tel._stack.pop()
        span.dur = time.perf_counter() - self._tel.epoch - span.t0
        return False


class Telemetry:
    """A live collector of spans and counters.

    Entering the object activates it (instrumented library code then reports
    here via :func:`current`); exiting deactivates it.
    """

    enabled = True

    def __init__(self) -> None:
        self.epoch = time.perf_counter()
        self.spans: list[Span] = []  # root spans, in emission order
        self.counters: dict[str, float] = {}
        # span nesting is tracked per thread, so spans from several threads
        # never interleave their nesting; counter updates take the lock
        self._local = threading.local()
        self._lock = threading.Lock()

    @property
    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, **attrs) -> _SpanCtx:
        """Context manager timing one phase; yields the :class:`Span`."""
        return _SpanCtx(self, Span(name=name, t0=0.0, attrs=attrs))

    def count(self, name: str, value: float = 1) -> None:
        """Add ``value`` to the monotonic counter ``name``."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    def counter(self, name: str) -> float:
        """Current value of counter ``name`` (0 when never incremented)."""
        return self.counters.get(name, 0)

    def __enter__(self) -> "Telemetry":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.pop()  # with-blocks unwind LIFO
        return False


class _NullTelemetry(Telemetry):
    """The disabled collector: every operation is a no-op."""

    enabled = False

    def span(self, name: str, **attrs):  # shared ctx: no allocation
        return _NULL_SPAN_CTX

    def count(self, name: str, value: float = 1) -> None:
        pass

    def __enter__(self):
        raise RuntimeError("the NULL telemetry cannot be activated")


#: The module-wide disabled collector.
NULL = _NullTelemetry()

#: Activation stack; the innermost activated collector receives telemetry.
_ACTIVE: list[Telemetry] = []


def current() -> Telemetry:
    """The innermost activated collector, or :data:`NULL` when none is."""
    return _ACTIVE[-1] if _ACTIVE else NULL


class _Activation:
    __slots__ = ("_tel",)

    def __init__(self, tel: Telemetry):
        self._tel = tel

    def __enter__(self) -> Telemetry:
        _ACTIVE.append(self._tel)
        return self._tel

    def __exit__(self, *exc):
        _ACTIVE.pop()
        return False


def activate(tel: Telemetry) -> _Activation:
    """Activate ``tel`` for the dynamic extent of the ``with`` block.

    Unlike ``with tel:`` this works for re-activating a collector that is
    already active (the stack may hold the same object twice)."""
    if not tel.enabled:
        raise RuntimeError("cannot activate a disabled collector")
    return _Activation(tel)
