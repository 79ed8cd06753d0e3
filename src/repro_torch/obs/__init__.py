"""Observability: wall-clock spans, counters, and the build/trace registry.

Nothing is recorded unless a :class:`Telemetry` collector is activated::

    from repro_torch import obs

    with obs.Telemetry() as tel:
        repro_torch.engine.run(scenario)
    tel.spans[0]            # the engine.run span tree
    tel.counter("engine.cells")

The engine records its phases (``engine.run`` / ``grid`` / ``sim`` /
``bill``) as spans, the source of
:class:`repro_torch.engine.base.PhaseTimings`; the kernel build records
each ``nvcc`` build in the :mod:`~repro_torch.obs.retrace` registry under
scope ``torch_port.build``.
"""

from repro_torch.obs.retrace import (
    RetraceError,
    RetraceGuard,
    record_trace,
    retrace_guard,
    trace_count,
)
from repro_torch.obs.telemetry import NULL, Span, Telemetry, activate, current

__all__ = [
    "NULL",
    "RetraceError",
    "RetraceGuard",
    "Span",
    "Telemetry",
    "activate",
    "current",
    "record_trace",
    "retrace_guard",
    "trace_count",
]
