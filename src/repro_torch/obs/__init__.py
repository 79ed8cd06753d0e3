"""Observability: wall-clock spans, counters, exporters, and the build/trace registry.

Nothing is recorded unless a :class:`Telemetry` collector is activated::

    from repro_torch import obs

    with obs.Telemetry() as tel:
        repro_torch.engine.run(scenario)
    tel.spans[0]            # the engine.run span tree
    tel.counter("engine.cells")
    print(tel.summary())                 # span totals, counters, gauges
    tel.write_chrome_trace("trace.json") # chrome://tracing / perfetto
    tel.write_jsonl("telemetry.jsonl")

The engine records its phases (``engine.run`` / ``grid`` / ``sim`` /
``bill``) as spans, the source of
:class:`repro_torch.engine.base.PhaseTimings`; the kernel build records
each ``nvcc`` build in the :mod:`~repro_torch.obs.retrace` registry under
scope ``torch_port.build``.  The spot trainer records the monitoring
events and its leases as simulation-time events (``tel.events``) and counts
checkpoints, preemptions, restores and fallbacks.

The model paths record, from the entry points down to the kernels:

=====================================  ===============================================
``train.step`` (``tokens``)            ``train/steps.py``: one step of ``make_train_step``
``train.forward``                      the loss of a microbatch (``loss_fn``)
``train.backward``                     its gradient (``torch.autograd.grad``)
``train.adamw``                        the AdamW update
``prefill`` (``rows``, ``ids``)        ``models/transformer.py::prefill``
``prefill.ssm_inputs``                 a Mamba layer's scan inputs (``models/ssm.py``; on the card
                                       ``kernel.mamba_inputs`` inside it)
``prefill.moe``                        a MoE layer's routing, expert products and combine
``decode.step`` (``pos``)              ``models/transformer.py::decode_step``
``decode.mixer``                       a layer's mixer in a decode step
``decode.moe``                         a MoE layer's experts in a decode step
``kernel.<name>``                      a kernel launch (``kernels/_launch.py::call``)
``kernel.flash_attention_backward``    the attention's backward kernel (its four launches)
``kernel.<name>.recompute``            a kernel's plain backward (``recompute_grads``)
=====================================  ===============================================

and, with a collector only (they read the routing back from the device):

=====================================  ===============================================
``moe.assignments`` (counter)          a MoE layer's tokens times ``top_k`` (``models/moe.py``)
``moe.dropped`` (counter)              the assignments over an expert's capacity (0 when dropless)
``moe.load_max_over_mean`` (gauge)     the last MoE layer's busiest expert's assignments over the mean
=====================================  ===============================================

While ``torch.profiler`` records, every span is also a ``record_function``
range ``repro_torch.<name>`` (no collector needed), so a device trace can
charge the device's operations to the span whose launches made them
(``bench/harness/attribution.py``).
"""

from repro_torch.obs.exporters import summary_table, write_chrome_trace, write_jsonl
from repro_torch.obs.retrace import (
    RetraceError,
    RetraceGuard,
    record_trace,
    retrace_guard,
    trace_count,
)
from repro_torch.obs.telemetry import NULL, SimEvent, Span, Telemetry, activate, current

__all__ = [
    "NULL",
    "RetraceError",
    "RetraceGuard",
    "SimEvent",
    "Span",
    "Telemetry",
    "activate",
    "current",
    "record_trace",
    "retrace_guard",
    "summary_table",
    "trace_count",
    "write_chrome_trace",
    "write_jsonl",
]
