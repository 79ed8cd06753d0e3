"""The program's spans in a traced run's device trace.

While the profiler records, each span of :mod:`repro_torch.obs` opens a
range named ``repro_torch.<span>`` on the host.  :func:`attribute` returns,
for each span name, the number of its ranges, their host seconds, the device
seconds of the operations launched while one was open, and the host launch
calls made while one was open.

A device operation belongs to every program range open on the host, on any
thread, when the host call that enqueued it ran: the operation and that call
share the profiler's correlation id.  A backward launches from autograd's
device thread while the step's thread waits in ``torch.autograd.grad``, so
a range of either thread counts.  Overlap in device time is never used: the
host runs ahead of the device, and the range open while an operation ran on
the device need not be the one that launched it.  A launch call is a host
call that enqueued device work (a kernel launch, an asynchronous copy or
fill, a graph launch), counted once however many operations it enqueued.
"""

from __future__ import annotations

from bench.harness import trace

PREFIX = "repro_torch."

#: metric -> (span it reads, quantity, span whose count it is divided by, scale)
READINGS = {
    "train_forward_ms": ("train.forward", "device_s", "train.step", 1e3),
    "train_backward_ms": ("train.backward", "device_s", "train.step", 1e3),
    "attention_recompute_ms": ("kernel.flash_attention.recompute", "device_s", "train.step", 1e3),
    "train_adamw_ms": ("train.adamw", "device_s", "train.step", 1e3),
    "ssm_inputs_ms": ("prefill.ssm_inputs", "device_s", "prefill", 1e3),
    "decode_device_ms": ("decode.step", "device_s", "decode.step", 1e3),
    "decode_launches_per_step": ("decode.step", "launches", "decode.step", 1.0),
}


def events(prof) -> list[tuple[str, str, int, int, int, int]]:
    """``(name, kind, start_ns, end_ns, thread, correlation)`` of the
    profiler's program ranges (kind ``"range"``, the name without its
    prefix), the ``bench.window`` range (``"window"``), the host's CUDA API
    calls (``cuda*`` and ``cu*``: ``"call"``) and the device's operations
    (``"device"``).  A call and the operations it enqueued share their
    correlation id; a range's is 0."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if str(e.device_type()).endswith("CUDA"):
            if not e.is_user_annotation():
                out.append((name, "device", start, end, 0, e.correlation_id()))
        elif name.startswith(PREFIX):
            out.append((name[len(PREFIX):], "range", start, end, e.start_thread_id(), 0))
        elif name == trace.WINDOW:
            out.append((name, "window", start, end, e.start_thread_id(), 0))
        elif name.startswith("cu") and not e.is_user_annotation():  # cudaLaunchKernel, cuLaunchKernelEx, ...
            out.append((name, "call", start, end, e.start_thread_id(), e.correlation_id()))
    return out


def attribute(evts: list[tuple[str, str, int, int, int, int]]) -> dict[str, dict]:
    """``{span: {"count", "host_s", "device_s", "launches"}}`` for every span
    name with a range in ``evts``."""
    device_ns: dict[int, int] = {}
    for _, kind, s, e, _, corr in evts:
        if kind == "device":
            device_ns[corr] = device_ns.get(corr, 0) + (e - s)
    out: dict[str, dict] = {}
    points = []  # (time, order, what): a range's start before a call at its time, its end after
    for name, kind, s, e, _, corr in evts:
        if kind == "range":
            rec = out.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0, "launches": 0})
            rec["count"] += 1
            rec["host_s"] += (e - s) * 1e-9
            points += [(s, 0, name), (e, 2, name)]
        elif kind == "call" and corr in device_ns:
            points.append((s, 1, corr))
    points.sort(key=lambda p: p[:2])
    open_ranges: dict[str, int] = {}
    for _, order, what in points:
        if order == 0:
            open_ranges[what] = open_ranges.get(what, 0) + 1
        elif order == 2:
            open_ranges[what] -= 1
            if not open_ranges[what]:
                del open_ranges[what]
        else:
            for name in open_ranges:
                out[name]["launches"] += 1
                out[name]["device_s"] += device_ns[what] * 1e-9
    return out


def reading(program: dict | None, metric: str) -> float | None:
    """A metric of :data:`READINGS` from :func:`attribute`'s result, or None
    when there is no trace or its span is missing."""
    span, quantity, per, scale = READINGS[metric]
    if not program or span not in program or not program.get(per, {}).get("count"):
        return None
    return scale * program[span][quantity] / program[per]["count"]


def idle_by_span(evts: list[tuple[str, str, int, int, int, int]]) -> list | None:
    """The window's idle gaps split by the innermost program range open on the
    window's own thread (``"none"`` where none is), as
    :func:`bench.harness.trace.summarize` splits them by the benchmark's
    spans; None when there is no window."""
    windows = [(s, e, thread) for _, kind, s, e, thread, _ in evts if kind == "window"]
    if not windows:
        return None
    w0, w1, thread = windows[0]
    spans = [("bench." + name, "span", s, e) for name, kind, s, e, t, _ in evts if kind == "range" and t == thread]
    ops = [(name, "device", s, e) for name, kind, s, e, _, _ in evts if kind == "device"]
    return trace.summarize([(trace.WINDOW, "span", w0, w1), *spans, *ops])["idle_gaps"]
