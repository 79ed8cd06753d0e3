"""The device trace of a traced run's window, read from ``torch.profiler``'s
events in memory (nothing is written to disk).

:func:`summarize` takes ``(name, kind, start_ns, end_ns)`` tuples, ``kind``
being ``"device"`` (a kernel, copy or fill on the card) or ``"span"`` (a
``bench.*`` host range), and returns the window's length, the device's busy
seconds (the union of its operations' intervals inside the window), the
operations by total time, the idle gaps' seconds by the innermost host span
open at each moment of a gap, and the device operations themselves
(``ops``: name, start, end) for the per-layer readers.
"""

from __future__ import annotations

import bisect

WINDOW = "bench.window"
#: Entries of each list of the result's ``breakdown``.
TOP = 10


def profiler(device):
    """A profiler of host ranges and, on the card, of its operations."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if str(device).startswith("cuda") else [])
    return profile(activities=acts, record_shapes=False, profile_memory=False, with_stack=False)


def events(prof) -> list[tuple[str, str, int, int]]:
    """The profiler's device operations and ``bench.*`` ranges as tuples."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        if name.startswith("bench."):
            if str(e.device_type()).endswith("CPU"):
                out.append((name, "span", start, end))
        elif str(e.device_type()).endswith("CUDA") and not e.is_user_annotation():
            out.append((name, "device", start, end))
    return out


def _union(intervals: list[tuple[int, int]]) -> list[list[int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _segments(spans: list[tuple[int, int, str]]) -> list[tuple[int, int, str]]:
    """The host timeline as ``(start, end, innermost open span)`` pieces
    between consecutive span boundaries (spans nest or follow each other)."""
    bounds = sorted({x for s, e, _ in spans for x in (s, e)})
    starts = [s for s, _, _ in spans]
    out = []
    for a, b in zip(bounds, bounds[1:]):
        j = bisect.bisect_right(starts, a) - 1
        while j >= 0 and spans[j][1] < b:
            j -= 1
        if j >= 0:
            out.append((a, b, spans[j][2][len("bench."):]))
    return out


def summarize(evts: list[tuple[str, str, int, int]]) -> dict | None:
    """None when the trace holds no window range."""
    windows = [(s, e) for name, kind, s, e in evts if kind == "span" and name == WINDOW]
    if not windows:
        return None
    w0, w1 = windows[0]
    ops = [(name, max(s, w0), min(e, w1)) for name, kind, s, e in evts if kind == "device" and e > w0 and s < w1]
    busy = _union([(s, e) for _, s, e in ops])
    by_name: dict[str, float] = {}
    for name, s, e in ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
    spans = sorted((s, e, name) for name, kind, s, e in evts if kind == "span" and name != WINDOW)
    idle: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(gs, ge) for gs, ge in zip(edges[0::2], edges[1::2]) if ge > gs]
    segs = _segments(spans)
    j = 0
    for gs, ge in gaps:  # each gap's time split over the host spans it overlaps
        while j < len(segs) and segs[j][1] <= gs:
            j += 1
        t, k = gs, j
        while t < ge:
            if k < len(segs) and segs[k][0] < ge:
                a, b, who = segs[k]
                if a > t:
                    idle["none"] = idle.get("none", 0.0) + (a - t) * 1e-9
                    t = a
                end = min(b, ge)
                idle[who] = idle.get(who, 0.0) + (end - t) * 1e-9
                t = end
                k += 1
            else:
                idle["none"] = idle.get("none", 0.0) + (ge - t) * 1e-9
                t = ge
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    named_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(e - s for s, e in busy) * 1e-9,
        "device_ops": [[n[:200], v] for n, v in top],
        "idle_gaps": [[n, v] for n, v in named_gaps],
        "ops": ops,
    }
