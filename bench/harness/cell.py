"""One run of one cell: the driver its traffic names, then the result line.

A driver (:mod:`bench.harness.train`, :mod:`bench.harness.serve`) sets the
program up, measures the window, frees the program's state and compares what
the window produced with the reference.  It returns an :class:`Outcome`;
:func:`run` turns that into the result: the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics from their readers (``--trace 1``),
``correct`` from the compared numbers and their limits, and the device.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import time
from pathlib import Path

from bench.harness.manifest import Manifest
from bench.harness.spans import Span, Spans
from bench.roofline import counts, peaks


@dataclasses.dataclass
class Context:
    model: dict  # the configuration file's "model" block
    norm_eps: float
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    traced: bool
    device: str
    started: float  # the process's start on time.perf_counter()
    spans: Spans


@dataclasses.dataclass
class Outcome:
    end_to_end: dict  # metric name -> value
    attempted: int
    failed: int
    compared: dict  # number -> value (the limits are the context's)
    memory_peak_bytes: int
    window: list  # the window's spans
    trace: dict | None  # bench.harness.trace.summarize's
    notes: dict = dataclasses.field(default_factory=dict)  # what the run saw, printed on standard error


@dataclasses.dataclass
class Run:
    """What a per-layer metric's ``read(run)`` reads: the window's host spans,
    the device trace's summary, the configuration's model block and the
    traffic, with the frozen counts and peaks."""

    spans: list[Span]
    trace: dict | None
    model: dict
    traffic: dict
    counts: object = counts
    peaks: object = peaks


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool, device: str,
        started: float | None = None) -> tuple[dict, dict]:
    """Returns the result line's object and the run's notes."""
    m = Manifest(root)
    cell = m.cell(workload)
    conf = m.config(cell["config"])
    traffic = m.traffic(cell["traffic"])
    ctx = Context(model=conf["model"], norm_eps=conf["norm_eps"], traffic=traffic, limits=m.limits(workload),
                  seed=seed, seconds=seconds, traced=traced, device=device,
                  started=time.perf_counter() if started is None else started, spans=Spans(traced))
    out = importlib.import_module(f"bench.harness.{traffic['driver']}").run(ctx)
    missing = sorted(set(ctx.limits) ^ set(out.compared))
    if missing:
        raise KeyError(f"compared numbers and limits differ on {missing}")
    compared = {k: {"value": v, "limit": ctx.limits[k]} for k, v in sorted(out.compared.items())}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    metrics = {}
    if traced:
        view = Run(out.window, out.trace, ctx.model, traffic)
        for spec in m.per_layer(workload):
            value = m.reader(spec["name"])(view)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        for spec in m.end_to_end(workload):
            metrics[spec["name"]] = {"value": out.end_to_end[spec["name"]], "unit": spec["unit"]}
    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu", "kind": _kind(device), "count": cell["chips"],
           "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed, "metrics": metrics,
              "device": dev}
    if traced and out.trace is not None:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
        result["breakdown"] = {"device_ops": out.trace["device_ops"], "idle_gaps": out.trace["idle_gaps"]}
    result["compared"] = compared
    return result, out.notes


def _kind(device: str) -> str:
    if device.startswith("cuda"):
        import torch

        return torch.cuda.get_device_name(0)
    return "cpu"


def sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def memory_peak(device) -> int:
    if str(device).startswith("cuda"):
        import torch

        return int(torch.cuda.max_memory_allocated())
    return 0


def settle(device) -> None:
    """The end of set-up: the device idle, and every object set-up made moved
    out of the garbage collector's reach (``gc.freeze``), so that a full
    collection inside the window walks only what the window makes."""
    import gc

    sync(device)
    gc.collect()
    gc.freeze()


def free(device) -> None:
    import gc

    gc.unfreeze()
    gc.collect()
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.empty_cache()
