"""Serving subsystem: heterogeneous spot auto-scaling under live traffic.

The request-serving workload class (ROADMAP: "heavy traffic from millions
of users"): a mixed on-demand + spot replica tier scaled against diurnal
request arrivals, with preemption-by-outbid from the auction market as
the dominant failure mode and availability/latency SLOs as the objective —
the Qu, Calheiros & Buyya auto-scaling system (PAPERS.md, arxiv 1509.05197)
recast onto this repo's market and engine substrate.

The port of :mod:`repro.serving`.  Entry points: build a
:class:`ServingScenario`, run it with :func:`run_serving` (``engine=
"reference"``, the scalar ground truth on the host, or the bit-identical
``"batch"`` lockstep grid as torch ops on the GPU unless ``device="cpu"``),
read SLOs off the :class:`ServingResult` — or let the suite control plane
cache it (``kind = "serving"`` in a suite TOML, run through
:mod:`repro_torch.suite`).
"""

from repro_torch.serving.autoscaler import (
    AutoscalerPolicy,
    TargetTracking,
    ThresholdStep,
    policy_registry,
)
from repro_torch.serving.engine import SERVING_ENGINES, ServingScenario, run_serving
from repro_torch.serving.replicas import REFERENCE_ECU, replica_rps
from repro_torch.serving.slo import ServingResult, p99_latency, summarize
from repro_torch.serving.traffic import TrafficModel, rates_batch, traffic_seed

__all__ = [
    "AutoscalerPolicy",
    "REFERENCE_ECU",
    "SERVING_ENGINES",
    "ServingResult",
    "ServingScenario",
    "TargetTracking",
    "ThresholdStep",
    "TrafficModel",
    "p99_latency",
    "policy_registry",
    "rates_batch",
    "replica_rps",
    "run_serving",
    "summarize",
    "traffic_seed",
]
