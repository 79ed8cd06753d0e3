"""The Scenario/Engine API of the port: the declarative simulation surface.

  * :class:`Scenario` — what to simulate (market, workload, schemes, bid
    grid, params, seeds), never how.
  * :class:`TorchEngine` — the fused spot sweep on a torch device for the
    five bid-limited schemes (the hand-written CUDA kernel on the GPU, the
    plain PyTorch version on the CPU) and ACC's lockstep seek / lease walk
    in torch ops on the same device.
  * :class:`ReferenceEngine` — the scalar event loop, cell by cell, on the
    host; semantically canonical (:mod:`repro_torch.engine.parity`).
  * :func:`run` — the one-call entry point; it runs on the GPU unless
    ``device="cpu"`` is passed, and raises when there is no GPU.
  * :class:`FleetScenario` / :func:`run_fleet` — fleet studies: the batch
    engine's waves on the GPU unless ``device="cpu"``, the scalar
    ``FleetController`` on the host for ``engine="controller"`` and for
    contended or re-bidding fleets.
"""

from repro_torch.core.schemes import ALL_SCHEMES
from repro_torch.engine.base import (
    PARITY_FIELDS,
    Engine,
    EngineResult,
    PhaseTimings,
    get_engine,
    resolve_device,
    run,
)
from repro_torch.engine.fleetgrid import FleetGridResult, policy_registry, resolve_policies, run_fleet
from repro_torch.engine.parity import (
    COMPARED,
    COST_RTOL,
    CellMismatch,
    ParityReport,
    assert_parity,
    compare_engines,
    compare_results,
)
from repro_torch.engine.reference import ReferenceEngine
from repro_torch.engine.scenario import (
    BATCHED_SCHEMES,
    BID_LIMITED_SCHEMES,
    FleetScenario,
    MarketCell,
    Scenario,
)
from repro_torch.engine.torch_backend import TorchEngine

__all__ = [
    "ALL_SCHEMES",
    "BATCHED_SCHEMES",
    "BID_LIMITED_SCHEMES",
    "COMPARED",
    "COST_RTOL",
    "PARITY_FIELDS",
    "CellMismatch",
    "Engine",
    "EngineResult",
    "FleetGridResult",
    "FleetScenario",
    "MarketCell",
    "ParityReport",
    "PhaseTimings",
    "ReferenceEngine",
    "Scenario",
    "TorchEngine",
    "assert_parity",
    "compare_engines",
    "compare_results",
    "get_engine",
    "policy_registry",
    "resolve_policies",
    "resolve_device",
    "run",
    "run_fleet",
]
