"""The Scenario/Engine API of the port: the declarative simulation surface.

  * :class:`Scenario` — what to simulate (market, workload, schemes, bid
    grid, params, seeds), never how.
  * :class:`TorchEngine` — the fused spot sweep on a torch device: the
    hand-written CUDA kernel on the GPU, the plain PyTorch version on the
    CPU.
  * :func:`run` — the one-call entry point; it runs on the GPU unless
    ``device="cpu"`` is passed, and raises when there is no GPU.
"""

from repro_torch.engine.base import (
    Engine,
    EngineResult,
    PhaseTimings,
    get_engine,
    resolve_device,
    run,
)
from repro_torch.engine.scenario import BID_LIMITED_SCHEMES, MarketCell, Scenario
from repro_torch.engine.torch_backend import TorchEngine

__all__ = [
    "BID_LIMITED_SCHEMES",
    "Engine",
    "EngineResult",
    "MarketCell",
    "PhaseTimings",
    "Scenario",
    "TorchEngine",
    "get_engine",
    "resolve_device",
    "run",
]
