"""Engine protocol and the structure-of-arrays result container.

An :class:`Engine` consumes a :class:`~repro_torch.engine.scenario.Scenario`
and returns an :class:`EngineResult` — per-cell outcome arrays shaped
``(n_markets, n_bids, n_schemes)``, host NumPy arrays whatever device
simulated them.  Two backends ship:
:class:`~repro_torch.engine.torch_backend.TorchEngine`, the fused spot sweep
(:mod:`repro_torch.kernels.spot_sweep`) on a torch device — the hand-written
CUDA kernel on the GPU, its plain PyTorch version on the CPU — with ACC's
lockstep walk beside it; and
:class:`~repro_torch.engine.reference.ReferenceEngine`, the scalar event loop
on the host, the yardstick of :mod:`repro_torch.engine.parity`.

``run(scenario)`` is the one-call surface.  It runs on the GPU unless the
caller passes ``device="cpu"``, and raises when there is no GPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.schemes import Scheme
from repro_torch.core.simulator import SimResult
from repro_torch.engine.scenario import MarketCell, Scenario
from repro_torch.obs.telemetry import Span, Telemetry


#: SimResult fields every backend must agree on, cell for cell (the JAX package's
#: ``PARITY_FIELDS``; :data:`repro_torch.engine.parity.COMPARED` holds more).
PARITY_FIELDS = ("completed", "completion_time", "cost", "n_checkpoints", "n_kills")


@dataclasses.dataclass(frozen=True)
class SchemePhases:
    """One scheme's wall-time split inside an engine run (the fused sweep
    simulates every scheme at once, so only billing splits by scheme)."""

    bill_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class PhaseTimings:
    """Typed per-phase breakdown of one engine run, built from the span tree:
    the grid build, the fused sweep of all schemes, and billing per scheme."""

    engine: str
    total_s: float
    grid_s: float = 0.0  # period grid + ADAPT tables (cache misses only)
    sim_s: float = 0.0  # fused sweep, all schemes, incl. the copies to/from the device
    impl: str | None = None  # spot_sweep implementation label ("cuda" or "plain")
    per_scheme: Mapping[str, SchemePhases] = dataclasses.field(default_factory=dict)

    @property
    def bill_s(self) -> float:
        """Total billing wall time across schemes."""
        return sum(p.bill_s for p in self.per_scheme.values())

    @classmethod
    def from_span(cls, root: Span, engine: str, total_s: float) -> "PhaseTimings":
        """Fold an ``engine.run`` span subtree into the typed record.

        ``grid`` wraps the period-grid/tables build, ``sim`` the sweep (with
        an ``impl`` attr), ``bill`` the billing of one scheme (with a
        ``scheme`` attr).
        """
        grid_s = sum(s.dur for s in root.find("grid"))
        sim_s, impl = 0.0, None
        for s in root.find("sim"):
            sim_s += s.self_dur
            impl = s.attrs.get("impl", impl)
        per = {s.attrs["scheme"]: SchemePhases(bill_s=s.dur) for s in root.find("bill")}
        return cls(engine=engine, total_s=total_s, grid_s=grid_s, sim_s=sim_s, impl=impl, per_scheme=per)


@dataclasses.dataclass
class EngineResult:
    """SoA outcome grid: axis 0 markets, axis 1 bids, axis 2 schemes.

    ``sim_results`` holds per-cell :class:`SimResult` records (with their
    billed runs) only when the reference engine was asked to keep them;
    otherwise :meth:`cell` reconstructs a run-less :class:`SimResult`.
    """

    scenario: Scenario
    engine: str
    markets: list[MarketCell]
    bids: tuple[float, ...]
    schemes: tuple[Scheme, ...]
    completed: np.ndarray  # bool  (M, B, S)
    completion_time: np.ndarray  # float64, inf when unfinished
    cost: np.ndarray  # float64 $
    n_checkpoints: np.ndarray  # int64
    n_kills: np.ndarray  # int64
    n_self_terminations: np.ndarray  # int64 (ACC only)
    work_lost_s: np.ndarray  # float64
    wall_s: float = 0.0
    sim_results: dict[tuple[int, int, int], SimResult] | None = None
    #: typed phase-timing breakdown (grid build, sim, per-scheme billing)
    #: built from the run's span tree
    timings: PhaseTimings | None = None

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.cost.shape

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.shape))

    @property
    def cells_per_s(self) -> float:
        return self.n_cells / self.wall_s if self.wall_s > 0 else math.inf

    def scheme_index(self, scheme: Scheme) -> int:
        return self.schemes.index(scheme)

    def cell(self, market: int, bid: int, scheme: Scheme | int) -> SimResult:
        """Reconstruct one cell as a :class:`SimResult` (runs only when the
        backend kept them)."""
        s = scheme if isinstance(scheme, int) else self.scheme_index(scheme)
        if self.sim_results is not None and (market, bid, s) in self.sim_results:
            return self.sim_results[(market, bid, s)]
        return SimResult(
            scheme=self.schemes[s],
            bid=self.scenario.market_bids(self.markets[market])[bid],
            work_s=self.scenario.work_s,
            completed=bool(self.completed[market, bid, s]),
            completion_time=float(self.completion_time[market, bid, s]),
            cost=float(self.cost[market, bid, s]),
            n_checkpoints=int(self.n_checkpoints[market, bid, s]),
            n_kills=int(self.n_kills[market, bid, s]),
            n_self_terminations=int(self.n_self_terminations[market, bid, s]),
            work_lost_s=float(self.work_lost_s[market, bid, s]),
            runs=[],
        )

    def by_scheme(self, scheme: Scheme) -> dict[str, np.ndarray]:
        """(M, B) slices of every outcome array for one scheme."""
        s = self.scheme_index(scheme)
        return {
            "completed": self.completed[:, :, s],
            "completion_time": self.completion_time[:, :, s],
            "cost": self.cost[:, :, s],
            "n_checkpoints": self.n_checkpoints[:, :, s],
            "n_kills": self.n_kills[:, :, s],
            "n_self_terminations": self.n_self_terminations[:, :, s],
            "work_lost_s": self.work_lost_s[:, :, s],
        }


def fold_result_counters(tel: Telemetry, res: EngineResult) -> None:
    """Fold a finished result grid into an active collector's counters.

    The sweep accumulates kills/checkpoints on the device; this is where
    those tallies surface as telemetry, once per run — the hot loops stay
    uninstrumented.
    """
    tel.count("engine.runs")
    tel.count("engine.cells", res.n_cells)
    tel.count("engine.kills", int(res.n_kills.sum()))
    tel.count("engine.checkpoints", int(res.n_checkpoints.sum()))
    tel.count("engine.completions", int(res.completed.sum()))
    tel.count("engine.work_lost_s", float(res.work_lost_s.sum()))


def empty_result(scenario: Scenario, markets: list[MarketCell], engine: str) -> EngineResult:
    """Allocate an all-unfinished result grid for ``scenario``."""
    shape = (len(markets), len(scenario.bids), len(scenario.schemes))
    return EngineResult(
        scenario=scenario,
        engine=engine,
        markets=markets,
        bids=scenario.bids,
        schemes=scenario.schemes,
        completed=np.zeros(shape, dtype=bool),
        completion_time=np.full(shape, np.inf),
        cost=np.zeros(shape),
        n_checkpoints=np.zeros(shape, dtype=np.int64),
        n_kills=np.zeros(shape, dtype=np.int64),
        n_self_terminations=np.zeros(shape, dtype=np.int64),
        work_lost_s=np.zeros(shape),
    )


@runtime_checkable
class Engine(Protocol):
    """Anything that can evaluate a Scenario into an EngineResult."""

    name: str

    def run(self, scenario: Scenario) -> EngineResult: ...


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: the GPU unless ``device``
    names another.  Raises when a CUDA device is asked for (by default or by
    name) and none is present — the port never carries on on the CPU unless
    told to."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch version on the CPU"
        )
    return dev


def get_engine(name: str = "auto", device=None) -> Engine:
    """Resolve an engine by name: ``"auto"`` or ``"torch"`` (the same
    :class:`~repro_torch.engine.torch_backend.TorchEngine`), or
    ``"reference"`` (the scalar
    :class:`~repro_torch.engine.reference.ReferenceEngine`, host Python).
    For the torch engine ``device`` defaults to the GPU; without one this
    raises rather than running on the CPU — pass ``device="cpu"`` for that."""
    from repro_torch.engine.reference import ReferenceEngine
    from repro_torch.engine.torch_backend import TorchEngine

    if name in ("auto", "torch"):
        return TorchEngine(device=device)
    if name == "reference":
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError("the reference engine runs on the host; it takes no device")
        return ReferenceEngine()
    raise ValueError(f"unknown engine {name!r}; expected auto|torch|reference")


def run(scenario: Scenario, engine: str | Engine = "auto", device=None) -> EngineResult:
    """Evaluate ``scenario`` on the selected backend (on the GPU unless
    ``device`` says otherwise; ``device`` applies to a named engine only)."""
    if isinstance(engine, str):
        return get_engine(engine, device=device).run(scenario)
    if device is not None:
        raise ValueError("device= applies to a named engine; an engine instance has its own")
    return engine.run(scenario)
