"""Per-run result records of the checkpointing-scheme simulation.

The scalar event loop itself is not part of this package; the engine
evaluates whole grids (:mod:`repro_torch.engine`) and
:meth:`~repro_torch.engine.base.EngineResult.cell` rebuilds one cell as a
:class:`SimResult`.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.billing import Termination
from repro_torch.core.schemes import Scheme

#: Tolerance of every "work is done" / "checkpoint fits" comparison.
_EPS = 1e-9


@dataclasses.dataclass
class InstanceRun:
    launch: float
    end: float
    termination: Termination
    cost: float


@dataclasses.dataclass
class SimResult:
    scheme: Scheme
    bid: float
    work_s: float
    completed: bool
    completion_time: float  # wall-clock seconds from t=0 to job completion
    cost: float  # $
    n_checkpoints: int
    n_kills: int  # provider (out-of-bid) terminations
    n_self_terminations: int  # ACC user terminations
    work_lost_s: float
    runs: list[InstanceRun]
