"""Per-run result records of the checkpointing-scheme simulation, and the
ACC relaunch poll.

The scalar event loop itself is not part of this package; the engine
evaluates whole grids (:mod:`repro_torch.engine`) and
:meth:`~repro_torch.engine.base.EngineResult.cell` rebuilds one cell as a
:class:`SimResult`.  :func:`_next_launch_time` is the relaunch poll the live
trainer shares with :mod:`repro.core.simulator`.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.billing import Termination
from repro_torch.core.market import PriceTrace
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


def _next_launch_time(trace: PriceTrace, t_from: float, a_bid: float, poll_s: float) -> float | None:
    """First poll tick >= t_from with price <= A_bid (paper: user-defined poll)."""
    t = math.ceil(t_from / poll_s - _EPS) * poll_s
    while t < trace.horizon:
        if trace.price_at(t) <= a_bid:
            return t
        # jump to the next of (next poll tick, next price change) -- price is
        # piecewise constant so polls inside one segment all agree.
        nxt_change = trace.next_change(t)
        t = max(t + poll_s, math.ceil(nxt_change / poll_s - _EPS) * poll_s)
    return None
