"""Event generation for spot instances (paper §VI-A).

Three events drive the monitoring->controller loop:

  * ``E_ckpt``      — take a checkpoint (fired at t_cd when price > A_bid),
  * ``E_terminate`` — self-terminate the instance (fired at t_td when price
                      is still > A_bid),
  * ``E_launch``    — (re)launch at the start of an available period.

plus the framework-level events of [2] (threshold / prediction / request /
ping / schedule based) represented as :class:`EventKind` so the same
monitoring subsystem serves both the simulator and the live SpotTrainer.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Iterator

from repro_torch.core.market import PriceTrace
from repro_torch.core.schemes import SimParams, decision_points
from repro_torch.obs.telemetry import current as _obs_current


class EventKind(enum.Enum):
    # spot events (this paper)
    CKPT = "E_ckpt"
    TERMINATE = "E_terminate"
    LAUNCH = "E_launch"
    # framework events ([2])
    THRESHOLD = "E_threshold"
    PREDICTION = "E_prediction"
    REQUEST = "E_request"
    PING = "E_ping"
    SCHEDULE = "E_schedule"


@dataclasses.dataclass(frozen=True)
class Event:
    kind: EventKind
    time: float
    payload: dict


@dataclasses.dataclass
class SpotEventGenerator:
    """Generates E_ckpt / E_terminate / E_launch for one instance lease.

    This is the *runtime* counterpart of the simulator's ACC loop: the
    SpotTrainer drives it with wall-clock hour boundaries; tests drive it
    with a trace.  ``price_fn(t)`` abstracts "query current spot price"
    (latency t_w is accounted for by the decision-point math, Eq. 3-4).
    """

    a_bid: float
    params: SimParams
    price_fn: Callable[[float], float]

    def events_for_hour(self, hour_boundary: float) -> Iterator[Event]:
        t_cd, t_td = decision_points(hour_boundary, self.params)
        price_cd = self.price_fn(t_cd)
        if price_cd > self.a_bid:
            yield self._emit(
                Event(EventKind.CKPT, t_cd, {"price": price_cd, "deadline": hour_boundary})
            )
        price_td = self.price_fn(t_td)
        if price_td > self.a_bid:
            yield self._emit(
                Event(EventKind.TERMINATE, t_td, {"price": price_td, "at": hour_boundary})
            )

    def launch_event(self, t: float) -> Event | None:
        p = self.price_fn(t)
        if p <= self.a_bid:
            return self._emit(Event(EventKind.LAUNCH, t, {"price": p}))
        return None

    @staticmethod
    def _emit(ev: Event) -> Event:
        """Mirror a generated monitoring event onto the active telemetry
        collector (sim-time instant + counter), then pass it through."""
        tel = _obs_current()
        if tel.enabled:
            tel.event(ev.kind.value, ev.time, **ev.payload)
            tel.count(f"events.{ev.kind.value}")
        return ev


def trace_price_fn(trace: PriceTrace) -> Callable[[float], float]:
    return trace.price_at
