"""Application lifecycle FSM (paper Fig. 3).

Six states: New, Inactive, Active, Unbalanced, Unreachable, Terminated.
Healing transitions (Unbalanced/Unreachable -> Active) run the workflow the
monitoring subsystem maps to the triggering event.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable


class AppState(enum.Enum):
    NEW = "new"
    INACTIVE = "inactive"
    ACTIVE = "active"
    UNBALANCED = "unbalanced"
    UNREACHABLE = "unreachable"
    TERMINATED = "terminated"


_ALLOWED: dict[AppState, tuple[AppState, ...]] = {
    AppState.NEW: (AppState.INACTIVE,),
    AppState.INACTIVE: (AppState.ACTIVE, AppState.TERMINATED),
    AppState.ACTIVE: (
        AppState.INACTIVE,
        AppState.UNBALANCED,
        AppState.UNREACHABLE,
        AppState.TERMINATED,
    ),
    AppState.UNBALANCED: (AppState.ACTIVE, AppState.TERMINATED),
    AppState.UNREACHABLE: (AppState.ACTIVE, AppState.TERMINATED),
    AppState.TERMINATED: (),
}


@dataclasses.dataclass
class Lifecycle:
    state: AppState = AppState.NEW
    history: list[tuple[AppState, AppState]] = dataclasses.field(default_factory=list)
    on_transition: Callable[[AppState, AppState], None] | None = None

    def to(self, new: AppState) -> None:
        if new not in _ALLOWED[self.state]:
            raise ValueError(f"illegal transition {self.state.value} -> {new.value}")
        old, self.state = self.state, new
        self.history.append((old, new))
        if self.on_transition is not None:
            self.on_transition(old, new)

    # Convenience transitions mirroring Fig. 3
    def map_modules(self):
        self.to(AppState.INACTIVE)

    def deploy(self):
        self.to(AppState.ACTIVE)

    def overload(self):
        self.to(AppState.UNBALANCED)

    def resource_failure(self):
        self.to(AppState.UNREACHABLE)

    def heal(self):
        self.to(AppState.ACTIVE)

    def release(self):
        self.to(AppState.TERMINATED)
