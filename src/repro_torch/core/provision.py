"""The SLA admission filter of the provisioning algorithm (paper §VI-B)."""

from __future__ import annotations

import dataclasses

from repro_torch.core.market import InstanceType


@dataclasses.dataclass(frozen=True)
class SLA:
    """Minimal service level: compute throughput and memory class."""

    min_compute_units: float = 0.0
    regions: tuple[str, ...] = ()  # empty = any
    os: str | None = None

    def admits(self, it: InstanceType) -> bool:
        if it.compute_units < self.min_compute_units:
            return False
        if self.regions and it.region not in self.regions:
            return False
        if self.os is not None and it.os != self.os:
            return False
        return True
