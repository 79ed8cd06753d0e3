"""Provisioning subsystem: Algorithm 1 (paper §VI-B), the port of
:mod:`repro.core.provision` (host Python and NumPy).

Determines ``A_bid`` and ``instance_type`` for a job:

  1. retrieve S_info (catalog + price history),
  2. filter instance types meeting the SLA,
  3. A_bid = min on-demand cost over the feasible list (Eq. 7),
  4. pick the type minimizing Expected Execution Time (Eq. 8):

         EET_i = ( w * sum_{k>=w} f_i(k) + sum_{k<w} (k+r) f_i(k) )
                 / ( 1 - sum_{k<w} f_i(k) )

     with f_i the out-of-bid failure pdf from price history and r the
     recovery time.  Work ``w`` is expressed in pdf bins and scaled by the
     instance's relative compute throughput (ECU) so heterogeneous types are
     comparable.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.market import InstanceType, PriceTrace
from repro_torch.core.schemes import FailurePdf


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


def expected_execution_time(
    pdf: FailurePdf,
    work_s: float,
    recovery_s: float,
) -> float:
    """Eq. 8, in seconds.  ``pdf`` bins failure age; censored mass counts as
    surviving past ``work_s`` (success)."""
    w_bins = max(1, int(math.ceil(work_s / pdf.bin_s)))
    k = np.arange(len(pdf.pdf))
    fail_before = pdf.pdf[:w_bins] if w_bins <= len(pdf.pdf) else pdf.pdf
    p_fail = float(np.sum(fail_before))
    p_succeed = 1.0 - p_fail  # includes censored mass
    if p_succeed <= 0.0:
        return math.inf
    # expected wasted time per failed attempt: (k + r) f(k) summed over k < w
    wasted = float(np.sum((k[: len(fail_before)] * pdf.bin_s + recovery_s) * fail_before))
    # attempts are geometric; success attempt costs w
    return (work_s * p_succeed + wasted) / p_succeed


@dataclasses.dataclass(frozen=True)
class ProvisioningDecision:
    a_bid: float
    instance: InstanceType
    eet_s: float
    candidates: dict[str, float]  # instance name -> EET


def algorithm1(
    work_s: float,
    sla: SLA,
    catalog: list[InstanceType],
    histories: dict[str, PriceTrace],
    recovery_s: float = 300.0,
    reference_ecu: float = 8.0,
    pdf_cache: dict[tuple[str, float], FailurePdf] | None = None,
) -> ProvisioningDecision:
    """Paper Algorithm 1.  ``histories`` maps instance name -> price history.

    ``pdf_cache`` (keyed ``(name, round(bid, 6))``) lets repeated callers —
    the fleet controller re-provisions on every migration — skip rebuilding
    failure pdfs from the same history.
    """
    feasible = [it for it in catalog if sla.admits(it)]
    if not feasible:
        raise ValueError("no instance type meets the SLA")
    a_bid = min(it.on_demand for it in feasible)  # Eq. 7

    candidates: dict[str, float] = {}
    best: tuple[float, float, InstanceType] | None = None
    for it in feasible:
        hist = histories.get(it.name)
        if hist is None:
            continue
        if hist.next_available(a_bid, 0.0) is None:
            # Never below A_bid in recorded history: the empty failure pdf is
            # all censored mass, which Eq. 8 would misread as "never fails".
            eet = math.inf
        else:
            key = (it.name, round(a_bid, 6))
            pdf = pdf_cache.get(key) if pdf_cache is not None else None
            if pdf is None:
                pdf = FailurePdf.from_trace(hist, a_bid)
                if pdf_cache is not None:
                    pdf_cache[key] = pdf
            # scale work to this instance's speed
            w_scaled = work_s * (reference_ecu / it.compute_units)
            eet = expected_execution_time(pdf, w_scaled, recovery_s)
        candidates[it.name] = eet
        # ties (incl. the all-infeasible case) break towards cheaper on-demand
        if best is None or (eet, it.on_demand) < (best[0], best[1]):
            best = (eet, it.on_demand, it)
    if best is None:
        raise ValueError("no price history available for any feasible type")
    return ProvisioningDecision(a_bid=a_bid, instance=best[2], eet_s=best[0], candidates=candidates)
