"""Checkpointing schemes for spot instances (paper §V and §VI).

Five schemes from Yi et al. [3] re-simulated under corrected billing, plus the
paper's contribution, ACC:

  NONE  — never checkpoint; every out-of-bid kill restarts the job from zero.
  OPT   — oracle: a checkpoint completes exactly at each kill instant.
  HOUR  — a checkpoint completes exactly at each instance-hour boundary.
  EDGE  — a checkpoint starts at every rising edge of the spot price.
  ADAPT — at a fixed cadence, checkpoint iff the expected recovery time of
          skipping exceeds that of taking (hazard estimated from history).
  ACC   — the paper's Application-Centric Checkpointing: bid S_bid ~ infinity
          on the instance (never provider-killed) and make checkpoint /
          terminate decisions at the decision points of Eq. (3)-(4):
              t_cd = t_h - t_c - t_w      (checkpoint decision)
              t_td = t_h - t_w            (terminate decision)
          relative to each instance-hour boundary t_h, against the
          *application* bid A_bid.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from repro_torch.core.market import HOUR, PriceTrace


class Scheme(enum.Enum):
    NONE = "none"
    OPT = "opt"
    HOUR = "hour"
    EDGE = "edge"
    ADAPT = "adapt"
    ACC = "acc"



@dataclasses.dataclass(frozen=True)
class SimParams:
    """Simulation constants (defaults follow Yi et al.'s setup)."""

    t_c: float = 300.0  # checkpoint write time (s)
    t_r: float = 600.0  # restart/recovery overhead per (re)launch (s)
    t_w: float = 5.0  # spot-price query latency (s) — ACC decision points
    poll_s: float = 60.0  # relaunch polling period (user-defined, paper §VI-B)
    adapt_interval_s: float = 600.0  # ADAPT decision cadence
    billing_period_s: float = HOUR

    def __post_init__(self):
        if self.t_c < 0 or self.t_r < 0 or self.t_w < 0:
            raise ValueError("t_c, t_r and t_w must be non-negative")
        if self.t_c + self.t_w >= self.billing_period_s:
            raise ValueError("decision points must fall inside the hour")


# ---------------------------------------------------------------------------
# Empirical failure model (the source of the ADAPT decision tables)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FailurePdf:
    """Empirical pdf of out-of-bid failure age, built from price history.

    ``pdf[k]`` is the probability that an availability period (for the given
    bid) lasts between ``k`` and ``k+1`` bins of ``bin_s`` seconds.  A period
    that survives to the trace horizon is censored and counted in the tail
    mass ``censored``.

    Survival queries go through a lazily-built *binned survival table*
    (:meth:`survival_table`), the numeric source of the batched ADAPT
    decision tables (:class:`repro_torch.engine.kernels.AdaptTables`).
    """

    #: default binning of :meth:`from_trace` (one minute bins, a 7-day range)
    DEFAULT_BIN_S = 60.0
    DEFAULT_MAX_BINS = 7 * 24 * 60

    bin_s: float
    pdf: np.ndarray  # (K,)
    censored: float  # mass of periods that never failed in-history

    @staticmethod
    def from_trace(trace: PriceTrace, bid: float, bin_s: float = DEFAULT_BIN_S, max_bins: int = DEFAULT_MAX_BINS) -> "FailurePdf":
        periods = trace.available_periods(bid)
        durations = []
        censored_n = 0
        for a, b in periods:
            if b >= trace.horizon:  # censored: never observed to fail
                censored_n += 1
            else:
                durations.append(b - a)
        n = len(durations) + censored_n
        pdf = np.zeros(max_bins)
        if n == 0:
            return FailurePdf(bin_s=bin_s, pdf=pdf, censored=1.0)
        for d in durations:
            k = min(int(d / bin_s), max_bins - 1)
            pdf[k] += 1.0 / n
        return FailurePdf(bin_s=bin_s, pdf=pdf, censored=censored_n / n)

    def survival_table(self) -> np.ndarray:
        """``(K+1,)`` binned survival values: entry ``k < K`` is
        P(period outlives ``k`` full bins) = ``1 - cumsum(pdf)[k-1]``
        (``1.0`` at ``k=0``); entry ``K`` is the censored tail mass.

        Built once per pdf and cached — every :meth:`survival` query (and the
        batched ADAPT decision table derived from it) reads these exact
        floats, so scalar and lockstep hazard decisions can never diverge.
        """
        tab = getattr(self, "_survival_table", None)
        if tab is None:
            K = len(self.pdf)
            tab = np.empty(K + 1)
            tab[0] = 1.0
            tab[1:K] = 1.0 - np.cumsum(self.pdf)[: K - 1]
            tab[K] = self.censored
            object.__setattr__(self, "_survival_table", tab)  # frozen-safe cache
        return tab

    def compact_survival(self) -> tuple[np.ndarray, int]:
        """``(values, top)`` — the survival table with its constant plateau
        folded away.  ``values[k]`` for ``k <= top`` are the leading survival
        entries, ``values[top + 1]`` is the censored tail; ages binned past
        ``top`` (but below ``len(pdf)``) read the plateau value ``values[top]``
        because the cumulative sum is bitwise constant once the pdf runs out
        of mass.  This is what the batched ADAPT decision tables pack per (market,
        bid) cell — a 7-day pdf compresses from 10081 entries to the observed
        failure range.

        Cached per pdf like :meth:`survival_table`: every consumer in one
        process shares the same array object.
        """
        cached = getattr(self, "_compact_survival", None)
        if cached is None:
            tab = self.survival_table()
            K = len(self.pdf)
            nz = np.nonzero(self.pdf)[0]
            top = int(min(nz[-1] + 1 if nz.size else 0, K - 1))
            cached = np.concatenate([tab[: top + 1], [self.censored]]), top
            object.__setattr__(self, "_compact_survival", cached)  # frozen-safe
        return cached
