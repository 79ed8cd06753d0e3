"""Request-traffic models: seeded deterministic per-period arrival rates.

The port's copy of :mod:`repro.serving.traffic`, host NumPy.  Rates are made
once per scenario with ``np.sin`` / ``np.exp``, whose bits a device ``sin`` /
``exp`` does not reproduce, so they stay on the host and go to the device
as data.

A serving tier is driven by an *offered rate* path rather than a job stream:
the control loop samples traffic once per control period and scales against
it.  :class:`TrafficModel` composes three ingredients, matching the workload
shapes of Qu, Calheiros & Buyya's auto-scaling study (PAPERS.md, arxiv
1509.05197):

  * a **diurnal sinusoid** — the day/night cycle of "millions of users",
    ``base_rps * (1 + amplitude * sin(2 pi t / period))``;
  * **flash crowds** — Gaussian bursts at seeded random times, each peaking
    at up to ``flash_magnitude x base_rps`` (the unpredictable component an
    autoscaler must chase);
  * **Poisson jitter** — per-period sampling noise with the shot-noise scale
    ``sqrt(rate / period_s)``, so quiet periods are *exactly* quiet
    (``rate == 0`` stays bitwise zero: the zero-traffic market anchor).

Everything is deterministic in ``(model, horizon, period, seed)``: each seed
draws from its own ``default_rng`` stream via :func:`traffic_seed`, the same
decorrelation recipe as :func:`repro_torch.core.market.ensemble_seed` — a rate path
never depends on what else is in a batch, so the scalar reference engine and
the lockstep batch engine consume bit-identical traffic.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.market import HOUR

__all__ = ["TrafficModel", "traffic_seed", "rates_batch"]

#: Stream label mixed into every traffic seed (the ``ensemble_seed`` trick:
#: decorrelates traffic streams from the price-trace streams that share the
#: same base seeds).
_STREAM_TAG = zlib.crc32(b"serving.traffic")


def traffic_seed(base_seed: int, i: int = 0) -> int:
    """Decorrelated per-stream seed for traffic sampling.

    Mirrors :func:`repro_torch.core.market.ensemble_seed`: mixing a stream tag into
    the seed keeps traffic draws independent of the price-trace draws made
    with the same ``base_seed`` while staying a pure function of its inputs.
    """
    if base_seed < 0:
        raise ValueError("base_seed must be non-negative")
    return ((base_seed * 1000 + i) << 32) | _STREAM_TAG


@dataclasses.dataclass(frozen=True)
class TrafficModel:
    """Diurnal + flash-crowd + jitter request-rate generator.

    ``flash_crowds`` bursts are placed uniformly over the horizon with peak
    multipliers drawn in ``[1, flash_magnitude]``; each burst is a Gaussian
    bump of total width ~``flash_duration_s`` (sigma = duration / 4).
    ``jitter`` scales shot noise: the per-period rate gets
    ``jitter * z * sqrt(rate / period_s)`` added (``z`` standard normal),
    which is the sampling error of counting a Poisson process over one
    control period.  Rates are clipped at zero.
    """

    base_rps: float = 2000.0
    diurnal_amplitude: float = 0.6
    diurnal_period_s: float = 24 * HOUR
    diurnal_phase_s: float = 0.0
    flash_crowds: int = 0
    flash_magnitude: float = 3.0
    flash_duration_s: float = 1800.0
    jitter: float = 1.0

    def __post_init__(self):
        if self.base_rps < 0:
            raise ValueError(f"base_rps must be >= 0, got {self.base_rps}")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            raise ValueError(f"diurnal_amplitude must be in [0, 1], got {self.diurnal_amplitude}")
        if self.diurnal_period_s <= 0:
            raise ValueError("diurnal_period_s must be positive")
        if self.flash_crowds < 0:
            raise ValueError("flash_crowds must be >= 0")
        if self.flash_magnitude < 1.0:
            raise ValueError(f"flash_magnitude must be >= 1, got {self.flash_magnitude}")
        if self.flash_duration_s <= 0:
            raise ValueError("flash_duration_s must be positive")
        if self.jitter < 0:
            raise ValueError("jitter must be >= 0")

    def rates(self, horizon_s: float, period_s: float, seed: int) -> np.ndarray:
        """Offered request rate (rps) per control period, shape ``(P,)``.

        Vectorized over periods (one rng call per ingredient, not per
        period); sampled at period midpoints.  Deterministic in
        ``(self, horizon_s, period_s, seed)`` via :func:`traffic_seed`.
        """
        if period_s <= 0 or horizon_s < period_s:
            raise ValueError(f"need horizon_s >= period_s > 0, got {horizon_s}, {period_s}")
        n_periods = int(horizon_s // period_s)
        t = (np.arange(n_periods, dtype=np.float64) + 0.5) * period_s
        rng = np.random.default_rng(traffic_seed(seed))
        # fixed draw order: flash placement first, then per-period jitter
        starts = rng.uniform(0.0, horizon_s, self.flash_crowds)
        peaks = rng.uniform(1.0, self.flash_magnitude, self.flash_crowds)
        z = rng.standard_normal(n_periods)

        phase = 2.0 * np.pi * (t - self.diurnal_phase_s) / self.diurnal_period_s
        rate = self.base_rps * (1.0 + self.diurnal_amplitude * np.sin(phase))
        sigma = self.flash_duration_s / 4.0
        for k in range(self.flash_crowds):
            bump = np.exp(-0.5 * ((t - starts[k]) / sigma) ** 2)
            rate = rate + self.base_rps * (peaks[k] - 1.0) * bump
        rate = np.maximum(rate, 0.0)
        # shot noise: zero traffic stays bitwise zero (sqrt(0) * z == 0)
        rate = rate + self.jitter * z * np.sqrt(rate / period_s)
        return np.maximum(rate, 0.0)


def rates_batch(
    model: TrafficModel, horizon_s: float, period_s: float, seeds
) -> np.ndarray:
    """Per-seed rate paths stacked to ``(n_seeds, P)``.

    Each row is exactly :meth:`TrafficModel.rates` for its seed — batched
    generation can never perturb a stream (the contract
    :func:`repro_torch.core.market.sample_traces_batch` documents for traces).
    """
    return np.stack([model.rates(horizon_s, period_s, int(s)) for s in seeds])
