"""Spot-market substrate: instance catalog and price traces.

The paper evaluates on the 64 Amazon EC2 spot instance types of 2011/2012
(8 hardware types x 4 regions x 2 OS) using the 3-month price history that
Amazon publishes for free.  Those historical traces are not redistributable,
so this module provides

  * an :class:`InstanceType` catalog matching the 2011 EC2 price sheet, and
  * a calibrated regime-switching trace generator whose marginal statistics
    (band around ~0.55-0.65x on-demand, occasional spikes above on-demand,
    price-change cadence of tens of minutes, $0.001 price grid) match the
    qualitative properties reported for the eu-west-1 m1.xlarge traces used
    in the paper and in Yi et al. [3].

Traces are piecewise-constant: ``prices[i]`` holds on ``[times[i], times[i+1])``.
Everything is deterministic given a seed, and the generated traces are
bit-identical to those of :mod:`repro.core.market` for the same seed: both
draw from the same ``numpy.random.default_rng`` streams in the same order.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Sequence

import numpy as np

HOUR = 3600.0

# ---------------------------------------------------------------------------
# Instance catalog (2011 EC2 price sheet, us-east linux baseline; regional and
# OS multipliers reproduce the 64-type grid used by the paper / Yi et al.).
# ---------------------------------------------------------------------------

_BASE_TYPES = {
    # name: on-demand $/h (linux, us-east, 2011)
    "m1.small": 0.085,
    "m1.large": 0.34,
    "m1.xlarge": 0.68,
    "c1.medium": 0.17,
    "c1.xlarge": 0.68,
    "m2.xlarge": 0.50,
    "m2.2xlarge": 1.00,
    "m2.4xlarge": 2.00,
}

_REGIONS = {
    "us-east-1": 1.00,
    "us-west-1": 1.10,
    "eu-west-1": 1.10,
    "ap-southeast-1": 1.12,
}

_OS = {
    "linux": 1.00,
    "windows": 1.35,
}


@dataclasses.dataclass(frozen=True)
class InstanceType:
    """One (hardware, region, os) cell of the 64-type catalog."""

    name: str
    hardware: str
    region: str
    os: str
    on_demand: float  # $/h
    compute_units: float  # relative ECU throughput (scales job speed)


_ECU = {
    "m1.small": 1.0,
    "m1.large": 4.0,
    "m1.xlarge": 8.0,
    "c1.medium": 5.0,
    "c1.xlarge": 20.0,
    "m2.xlarge": 6.5,
    "m2.2xlarge": 13.0,
    "m2.4xlarge": 26.0,
}


def catalog() -> list[InstanceType]:
    """The 64 instance types used by the paper's evaluation."""
    out = []
    for hw, base in _BASE_TYPES.items():
        for region, rmul in _REGIONS.items():
            for os_name, omul in _OS.items():
                price = round(base * rmul * omul, 3)
                out.append(
                    InstanceType(
                        name=f"{hw}.{region}.{os_name}",
                        hardware=hw,
                        region=region,
                        os=os_name,
                        on_demand=price,
                        compute_units=_ECU[hw],
                    )
                )
    assert len(out) == 64
    return out


def get_instance(hardware: str, region: str = "eu-west-1", os_name: str = "linux") -> InstanceType:
    for it in catalog():
        if it.hardware == hardware and it.region == region and it.os == os_name:
            return it
    raise KeyError(f"{hardware}/{region}/{os_name}")


# ---------------------------------------------------------------------------
# Price traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PriceTrace:
    """Piecewise-constant spot-price trace.

    ``prices[i]`` holds on ``[times[i], times[i+1])``; ``times[0] == 0`` and
    ``times[-1]`` is the horizon.  After the horizon the last price holds
    (simulations must finish inside the horizon; the engine checks).
    """

    times: np.ndarray  # (N+1,) float64, strictly increasing
    prices: np.ndarray  # (N,) float64

    def __post_init__(self):
        if self.times.ndim != 1 or self.prices.ndim != 1:
            raise ValueError("times and prices must be 1-D")
        if len(self.times) != len(self.prices) + 1:
            raise ValueError("times must have one more entry than prices")
        if self.times[0] != 0.0:
            raise ValueError("a trace starts at t = 0")
        if not np.all(np.diff(self.times) > 0):
            raise ValueError("times must be strictly increasing")

    @property
    def horizon(self) -> float:
        return float(self.times[-1])

    def available_periods(self, bid: float) -> list[tuple[float, float]]:
        """Maximal intervals where ``price <= bid`` (instance can run).

        Vectorized (``np.diff``/``np.nonzero`` over the segment mask): this is
        the hot path of every (scheme, bid) sweep and of fleet simulations.
        """
        ok = self.prices <= bid
        if not ok.any():
            return []
        edges = np.diff(ok.astype(np.int8))
        starts = np.nonzero(edges == 1)[0] + 1
        ends = np.nonzero(edges == -1)[0] + 1
        if ok[0]:
            starts = np.concatenate(([0], starts))
        if ok[-1]:
            ends = np.concatenate((ends, [len(self.prices)]))
        # times[len(prices)] is the horizon, so both cases read self.times.
        return [(float(self.times[s]), float(self.times[e])) for s, e in zip(starts, ends)]

    def rising_edges(self) -> np.ndarray:
        """Times at which the price strictly increases."""
        idx = np.nonzero(np.diff(self.prices) > 0)[0] + 1
        return self.times[idx]


@dataclasses.dataclass(frozen=True)
class TraceModel:
    """Regime-switching generator calibrated to 2011 EC2 spot dynamics.

    Three regimes, matching the qualitative shape of the published m1.xlarge
    eu-west-1 history that the paper sweeps bids over:

      * *base*     — tight band just above the reserve floor (~0.53x on-demand);
                     the instance is available for any bid in the paper's sweep.
      * *elevated* — excursions a few percent above the base band, lasting tens
                     of minutes, a handful of times per day; these are the
                     out-of-bid events the schemes must survive.
      * *spike*    — rare jumps towards/above on-demand.

    Dwell times are exponential; prices land on the $0.001 grid the paper
    sweeps bids on.
    """

    base_center: float  # ~0.53 x on-demand (just below the paper's bid sweep)
    base_jitter: float  # +- jitter inside the base band
    elevated_low: float  # excursion band straddling the bid sweep
    elevated_high: float
    spike_low: float
    spike_high: float
    p_elevated: float = 0.18  # base -> elevated switch prob. per segment
    p_spike: float = 0.10  # elevated -> spike escalation prob.
    dwell_base_s: float = 3600.0
    dwell_elevated_s: float = 1800.0
    dwell_spike_s: float = 600.0
    grid: float = 0.001

    @staticmethod
    def for_instance(it: InstanceType) -> "TraceModel":
        od = it.on_demand
        return TraceModel(
            base_center=0.530 * od,
            base_jitter=0.008 * od,
            elevated_low=0.535 * od,
            elevated_high=0.60 * od,
            spike_low=0.75 * od,
            spike_high=2.5 * od,
        )

    def sample(self, horizon_s: float, seed: int) -> PriceTrace:
        rng = np.random.default_rng(seed)
        times = [0.0]
        prices: list[float] = []
        t = 0.0
        regime = "base"
        while t < horizon_s:
            if regime == "base":
                p = rng.normal(self.base_center, self.base_jitter)
                dwell = rng.exponential(self.dwell_base_s)
            elif regime == "elevated":
                p = rng.uniform(self.elevated_low, self.elevated_high)
                dwell = rng.exponential(self.dwell_elevated_s)
            else:  # spike
                p = rng.uniform(self.spike_low, self.spike_high)
                dwell = rng.exponential(self.dwell_spike_s)
            prices.append(max(self.grid, round(float(p) / self.grid) * self.grid))
            t += max(30.0, dwell)  # EC2 never updated faster than ~30 s
            times.append(min(t, horizon_s))
            u = rng.random()
            if regime == "base":
                regime = "elevated" if u < self.p_elevated else "base"
            elif regime == "elevated":
                if u < self.p_spike:
                    regime = "spike"
                elif u < 0.75:
                    regime = "base"
            else:
                regime = "base" if u < 0.7 else "elevated"
        return PriceTrace(times=np.asarray(times), prices=np.asarray(prices))


def sample_traces_batch(
    models: Sequence[TraceModel],
    horizon_s: float,
    seeds: Sequence[int],
) -> list[PriceTrace]:
    """NumPy-batched trace generation: one trace per (model, seed) pair.

    The regime-switching Markov chain is advanced once per segment for the
    whole batch (a few thousand vector steps) instead of once per segment per
    trace in Python, so generating the full 64-type x many-seed grid of a
    fleet sweep takes tens of milliseconds rather than seconds.

    Each entry draws from its own ``default_rng(seed)`` stream, so a trace is
    deterministic in ``(model, horizon_s, seed)`` regardless of what else is
    in the batch.  The stream call *order* differs from :meth:`TraceModel.sample`
    (bulk array draws vs per-segment draws), so batched traces are
    statistically identical but not bitwise equal to scalar ones.
    """
    if len(models) != len(seeds):
        raise ValueError("models and seeds must have equal length")
    n = len(models)
    if n == 0:
        return []
    # Expected segment dwell is ~3100 s under the stationary regime mix;
    # 2x headroom makes running out of pre-drawn segments astronomically rare
    # (scalar fallback below covers it).
    k_max = max(64, int(horizon_s / 1500.0))

    u = np.empty((n, k_max))  # regime-transition uniforms
    z = np.empty((n, k_max))  # base-band normals
    e = np.empty((n, k_max))  # dwell exponentials
    v = np.empty((n, k_max))  # elevated/spike uniforms
    for b, seed in enumerate(seeds):
        rng = np.random.default_rng(seed)
        u[b] = rng.random(k_max)
        z[b] = rng.standard_normal(k_max)
        e[b] = rng.exponential(1.0, k_max)
        v[b] = rng.random(k_max)

    def col(attr: str) -> np.ndarray:
        return np.asarray([getattr(m, attr) for m in models])[:, None]

    p_elevated, p_spike = col("p_elevated"), col("p_spike")
    regimes = np.empty((n, k_max), dtype=np.int8)  # 0 base, 1 elevated, 2 spike
    regime = np.zeros(n, dtype=np.int8)
    pe, ps = p_elevated[:, 0], p_spike[:, 0]
    for k in range(k_max):
        regimes[:, k] = regime
        uk = u[:, k]
        from_base = np.where(uk < pe, 1, 0)
        from_elev = np.where(uk < ps, 2, np.where(uk < 0.75, 0, 1))
        from_spike = np.where(uk < 0.7, 0, 1)
        regime = np.select(
            [regime == 0, regime == 1], [from_base, from_elev], default=from_spike
        ).astype(np.int8)

    is_base, is_elev, is_spike = regimes == 0, regimes == 1, regimes == 2
    price_base = col("base_center") + col("base_jitter") * z
    price_elev = col("elevated_low") + (col("elevated_high") - col("elevated_low")) * v
    price_spike = col("spike_low") + (col("spike_high") - col("spike_low")) * v
    prices = np.select([is_base, is_elev, is_spike], [price_base, price_elev, price_spike])
    grid = col("grid")
    prices = np.maximum(grid, np.round(prices / grid) * grid)

    dwell_scale = np.select(
        [is_base, is_elev, is_spike],
        [col("dwell_base_s"), col("dwell_elevated_s"), col("dwell_spike_s")],
    )
    dwell = np.maximum(30.0, e * dwell_scale)
    cum = np.cumsum(dwell, axis=1)

    out: list[PriceTrace] = []
    for b in range(n):
        if cum[b, -1] < horizon_s:  # ran out of pre-drawn segments
            out.append(models[b].sample(horizon_s, seeds[b]))
            continue
        n_seg = int(np.searchsorted(cum[b], horizon_s)) + 1
        times = np.concatenate(([0.0], cum[b, :n_seg]))
        times[-1] = min(times[-1], horizon_s)
        out.append(PriceTrace(times=times, prices=prices[b, :n_seg].copy()))
    return out


def synthetic_trace(
    instance: InstanceType,
    horizon_days: float = 30.0,
    seed: int = 0,
) -> PriceTrace:
    """Convenience: calibrated trace for one instance type."""
    model = TraceModel.for_instance(instance)
    return model.sample(horizon_days * 24 * HOUR, seed)


def ensemble_seed(instance: InstanceType, base_seed: int = 0, i: int = 0) -> int:
    """Decorrelated per-instance seed.

    ``trace_ensemble(it, seed=s)`` uses raw seeds ``s*1000 + i`` for every
    instance type, so two *different* types sampled with the same base seed
    share an rng stream: their model parameters all scale linearly with the
    on-demand price, making the traces near-proportional — a price spike then
    hits every type simultaneously and silently defeats fleet
    diversification.  Mixing the instance name into the seed restores
    independence while staying deterministic.
    """
    if base_seed < 0:
        raise ValueError("base_seed must be non-negative")
    h = zlib.crc32(instance.name.encode())
    return ((base_seed * 1000 + i) << 32) | h


def step_trace(segments: Sequence[tuple[float, float]], horizon_s: float | None = None) -> PriceTrace:
    """Build a trace from (start_time, price) pairs; for tests."""
    starts = [s for s, _ in segments]
    if starts[0] != 0.0 or starts != sorted(starts):
        raise ValueError("segments must start at 0.0 and be sorted by start time")
    horizon = horizon_s if horizon_s is not None else starts[-1] + 30 * 24 * HOUR
    times = np.asarray(list(starts) + [horizon])
    prices = np.asarray([p for _, p in segments])
    return PriceTrace(times=times, prices=prices)
