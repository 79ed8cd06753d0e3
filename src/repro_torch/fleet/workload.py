"""Workloads for the fleet subsystem: streams of jobs with arrivals, work
sizes, deadlines and SLAs.

The port's copy of :mod:`repro.fleet.workload`: it draws from the same
``numpy.random.default_rng`` streams in the same order, so the jobs are equal.

Work is expressed in *reference-ECU seconds* (the paper's m1.xlarge, 8 ECU, is
the reference): a job of ``work_s`` takes ``work_s * reference_ecu /
instance.compute_units`` wall seconds of computation on a given type, exactly
as :func:`repro_torch.core.provision.algorithm1` scales work when ranking types by
Expected Execution Time.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np

from repro_torch.core.market import HOUR
from repro_torch.core.provision import SLA


def poisson_arrivals(n_jobs: int, mean_interarrival_s: float, seed: int = 0) -> np.ndarray:
    """``n_jobs`` homogeneous Poisson arrival times (cumulative exponential gaps)."""
    if n_jobs < 0:
        raise ValueError(f"n_jobs must be >= 0, got {n_jobs}")
    if mean_interarrival_s <= 0:
        raise ValueError(f"mean_interarrival_s must be > 0, got {mean_interarrival_s}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(mean_interarrival_s, n_jobs))


def rate_arrivals(rates_per_s: Sequence[float], period_s: float, seed: int = 0) -> np.ndarray:
    """Arrival times of a non-homogeneous Poisson process, by thinning.

    ``rates_per_s`` is a piecewise-constant rate trace — one entry per
    ``period_s`` seconds, e.g. a diurnal request-rate trace from
    :meth:`repro.serving.traffic.TrafficModel.rates` — and the returned arrivals
    cover ``len(rates_per_s) * period_s`` seconds of it.  Candidates are
    drawn at the peak rate and kept with probability ``rate(t) / peak``,
    which is exact for any bounded rate function.
    """
    rates = np.asarray(rates_per_s, dtype=float)
    if rates.ndim != 1 or (rates < 0).any():
        raise ValueError("rates_per_s must be a 1-d non-negative trace")
    if period_s <= 0:
        raise ValueError(f"period_s must be > 0, got {period_s}")
    horizon_s = rates.size * period_s
    peak = float(rates.max(initial=0.0))
    if peak == 0.0:
        return np.empty(0)
    rng = np.random.default_rng(seed)
    times: list[np.ndarray] = []
    t = 0.0
    # draw homogeneous candidates in chunks until the horizon is covered
    chunk = max(256, int(peak * horizon_s * 1.1))
    while t < horizon_s:
        gaps = rng.exponential(1.0 / peak, chunk)
        cand = t + np.cumsum(gaps)
        keep = rng.random(chunk) < rates[np.minimum(cand / period_s, rates.size - 1).astype(int)] / peak
        times.append(cand[keep & (cand < horizon_s)])
        t = float(cand[-1])
    return np.concatenate(times)


@dataclasses.dataclass(frozen=True)
class Job:
    """One unit of demand on the fleet."""

    id: int
    arrival_s: float
    work_s: float  # reference-ECU seconds of compute
    deadline_s: float | None = None  # absolute wall-clock deadline (None = best effort)
    sla: SLA = dataclasses.field(default_factory=SLA)

    def __post_init__(self):
        if self.arrival_s < 0 or self.work_s <= 0:
            raise ValueError(f"job {self.id}: bad arrival/work ({self.arrival_s}, {self.work_s})")
        if self.deadline_s is not None and self.deadline_s <= self.arrival_s:
            raise ValueError(f"job {self.id}: deadline before arrival")


@dataclasses.dataclass(frozen=True)
class Workload:
    """An ordered stream of jobs (sorted by arrival time)."""

    jobs: tuple[Job, ...]

    def __post_init__(self):
        arrivals = [j.arrival_s for j in self.jobs]
        if arrivals != sorted(arrivals):
            raise ValueError("jobs must be sorted by arrival time")
        ids = [j.id for j in self.jobs]
        if len(set(ids)) != len(ids):
            raise ValueError("job ids must be unique")

    def __len__(self) -> int:
        return len(self.jobs)

    def __iter__(self) -> Iterator[Job]:
        return iter(self.jobs)

    @property
    def total_work_s(self) -> float:
        return sum(j.work_s for j in self.jobs)

    def merge(self, *others: "Workload") -> "Workload":
        """Interleave job streams into one arrival-sorted workload.

        Jobs are renumbered ``0..n-1`` in merged order — each source stream
        numbers its jobs independently, so the original ids would collide.
        Arrival ties keep stream order (self first), then in-stream order.
        """
        streams = (self, *others)
        tagged = [(job.arrival_s, si, job) for si, w in enumerate(streams) for job in w]
        tagged.sort(key=lambda t: (t[0], t[1]))
        return Workload(
            tuple(dataclasses.replace(job, id=i) for i, (_, _, job) in enumerate(tagged))
        )

    @staticmethod
    def from_arrivals(
        arrivals_s: Sequence[float],
        mean_work_s: float,
        seed: int = 0,
        sla: SLA | None = None,
        work_sigma: float = 0.5,
        deadline_slack: float | None = None,
    ) -> "Workload":
        """Jobs at the given arrival times with lognormal work sizes.

        The bridge from the arrival generators: e.g.
        ``Workload.from_arrivals(rate_arrivals(trace, 300.0), 2 * HOUR)``
        drives the fleet with a diurnal serving-traffic trace.
        """
        sla = sla or SLA()
        arrivals = np.asarray(arrivals_s, dtype=float)
        if arrivals.ndim != 1 or (np.diff(arrivals) < 0).any():
            raise ValueError("arrivals_s must be a 1-d non-decreasing sequence")
        rng = np.random.default_rng(seed)
        mu = np.log(mean_work_s) - 0.5 * work_sigma**2
        works = np.maximum(rng.lognormal(mu, work_sigma, arrivals.size), 60.0)
        jobs = []
        for i in range(arrivals.size):
            a, w = float(arrivals[i]), float(works[i])
            d = a + deadline_slack * w if deadline_slack is not None else None
            jobs.append(Job(id=i, arrival_s=a, work_s=w, deadline_s=d, sla=sla))
        return Workload(tuple(jobs))

    @staticmethod
    def batch(
        n_jobs: int,
        work_s: float,
        sla: SLA | None = None,
        arrival_s: float = 0.0,
        deadline_s: float | None = None,
    ) -> "Workload":
        """``n_jobs`` identical jobs arriving at once (a cluster submission)."""
        sla = sla or SLA()
        return Workload(
            tuple(
                Job(id=i, arrival_s=arrival_s, work_s=work_s, deadline_s=deadline_s, sla=sla)
                for i in range(n_jobs)
            )
        )

    @staticmethod
    def poisson(
        n_jobs: int,
        mean_interarrival_s: float,
        mean_work_s: float,
        seed: int = 0,
        sla: SLA | None = None,
        work_sigma: float = 0.5,
        deadline_slack: float | None = None,
    ) -> "Workload":
        """Poisson arrivals with lognormal work sizes.

        ``deadline_slack`` (if set) gives each job a deadline of
        ``arrival + slack * work`` — e.g. 3.0 allows 3x the ideal runtime.
        """
        sla = sla or SLA()
        rng = np.random.default_rng(seed)
        arrivals = np.cumsum(rng.exponential(mean_interarrival_s, n_jobs))
        # lognormal with the requested mean: E[e^X] = e^{mu + sigma^2/2}
        mu = np.log(mean_work_s) - 0.5 * work_sigma**2
        works = rng.lognormal(mu, work_sigma, n_jobs)
        works = np.maximum(works, 60.0)
        jobs = []
        for i in range(n_jobs):
            a = float(arrivals[i])
            w = float(works[i])
            d = a + deadline_slack * w if deadline_slack is not None else None
            jobs.append(Job(id=i, arrival_s=a, work_s=w, deadline_s=d, sla=sla))
        return Workload(tuple(jobs))

    @staticmethod
    def from_sizes(
        sizes_h: Sequence[float],
        interarrival_s: float = HOUR,
        sla: SLA | None = None,
    ) -> "Workload":
        """Deterministic workload from a list of job sizes in hours."""
        sla = sla or SLA()
        return Workload(
            tuple(
                Job(id=i, arrival_s=i * interarrival_s, work_s=h * HOUR, sla=sla)
                for i, h in enumerate(sizes_h)
            )
        )
