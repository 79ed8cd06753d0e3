"""Cross-backend parity: the torch engine against the scalar reference.

The port of :mod:`repro.engine.parity`.  The torch engine is trusted because
this module can show, scenario by scenario, that it reproduces the scalar
:class:`~repro_torch.engine.reference.ReferenceEngine` in every (market,
bid, scheme) cell.  The two share no simulation *control flow* (one walks
events in Python, the other walks lockstep tensors), and the float
expressions are mirrored by construction, so the comparison is ``==``.

One field is the exception: the reference folds a cell's run costs with the
builtin ``sum()``, which Python 3.12 compensates, and the engine with a
left-to-right fold (the same as ``repro``'s batch and jax engines), so
``cost`` may differ by a few ulp.  ``cost`` is therefore held within
:data:`COST_RTOL` of the reference (``|candidate - reference| <= COST_RTOL *
|reference|``); every other field is ``==``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.engine.base import Engine, EngineResult, get_engine
from repro_torch.engine.reference import ReferenceEngine
from repro_torch.engine.scenario import Scenario

#: Array fields compared cell-for-cell (exact equality, inf == inf).
COMPARED = (
    "completed",
    "completion_time",
    "cost",
    "n_checkpoints",
    "n_kills",
    "n_self_terminations",
    "work_lost_s",
)

#: Relative tolerance of ``cost`` against the reference's compensated
#: ``sum()``: a left-to-right fold of n nonnegative run costs is within
#: (n - 1) * 2**-53 of the exact sum, far under this for any job's run count.
COST_RTOL = 1e-12


@dataclasses.dataclass
class CellMismatch:
    field: str
    market: str
    seed: int
    bid: float
    scheme: str
    reference: float
    candidate: float


@dataclasses.dataclass
class ParityReport:
    scenario: Scenario
    reference: EngineResult
    candidate: EngineResult
    mismatches: list[CellMismatch]

    @property
    def ok(self) -> bool:
        return not self.mismatches

    def __str__(self) -> str:
        name = self.candidate.engine
        if self.ok:
            return f"parity OK over {self.reference.n_cells} cells ({name} vs reference)"
        lines = [f"parity FAILED ({name} vs reference): {len(self.mismatches)} mismatching cells"]
        for mm in self.mismatches[:20]:
            lines.append(
                f"  {mm.field}[{mm.market} seed={mm.seed} bid={mm.bid:.3f} {mm.scheme}] "
                f"reference={mm.reference!r} {name}={mm.candidate!r}"
            )
        if len(self.mismatches) > 20:
            lines.append(f"  ... and {len(self.mismatches) - 20} more")
        return "\n".join(lines)


def compare_results(scenario: Scenario, ref: EngineResult, cand: EngineResult) -> ParityReport:
    """Diff two already-computed results cell-for-cell: exact equality, and
    ``cost`` within :data:`COST_RTOL` of the reference."""
    mismatches: list[CellMismatch] = []
    for field in COMPARED:
        r = getattr(ref, field)
        c = getattr(cand, field)
        # exact equality (inf == inf holds; a NaN would rightly flag itself)
        eq = r == c
        if field == "cost":
            eq |= np.abs(c - r) <= COST_RTOL * np.abs(r)
        for m, bi, si in zip(*np.nonzero(~eq)):
            cellm = ref.markets[m]
            mismatches.append(
                CellMismatch(
                    field=field,
                    market=cellm.label,
                    seed=cellm.seed,
                    bid=ref.bids[bi],
                    scheme=ref.schemes[si].value,
                    reference=r[m, bi, si],
                    candidate=c[m, bi, si],
                )
            )
    return ParityReport(scenario=scenario, reference=ref, candidate=cand, mismatches=mismatches)


def compare_engines(scenario: Scenario, engine: str | Engine = "auto", device=None) -> ParityReport:
    """Run the reference and ``engine`` on ``scenario``, diff every compared
    field.  ``engine`` may be a backend name (with ``device``: the GPU unless
    it says otherwise) or an engine instance."""
    ref = ReferenceEngine(keep_runs=False).run(scenario)
    eng = get_engine(engine, device=device) if isinstance(engine, str) else engine
    cand = eng.run(scenario)
    return compare_results(scenario, ref, cand)


def assert_parity(scenario: Scenario, engine: str | Engine = "auto", device=None) -> ParityReport:
    """Raise ``AssertionError`` (with per-cell detail) unless both backends
    agree; returns the report otherwise."""
    report = compare_engines(scenario, engine, device)
    if not report.ok:
        raise AssertionError(str(report))
    return report
