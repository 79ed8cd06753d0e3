"""Resumable suite execution: run only the cells the store does not have.

The port's copy of :mod:`repro.suite.runner`, with the device threaded
through to the engines.  Engine ids stay honest, so a key names what
produced the run: sweep cells of ``engine = "auto"`` run on the port's
:class:`~repro_torch.engine.TorchEngine` and key as ``"torch"`` (the JAX
package's ``"auto"`` is its ``"batch"`` engine: another key); serving cells
key as ``"batch"`` / ``"reference"`` as in the JAX package, whose results
they equal bit for bit; fleet cells key as ``"fleet"`` and run, as in the
JAX package's runner, on the host ``FleetController`` (the batch fleet
engine equals it on every field but ``cost``, so its results are not stored
under that key).  :func:`run_suite` resolves the device before it simulates
anything: the GPU unless ``device="cpu"``, raising when there is none — a
pass never falls back to the CPU.

:func:`run_suite` walks a suite's expanded cells in order, computes each
cell's content-addressed run key, and *skips* every cell the
:class:`~repro_torch.suite.store.RunStore` already holds — a cache hit touches the
index only (no payload load, no trace generation, no simulation).  Missing
cells are simulated and flushed to the store one by one, so an interrupted
sweep loses at most the cells in flight and a rerun resumes with exactly the
missing cells.  ``jobs > 1`` spreads the simulations over a thread pool
while keeping every store write on the calling thread.

Telemetry (:mod:`repro_torch.obs`): the runner counts ``suite.cell`` /
``suite.cache_hit`` / ``suite.cache_miss`` and wraps each simulated cell in
a ``suite.cell`` span; the engine's own ``engine.run`` spans nest inside it,
so "the second pass performed zero simulation" is a checkable property —
``tel.counter("suite.cache_hit") == n_cells`` and no ``engine.run`` spans —
which the ``--expect-all-hits`` CLI flag asserts.

Failure containment: one crashing or hanging cell must not abort the pass.
Every cell attempt runs under a :class:`RetryPolicy` (capped exponential
backoff with *deterministic* jitter — the delay is a pure function of the
cell key and attempt number, so reruns replay identically) and, on the
parallel path, under a wall-clock watchdog that abandons cells stuck past
``timeout_s``.  A cell that still fails is recorded as a failed
:class:`CellOutcome` (``record=None``, ``error`` set) while every completed
cell is flushed as usual; the CLI exits nonzero and lists the failures, and
the next pass re-simulates exactly the failed cells.  Corrupt cache hits
(:class:`~repro_torch.suite.store.StoreCorruptionError` on load) self-heal in
:func:`run_stored` / :func:`run_fleet_stored` / :func:`run_serving_stored`
by re-simulating.  Injection
sites for :mod:`repro_torch.faults`: ``suite.worker`` fires once per simulation
attempt (``raise`` = worker crash, ``hang`` = stall), and the store's write
sites are exercised through `_flush_cell`.

:func:`run_stored` / :func:`run_fleet_stored` / :func:`run_serving_stored`
are the single-scenario primitives: cache-or-run one scenario, returning
the result either way.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import time

from repro_torch import faults
from repro_torch.engine.base import EngineResult, get_engine, resolve_device
from repro_torch.engine.fleetgrid import FleetGridResult, run_fleet
from repro_torch.engine.scenario import FleetScenario, Scenario
from repro_torch.obs import telemetry as obs
from repro_torch.serving import ServingResult, ServingScenario, run_serving
from repro_torch.suite.hashing import run_key
from repro_torch.suite.spec import Suite, SuiteCell
from repro_torch.suite.store import RunRecord, RunStore, StoreCorruptionError

__all__ = [
    "CellOutcome",
    "RetryPolicy",
    "SuiteReport",
    "run_suite",
    "run_stored",
    "run_fleet_stored",
    "run_serving_stored",
]

log = logging.getLogger("repro_torch.suite.runner")

faults.register_site("suite.worker", "one hit per cell-simulation attempt (raise | hang)")

#: Engine-name normalization for hashing *before* instantiating a backend,
#: per cell kind: a sweep's ``"auto"`` is the torch engine, serving's the
#: lockstep batch engine.
_ENGINE_ALIAS = {"scenario": {"auto": "torch"}, "serving": {"auto": "batch"}}

#: The engine id fleet cells are keyed under: the host controller's results,
#: as the JAX package's runner stores them.
FLEET_ENGINE = "fleet"

#: Engine ids that run on the host and take no device.
_HOST_ENGINES = ("reference", FLEET_ENGINE)


def _engine_id(cell_kind: str, engine_name: str) -> str:
    if cell_kind == "fleet":
        return FLEET_ENGINE
    return _ENGINE_ALIAS[cell_kind].get(engine_name, engine_name)


def _engine_device(eng_id: str, device):
    """The device an engine is handed: none for the host engines."""
    return None if eng_id in _HOST_ENGINES else device


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-cell retry/backoff/watchdog knobs for :func:`run_suite`.

    Backoff for attempt ``n`` (1-based) is ``min(cap, base * 2**(n-1))``
    scaled by a deterministic jitter in ``[0.5, 1.0)`` derived from the cell
    key — retries de-synchronize across cells without introducing run-to-run
    nondeterminism.  ``timeout_s`` is the parallel path's wall-clock
    watchdog: a cell whose attempt (retries included) exceeds it is abandoned
    and recorded as failed; its worker thread cannot be killed, so the slot
    is lost for the rest of the pass (and the pass degrades gracefully when
    every slot is lost).  ``None`` disables the watchdog.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    timeout_s: float | None = None

    def backoff_s(self, key: str, attempt: int) -> float:
        base = min(self.backoff_cap_s, self.backoff_base_s * 2 ** (attempt - 1))
        digest = hashlib.sha256(f"backoff|{key}|{attempt}".encode()).digest()
        u = int.from_bytes(digest[:8], "big") / 2**64
        return base * (0.5 + 0.5 * u)


@dataclasses.dataclass(frozen=True)
class CellOutcome:
    """How one suite cell was satisfied: from the store, by simulating, or
    — when every retry failed — not at all (``record is None``)."""

    cell: SuiteCell
    run_key: str
    hit: bool
    record: RunRecord | None
    wall_s: float  # this pass's wall time (0.0 for a cache hit)
    error: str | None = None  # why the cell failed (None = satisfied)
    attempts: int = 1  # simulation attempts consumed this pass

    @property
    def failed(self) -> bool:
        return self.record is None


@dataclasses.dataclass
class SuiteReport:
    """Outcome of one :func:`run_suite` pass."""

    suite: Suite
    outcomes: list[CellOutcome]
    wall_s: float
    n_skipped: int = 0  # cells left unexecuted by --max-cells

    @property
    def n_hits(self) -> int:
        return sum(1 for o in self.outcomes if o.hit)

    @property
    def n_misses(self) -> int:
        return sum(1 for o in self.outcomes if not o.hit and not o.failed)

    @property
    def n_failed(self) -> int:
        return sum(1 for o in self.outcomes if o.failed)

    @property
    def failures(self) -> list[CellOutcome]:
        return [o for o in self.outcomes if o.failed]

    @property
    def ok(self) -> bool:
        return self.n_failed == 0

    def summary(self) -> str:
        """Fixed-width per-cell table plus a hit/miss/failure footer."""
        width = max([len(o.cell.label) for o in self.outcomes] + [4])
        lines = [f"# suite {self.suite.name}: {len(self.outcomes)} cells"]
        lines.append(f"{'cell':<{width}}  {'engine':<9} {'source':<6} {'cells':>5}  metrics")
        for o in self.outcomes:
            if o.failed:
                lines.append(
                    f"{o.cell.label:<{width}}  {'-':<9} {'FAILED':<6} {'-':>5}  "
                    f"{o.error} (after {o.attempts} attempts)"
                )
                continue
            metrics = "  ".join(f"{k}={v:.4g}" for k, v in sorted(o.record.metrics.items()))
            lines.append(
                f"{o.cell.label:<{width}}  {o.record.engine:<9} "
                f"{'store' if o.hit else 'run':<6} {o.record.n_cells:>5}  {metrics}"
            )
        lines.append(
            f"# {self.n_hits} cache hits, {self.n_misses} simulated"
            + (f", {self.n_failed} FAILED" if self.n_failed else "")
            + (f", {self.n_skipped} skipped (--max-cells)" if self.n_skipped else "")
            + f", wall {self.wall_s:.2f}s"
        )
        return "\n".join(lines)


def _simulate_cell(cell: SuiteCell, eng_id: str, engine: str | None, suite_name: str, key: str, device=None):
    """Simulate one cell (no store access: safe to call from a worker thread).

    The collector's span nesting is per-thread, so the ``suite.cell`` span is
    a root span when this runs on a pool worker — counters aggregate the same
    either way.  The ``suite.worker`` fault site fires once per attempt:
    ``raise`` models a worker crash, ``hang`` a finite stall (long enough to
    trip the watchdog, short enough that the pool can still drain).
    """
    action = faults.current().fire("suite.worker", key=key)
    if action is not None:
        if action.kind == "hang":
            time.sleep(action.delay_s)
        else:
            raise faults.InjectedFault(action)
    tel = obs.current()
    dev = _engine_device(eng_id, device)
    with tel.span("suite.cell", suite=suite_name, cell=cell.label, engine=eng_id):
        if cell.kind == "fleet":
            return run_fleet(cell.scenario, engine="controller")
        if cell.kind == "serving":
            return run_serving(cell.scenario, engine=engine or cell.engine, device=dev)
        return get_engine(engine or cell.engine, device=dev).run(cell.scenario)


def _with_retry(fn, key: str, policy: RetryPolicy, what: str):
    """Run ``fn`` under the retry policy; returns ``(value, attempts)``.

    Counts ``retry.attempts`` at each *re*-attempt and re-raises the last
    exception once the budget is spent.  ``KeyboardInterrupt``/``SystemExit``
    pass straight through (``except Exception``).
    """
    tel = obs.current()
    attempt = 1
    while True:
        try:
            return fn(), attempt
        except Exception as e:
            if attempt >= policy.max_attempts:
                e._attempts = attempt  # let the failure outcome report the true count
                raise
            delay = policy.backoff_s(key, attempt)
            tel.count("retry.attempts")
            log.warning(
                "%s %s failed (%r), retrying in %.3fs (attempt %d/%d)",
                what, key[:12], e, delay, attempt + 1, policy.max_attempts,
            )
            time.sleep(delay)
            attempt += 1


def _flush_cell(store: RunStore, suite_name: str, cell: SuiteCell, key: str, result):
    """Persist one simulated cell (main thread only: the store is not
    thread-safe) and cross-check the content-addressed key."""
    if cell.kind == "fleet":
        rec = store.put_fleet_result(cell.scenario, result, suite=suite_name, cell=cell.label)
    elif cell.kind == "serving":
        rec = store.put_serving_result(cell.scenario, result, suite=suite_name, cell=cell.label)
    else:
        rec = store.put_engine_result(cell.scenario, result, suite=suite_name, cell=cell.label)
    if rec.run_key != key:
        raise AssertionError(f"store key drift: expected {key}, stored {rec.run_key}")
    return rec


def run_suite(
    suite: Suite,
    store: RunStore,
    *,
    engine: str | None = None,
    cli: dict | None = None,
    max_cells: int | None = None,
    jobs: int = 1,
    retry: RetryPolicy | None = None,
    device=None,
) -> SuiteReport:
    """Execute ``suite``, resuming from whatever ``store`` already holds.

    ``engine`` overrides every cell's backend; ``cli`` is the outermost
    override layer (dotted keys, see :func:`repro_torch.suite.layers.nest_dotted`);
    ``max_cells`` bounds the number of cells *simulated* this pass (cache
    hits are free and never count) — the remaining cells are reported as
    skipped and picked up by the next pass, which is also exactly what an
    interrupt-and-rerun does.

    ``jobs > 1`` simulates the missing cells on a thread pool (cache-hit
    classification stays a single in-order pass, so hit/miss/skip semantics
    are identical).  Workers only simulate; every store flush happens on the
    calling thread as results complete, preserving the store's
    payload-then-index crash-safety order without locking.  Outcomes are
    reported in suite order regardless of completion order.

    ``retry`` (default :class:`RetryPolicy()`) governs failure containment:
    each cell's simulation and flush retry independently with backoff, a
    cell that exhausts its budget (or trips the watchdog) becomes a failed
    outcome, and the pass always runs to completion — check
    :attr:`SuiteReport.ok` / ``n_failed`` and rerun to heal.

    ``device`` is where the torch engines run: the GPU unless
    ``device="cpu"``.  It is resolved before the first cell is simulated,
    so a pass with cells to simulate on a machine without a GPU raises
    (rather than recording every cell as failed); host engines
    (``"reference"``, the fleet controller) take no device.
    """
    t0 = time.perf_counter()
    policy = retry if retry is not None else RetryPolicy()
    cells = suite.expand(cli)
    tel = obs.current()
    n_skipped = 0
    with tel.span("suite.run", suite=suite.name, n_cells=len(cells)):
        # classification pass, in suite order: hit, miss, or skipped
        done: dict[int, CellOutcome] = {}
        plan: list[tuple[int, SuiteCell, str, str]] = []  # missing cells
        for idx, cell in enumerate(cells):
            eng_id = _engine_id(cell.kind, engine or cell.engine)
            key = run_key(cell.scenario, eng_id)
            tel.count("suite.cell")
            if store.has(key):
                tel.count("suite.cache_hit")
                log.info("suite %s: cell %s — cache hit (%s)", suite.name, cell.label, key[:12])
                done[idx] = CellOutcome(cell, key, True, store.get(key), 0.0)
                continue
            if max_cells is not None and len(plan) >= max_cells:
                n_skipped += 1
                continue
            tel.count("suite.cache_miss")
            plan.append((idx, cell, eng_id, key))
        if any(eng_id not in _HOST_ENGINES for _, _, eng_id, _ in plan):
            device = resolve_device(device)
        if jobs > 1 and len(plan) > 1:
            _run_parallel(store, suite, plan, engine, policy, jobs, done, device)
        else:
            for idx, cell, eng_id, key in plan:
                c0 = time.perf_counter()
                attempts = 1
                try:
                    result, attempts = _with_retry(
                        lambda: _simulate_cell(cell, eng_id, engine, suite.name, key, device),
                        key, policy, "cell",
                    )
                    rec, _ = _with_retry(
                        lambda: _flush_cell(store, suite.name, cell, key, result),
                        key, policy, "flush",
                    )
                except Exception as e:
                    wall = time.perf_counter() - c0
                    log.error("suite %s: cell %s — FAILED: %r", suite.name, cell.label, e)
                    done[idx] = CellOutcome(
                        cell, key, False, None, wall,
                        error=repr(e), attempts=getattr(e, "_attempts", attempts),
                    )
                    continue
                wall = time.perf_counter() - c0
                log.info("suite %s: cell %s — simulated in %.2fs", suite.name, cell.label, wall)
                done[idx] = CellOutcome(cell, key, False, rec, wall, attempts=attempts)
        outcomes = [done[i] for i in sorted(done)]
    return SuiteReport(
        suite=suite, outcomes=outcomes, wall_s=time.perf_counter() - t0, n_skipped=n_skipped
    )


def _run_parallel(
    store: RunStore,
    suite: Suite,
    plan: list[tuple[int, SuiteCell, str, str]],
    engine: str | None,
    policy: RetryPolicy,
    jobs: int,
    done: dict[int, CellOutcome],
    device=None,
) -> None:
    """Thread-pool execution with per-cell failure capture and a watchdog.

    Workers retry internally; the calling thread flushes completed results
    (with its own retry) and, when ``policy.timeout_s`` is set, abandons
    cells whose attempt has been running past the deadline.  An abandoned
    worker thread cannot be killed — its pool slot is lost, and once every
    slot is lost the still-queued cells are cancelled and reported as
    failed rather than waited on forever.
    """
    import concurrent.futures as cf

    tel = obs.current()
    started: dict[str, float] = {}  # run key -> monotonic attempt-window start

    def worker(cell: SuiteCell, eng_id: str, key: str):
        started[key] = time.monotonic()
        return _with_retry(
            lambda: _simulate_cell(cell, eng_id, engine, suite.name, key, device),
            key, policy, "cell",
        )

    pool = cf.ThreadPoolExecutor(max_workers=jobs, thread_name_prefix="suite-cell")
    abandoned = 0
    try:
        futures = {
            pool.submit(worker, cell, eng_id, key): (idx, cell, key, time.perf_counter())
            for idx, cell, eng_id, key in plan
        }
        pending = set(futures)
        while pending:
            finished, pending = cf.wait(pending, timeout=0.05, return_when=cf.FIRST_COMPLETED)
            for fut in finished:
                idx, cell, key, c0 = futures[fut]
                attempts = 1
                try:
                    result, attempts = fut.result()
                    rec, _ = _with_retry(
                        lambda: _flush_cell(store, suite.name, cell, key, result),
                        key, policy, "flush",
                    )
                except Exception as e:
                    wall = time.perf_counter() - c0
                    log.error("suite %s: cell %s — FAILED: %r", suite.name, cell.label, e)
                    done[idx] = CellOutcome(
                        cell, key, False, None, wall,
                        error=repr(e), attempts=getattr(e, "_attempts", attempts),
                    )
                    continue
                wall = time.perf_counter() - c0
                log.info("suite %s: cell %s — simulated in %.2fs", suite.name, cell.label, wall)
                done[idx] = CellOutcome(cell, key, False, rec, wall, attempts=attempts)
            if policy.timeout_s is None:
                continue
            now = time.monotonic()
            for fut in list(pending):
                idx, cell, key, c0 = futures[fut]
                t0 = started.get(key)
                if t0 is None or now - t0 <= policy.timeout_s:
                    continue
                if fut.cancel():  # raced to queued state: treat as ordinary cancel
                    pending.discard(fut)
                    continue
                pending.discard(fut)
                abandoned += 1
                tel.count("suite.watchdog_timeout")
                log.error(
                    "suite %s: cell %s — watchdog timeout after %.1fs, abandoning worker",
                    suite.name, cell.label, now - t0,
                )
                done[idx] = CellOutcome(
                    cell, key, False, None, time.perf_counter() - c0,
                    error=f"watchdog timeout after {policy.timeout_s}s",
                )
            if abandoned >= jobs and pending:
                # every pool slot is wedged: queued cells can never start
                for fut in list(pending):
                    idx, cell, key, c0 = futures[fut]
                    if fut.cancel():
                        pending.discard(fut)
                        done[idx] = CellOutcome(
                            cell, key, False, None, 0.0,
                            error="worker pool exhausted by hung cells",
                        )
    finally:
        # do not block the pass on wedged workers; their threads die with the
        # process (finite injected hangs drain on their own)
        pool.shutdown(wait=abandoned == 0, cancel_futures=True)


def run_stored(
    scenario: Scenario,
    store: RunStore,
    engine: str = "auto",
    *,
    suite: str | None = None,
    cell: str | None = None,
    device=None,
) -> tuple[EngineResult, bool]:
    """Cache-or-run one scenario; returns ``(result, was_cache_hit)``.

    Unlike :func:`run_suite` this loads the payload on a hit — callers want
    the arrays — but still performs zero simulation.  A corrupt payload
    (checksum mismatch, truncated npz) self-heals: the load error is logged,
    the cell re-simulates, and the fresh result supersedes the bad entry.
    """
    eng_id = _engine_id("scenario", engine)
    key = run_key(scenario, eng_id)
    tel = obs.current()
    if store.has(key):
        try:
            result = store.load(key, scenario=scenario)
        except StoreCorruptionError as e:
            tel.count("store.corrupt_hits")
            log.warning("re-simulating corrupt cache hit: %s", e)
        else:
            tel.count("suite.cache_hit")
            return result, True
    tel.count("suite.cache_miss")
    res = get_engine(engine, device=_engine_device(eng_id, device)).run(scenario)
    store.put_engine_result(scenario, res, suite=suite, cell=cell)
    return res, False


def run_fleet_stored(
    scenario: FleetScenario,
    store: RunStore,
    *,
    suite: str | None = None,
    cell: str | None = None,
) -> tuple[FleetGridResult, bool]:
    """Cache-or-run one fleet scenario on the host controller; returns
    ``(grid, was_cache_hit)``.  Corrupt cache hits self-heal by
    re-simulating, as in :func:`run_stored`.
    """
    key = run_key(scenario, FLEET_ENGINE)
    tel = obs.current()
    if store.has(key):
        try:
            grid = store.load(key, scenario=scenario)
        except StoreCorruptionError as e:
            tel.count("store.corrupt_hits")
            log.warning("re-simulating corrupt cache hit: %s", e)
        else:
            tel.count("suite.cache_hit")
            return grid, True
    tel.count("suite.cache_miss")
    grid = run_fleet(scenario, engine="controller")
    store.put_fleet_result(scenario, grid, suite=suite, cell=cell)
    return grid, False


def run_serving_stored(
    scenario: ServingScenario,
    store: RunStore,
    engine: str = "auto",
    *,
    suite: str | None = None,
    cell: str | None = None,
    device=None,
) -> tuple[ServingResult, bool]:
    """Cache-or-run one serving scenario; returns ``(result, was_cache_hit)``.
    Corrupt cache hits self-heal by re-simulating, as in :func:`run_stored`.
    """
    eng_id = _engine_id("serving", engine)
    key = run_key(scenario, eng_id)
    tel = obs.current()
    if store.has(key):
        try:
            result = store.load(key)
        except StoreCorruptionError as e:
            tel.count("store.corrupt_hits")
            log.warning("re-simulating corrupt cache hit: %s", e)
        else:
            tel.count("suite.cache_hit")
            return result, True
    tel.count("suite.cache_miss")
    res = run_serving(scenario, engine=engine, device=_engine_device(eng_id, device))
    store.put_serving_result(scenario, res, engine=eng_id, suite=suite, cell=cell)
    return res, False
