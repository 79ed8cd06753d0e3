#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one GPU: build, check, and run the §VII study.

Run from the root of a checkout, on a machine with one CUDA GPU and nvcc::

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and nothing is caught:

1. A CUDA device is required (without one: exit 2, no result printed).  Prints
   the card's name and power limit as ``nvidia-smi`` reports them.
2. Builds the CUDA kernels from the checkout's sources and prints the build time
   and the compiler's register / spill report.
3. Holds the kernel against its plain PyTorch version on the card, bit for bit on
   every output, for small studies including hand-built step-trace edge cases;
   and holds the kernel path's results on a small study against the digest of the
   JAX package's results (``GOLDEN_SHA256``, pinned by ``tests/test_torch_engine.py``).
4. Runs the study at full width through ``repro_torch.engine.run`` on the card:
   all 64 catalog types × 41 bid fractions (0.50 + 0.0025·i of on-demand) ×
   seeds 0-3 × the five bid-limited schemes, a 30-day horizon and 24 h of work
   (52,480 simulation cells).  The kernel's launch count is reset just before
   that run and read just after; every field must equal the same run with the
   plain version on the card.  Then times the kernel's bare launch (input
   checks and output allocation done beforehand) and the plain version on the
   full-width inputs with CUDA events and prints one JSON line for the kernels
   and one for the engine.
5. Prints ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

FIELDS = ("completed", "completion_time", "cost", "n_checkpoints", "n_kills", "work_lost_s")
SWEEP_OUTPUTS = ("done", "comp_time", "n_ckpt", "work_lost", "n_kills", "rec_exists", "rec_end", "rec_user")

#: sha256 of the FIELDS arrays of the JAX package's batch / jax engines on golden_study()
GOLDEN_SHA256 = "deb6e6b79af47c3985bae6f24aca27db85bee815aee5629ea096f2aabd739cc4"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and non-tensor float64 rate
HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12
# float64 operations of one step, counted from csrc/spot_sweep.cu: a processed
# period (entry, short test, fold), an HOUR/EDGE window, an ADAPT decision tick
OPS_PER_PERIOD, OPS_PER_WINDOW, OPS_PER_TICK = 10, 12, 30


def golden_study():
    from repro_torch.core import catalog
    from repro_torch.engine import Scenario

    return Scenario.grid(
        work_s=24 * 3600.0, bids=[0.5, 0.53, 0.56, 0.6], instances=catalog()[::13],
        horizon_days=15.0, seeds=(0, 1), bid_fractions=True,
    )


def result_digest(res) -> str:
    import numpy as np

    h = hashlib.sha256()
    for f in FIELDS:
        h.update(np.ascontiguousarray(getattr(res, f)).tobytes())
    return h.hexdigest()


def small_studies():
    from repro_torch.core import HOUR, SimParams, get_instance, step_trace, synthetic_trace
    from repro_torch.engine import BID_LIMITED_SCHEMES, Scenario

    day = 24 * HOUR
    it = get_instance("m1.xlarge")
    return {
        "synthetic": Scenario.from_trace(
            synthetic_trace(it, 12, seed=3), 20 * HOUR, bids=[0.40, 0.41, 0.42, 0.45, 5.0],
            schemes=BID_LIMITED_SCHEMES,
        ),
        "resume_extreme_bids": Scenario(
            work_s=30 * HOUR, bids=(0.01, 0.30, 0.345, 0.36, 5.0),
            traces=(synthetic_trace(it, 20, seed=7),), initial_saved_work=10 * HOUR,
            params=SimParams(t_c=450.0, t_r=900.0),
        ),
        "step_trace_edges": Scenario.from_trace(
            step_trace(
                [(0.0, 0.30), (0.4 * day, 0.50), (0.45 * day, 0.31), (1.3 * day, 0.52),
                 (1.35 * day, 0.29), (2.0 * day, 0.55)],
                horizon_s=3 * day,
            ),
            10 * HOUR, bids=[0.295, 0.32, 0.51], schemes=BID_LIMITED_SCHEMES,
        ),
        "golden_grid": golden_study(),
    }


def full_study():
    from repro_torch.engine import BID_LIMITED_SCHEMES, Scenario

    return Scenario.grid(
        work_s=24 * 3600.0,
        bids=[round(0.50 + 0.0025 * i, 4) for i in range(41)],
        schemes=BID_LIMITED_SCHEMES,
        horizon_days=30.0,
        seeds=(0, 1, 2, 3),
        bid_fractions=True,
    )


def sweep_args(sc, device):
    from repro_torch.engine.batch import grid_and_tables
    from repro_torch.kernels.spot_sweep import ops

    grid, tables = grid_and_tables(sc, sc.materialize(), True)
    arrs = ops.device_arrays(grid, device, True, True, sc.params.t_r, tables)
    return (
        sc.schemes, arrs["A"], arrs["B"], arrs["valid"], arrs["horizon"],
        ops.sweep_consts(sc, tables), arrs["ptr0"], arrs["edges"], arrs["tables"],
    )


def compare_outputs(got, want, what) -> float:
    """Fail unless every output is bitwise equal; return the max abs error of
    the float outputs (0.0 when they agree)."""
    import torch

    err = 0.0
    for name, g, w in zip(SWEEP_OUTPUTS, got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: {name} is {g.dtype}{tuple(g.shape)}, plain {w.dtype}{tuple(w.shape)}")
        if g.dtype == torch.float64:
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            diff = torch.where(same, torch.zeros_like(g), (g - w).abs())
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
            g, w = g.view(torch.int64), w.view(torch.int64)
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: kernel and plain version differ in {name}")
    return err


def compare_results(got, want, what):
    import numpy as np

    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes {got.shape} vs {want.shape}")
    for f in FIELDS:
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{what}: field {f} differs")


def time_ms(fn, reps):
    """Median milliseconds of ``reps`` calls, each timed with CUDA events."""
    import torch

    times = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def sweep_bound(args, out) -> tuple[float, str]:
    """Least time the card could take for this sweep, counted on the host from
    this run's inputs and the records it wrote: the larger of the bytes that
    must move over HBM bandwidth and the float64 operations over the float64
    peak.  Where the work depends on the data, the count is a lower bound on
    what this run needs.

    Bytes: every output written once; ``valid`` and ``horizon`` read in full,
    ``B`` on valid periods (every valid period's record end is its ``B``),
    ``A`` on the periods some scheme processes, ``ptr0`` on the periods EDGE
    processes, the distinct rising edges EDGE's walks read, the per-cell
    offsets, and of the survival tables the distinct entries each cell's
    longest ADAPT run must gather (its ticks' bins strictly increase, so at
    least ticks + 1 of them).  Operations: the processed periods, the HOUR
    windows and EDGE edges inside each processed period's span, and at least
    ``span // (interval + t_c)`` ADAPT ticks per period.
    """
    import numpy as np

    from repro_torch.core.schemes import Scheme

    schemes, A, B, valid, horizon, c, ptr0, edges, tables = args
    schemes = tuple(schemes)
    S, C, P = len(schemes), A.shape[0], A.shape[1]
    A, B, valid = A.cpu().numpy(), B.cpu().numpy(), valid.cpu().numpy()
    done, rend, ruser = out[0].cpu().numpy(), out[6].cpu().numpy(), out[7].cpu().numpy()
    t_r, t_c = c["t_r"], c["t_c"]

    # (s, c, p) periods the sweep processes: valid, up to and including the completing one
    p_last = np.where(done, ruser.argmax(axis=2), P - 1)
    processed = valid[None] & (np.arange(P)[None, None, :] <= p_last[:, :, None])
    span = np.where(processed, np.maximum(rend - (A + t_r)[None], 0.0), 0.0)  # walk time after recovery

    read = 4 * S + valid.size + 8 * horizon.numel() + 8 * int(valid.sum()) + 8 * int(processed.any(axis=0).sum())
    ops = OPS_PER_PERIOD * int(processed.sum())
    if Scheme.HOUR in schemes:
        si = schemes.index(Scheme.HOUR)
        delta = c["hour_delta"]
        k_min = np.floor((t_r + t_c) / delta) + 1  # first window after recovery
        k_max = np.ceil((span[si] + t_r + t_c) / delta) - 1  # last window start before the span ends
        ops += OPS_PER_WINDOW * int(np.maximum(k_max - k_min + 1, 0)[processed[si]].sum())
    if Scheme.EDGE in schemes:
        si = schemes.index(Scheme.EDGE)
        flat, base, n = (x.cpu().numpy() for x in edges)
        p0 = ptr0.cpu().numpy()
        end = np.where(processed[si], rend[si], -np.inf)
        hi = np.zeros((C, P), dtype=np.int64)  # first edge at or after each period's end
        for b0, n0 in set(zip(base.tolist(), n.tolist())):
            rows = base == b0
            hi[rows] = np.searchsorted(flat[b0:b0 + n0], end[rows], side="left")
        used = processed[si] & (hi > p0)
        ops += OPS_PER_WINDOW * int((hi - p0)[used].sum())
        # distinct edges read: [ptr0, hi] of every period that reads one, as a union
        cover = np.zeros(flat.size + 1, dtype=np.int64)
        np.add.at(cover, (base[:, None] + p0)[used], 1)
        np.add.at(cover, (base[:, None] + np.minimum(hi + 1, n[:, None]))[used], -1)
        read += 8 * int((np.cumsum(cover)[:-1] > 0).sum()) + 8 * int(processed[si].sum()) + 16 * C
    if Scheme.ADAPT in schemes:
        si = schemes.index(Scheme.ADAPT)
        interval = c["interval"]
        bin_s = c["bin_s"]
        if interval < bin_s:
            raise AssertionError("the table bound assumes one decision interval spans a hazard bin or more")
        ticks = np.floor(span[si] / (interval + t_c)).astype(np.int64)
        ops += OPS_PER_TICK * int(ticks.sum())
        top = tables[2].cpu().numpy()
        first = np.minimum(int((t_r + interval) / bin_s), top)  # bin of the first decision
        longest = ticks.max(axis=1)
        entries = np.where(longest > 0, np.minimum(longest + 1, top + 1 - first), 0)
        read += 8 * int(entries.sum()) + 16 * C
    written = S * C * (1 + 8 + 8 + 8 + 8) + S * C * P * (1 + 8 + 1)
    bytes_ms = 1e3 * (read + written) / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / F64_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def main() -> int:
    import torch

    # -- 1. the card --------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; run it from a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.engine import TorchEngine, run
    from repro_torch.engine.base import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.spot_sweep import kernel, ref

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    print(f"build_s {time.perf_counter() - t0:.3f}  ({_build.library_path().name})", flush=True)
    for line in _build.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # -- 3. kernel vs plain version on small studies, and the golden digest ----
    for name, sc in small_studies().items():
        args = sweep_args(sc, device)
        got = kernel.spot_sweep(*args)
        want = ref.sweep_plain(*args)
        torch.cuda.synchronize()
        compare_outputs(got, want, name)
        print(f"small {name}: kernel == plain on {len(SWEEP_OUTPUTS)} outputs, cells {sc.n_cells}", flush=True)
    golden = run(golden_study())
    if result_digest(golden) != GOLDEN_SHA256:
        raise AssertionError("golden study: kernel-path results differ from the JAX package's")
    if not golden.completed.any() or (golden.cost < 0).any():
        raise AssertionError("golden study: no job completed, or a negative cost")
    print("golden study: digest equals the JAX package's results", flush=True)

    # -- 4. the full-width study --------------------------------------------
    sc = full_study()
    t0 = time.perf_counter()
    args = sweep_args(sc, device)  # period grid, ADAPT tables, device copies (set-up)
    setup_s = time.perf_counter() - t0
    S, (C, P) = len(sc.schemes), tuple(args[1].shape)
    print(f"full width: {sc.n_markets} markets x {len(sc.bids)} bids = {C} cells, P = {P} periods, "
          f"{S * C} simulation cells, ADAPT table entries {args[8][0].numel()}, set-up {setup_s:.3f} s", flush=True)

    kernel.launches = 0
    res = run(sc)  # the main path, on the card
    torch.cuda.synchronize()
    launches = kernel.launches
    if launches < 1:
        raise AssertionError("the main path did not launch the spot_sweep kernel")
    res_plain = TorchEngine(device=device, impl="plain").run(sc)
    compare_results(res, res_plain, "full width engine")
    if res.shape != (sc.n_markets, len(sc.bids), S) or not (res.completion_time[res.completed] < float("inf")).all():
        raise AssertionError("full width: unexpected shape or an infinite completion time on a completed cell")
    print(f"full width: engine.run on the card == plain version on {len(FIELDS)} fields; "
          f"completed {int(res.completed.sum())} of {res.n_cells}; kernel launches {launches}", flush=True)

    # kernel vs plain version on the main path's inputs, then timing
    out = kernel.spot_sweep(*args)
    out_plain = ref.sweep_plain(*args)
    torch.cuda.synchronize()
    max_err = compare_outputs(out, out_plain, "full width sweep")
    job = kernel.prepare(*args)  # input checks and output allocation, outside the timed region
    kernel_ms = time_ms(lambda: kernel.launch(job), reps=10)
    wrapper_ms = time_ms(lambda: kernel.spot_sweep(*args), reps=10)  # checks + allocation + launch
    plain_ms = time_ms(lambda: ref.sweep_plain(*args), reps=3)
    bound_ms, bound_by = sweep_bound(args, out)
    print(json.dumps({"kernels": [{
        "name": "spot_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/spot_sweep/csrc/spot_sweep.cu",
        "replaces": "src/repro/kernels/spot_sweep/kernel.py:458",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "wrapper_ms": wrapper_ms,
        "match": True,
    }]}), flush=True)

    walls = {}
    for label, eng in (("cuda", TorchEngine(device=device)), ("plain", TorchEngine(device=device, impl="plain"))):
        r = eng.run(sc)  # grid, tables and device copies are cached: this times the run itself
        t = r.timings
        walls[label] = {
            "wall_s": r.wall_s, "cells_per_s": r.cells_per_s, "sim_s": t.sim_s, "bill_s": t.bill_s,
            "grid_s": t.grid_s,
        }
    print(json.dumps({"engine": {"cells": res.n_cells, "setup_s": setup_s, **walls}}), flush=True)

    # -- 5. the result line -------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
