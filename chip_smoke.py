#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one GPU: build, check, run the §VII study, contended markets, the fleet, auto-scaled serving and the suite, serve all ten models and train.

Run from the root of a checkout, on a machine with one CUDA GPU and nvcc::

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero and nothing is caught:

1. A CUDA device is required (without one: exit 2, no result printed).  Prints
   the card's name and power limit as ``nvidia-smi`` reports them.
2. Builds the CUDA kernels from the checkout's sources and prints the build time,
   the compiler's register / spill report (and any wgmma serialization warning),
   and one ``sass:`` line: the ``HGMMA`` and ``UTMALDG`` / ``UTMASTG`` / ``UBLKCP``
   instructions in each attention and RG-LRU kernel, counted with ``cuobjdump
   -sass`` (the toolkit's, beside ``nvcc``) on the built library.  Fails if the
   wgmma + TMA attention kernel has no ``HGMMA``.
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
   checks and output allocation done beforehand), the launch of each scheme
   alone, the whole wrapper and the plain version on the full-width inputs
   with CUDA events, counts the study's longest dependent chain (periods plus
   windows or ticks of one (scheme, cell)) on the host, and prints one JSON
   line for the engine.
5. ACC, the paper's scheme, beside the other five (all six schemes): the small
   studies of phase 3 through ``repro_torch.engine.run`` on the card, each
   ``==`` the CPU engine on the 7 compared fields and ``==`` the port's scalar
   ``ReferenceEngine`` on every field but ``cost`` (within ``COST_RTOL``:
   the reference's compensated ``sum()``), and the golden study against the
   digest of the JAX package's 7 fields (``GOLDEN_ACC_SHA256``); then the
   full-width study with all six schemes on the card, ``spot_sweep`` launched
   exactly once (counts reset just before, read just after), its ACC column
   ``==`` a ``device="cpu"`` run of ACC alone.  Times ACC alone on the card
   and on the CPU (``sim_s``, ``bill_s``, ``wall_s``; grid built beforehand),
   profiles one more card run (device busy time, kernels launched,
   read-backs, idle share) and prints one ``{"acc": ...}`` line with ACC
   against OPT on the study.
   Then runs ``repro_torch.launch.policy_compare`` (the paper's ensemble, all
   six schemes) on the card and prints its table and one
   ``{"policy_compare": ...}`` line.
6. Capacity studies on the card (contended markets, ``capacity=`` / ``demand=``):
   small contended studies — the engine sweep of ``examples/market_contention.py``
   (HOUR, demand 1-4 in a pool of 4), the step-trace edges and the golden grid,
   contended — each with the kernel == plain version on every output and the card
   == the CPU on the 7 fields; the contended golden study against the digest of
   the JAX package's batch engine (``GOLDEN_CAPACITY_SHA256``; the pool of 4
   with a block of 3).  Then phase 4's full-width study with ``capacity=4``,
   ``demand=2`` and the default ``MarketParams``, and again with ``demand=3``
   (the first block that binds): each with ``spot_sweep`` launched exactly once
   (counts reset just before, read just after), every field == the plain version
   on the card.  Prints how many markets' cleared traces differ from the
   exogenous ones, the kills against the uncontended study, and one
   ``{"market": ...}`` line (wall, ``sim_s``, ``bill_s``, the clearing's host
   seconds, for each block).
7. The fleet on the card: ``tests/fleet/test_batch_parity.py``'s small grid
   under every scheme through ``run_fleet`` (the batch engine's EET and attempt
   waves as torch ops on the card), == the CPU, == the host controller (``cost``
   within ``FLEET_COST_RTOL``), its records against the JAX package's digest
   (``GOLDEN_FLEET_SHA256``); ``market_contention``'s contended fleet replay
   against its digest (``GOLDEN_REPLAY_SHA256``).  Then
   ``benchmarks/fleet_study.py::full_config`` (200 jobs, 64 types, seeds 0-7,
   margins 0.54 / 0.56 / 0.60, four policies, HOUR, 21 days: 96 cells): the batch
   engine on the card == on the CPU on every field, both timed from an empty
   memo and again warm; the host controller on seeds 0-1 (a cut) == the batch
   engine (``cost`` within ``FLEET_COST_RTOL``); one more card run profiled
   (kernels launched and read-backs inside the EET and attempt waves, the
   device's busy time); ``eet_scores`` timed on a wave of the study's mean
   shape.  Prints one ``{"fleet": ...}`` line.
8. Serving under spot auto-scaling on the card (``repro_torch.serving``; no
   kernel: the batch engine's per-period waves are torch ops on the card):
   small grids (``tests/serving/test_engine.py``'s QUICK uncontended and in a
   pool of 12, ``examples/spot_serving.py``'s day in a pool of 12; flash crowds,
   all three policies) with the card's batch engine == the CPU's == the host
   reference on every field, and against the digest of the JAX package's batch
   engine (``GOLDEN_AUTOSCALE_SHA256``); the zero-traffic grid's ``spot_price``
   == the exogenous trace on the card; ``benchmarks/serving_bench.py``'s full
   grid (72 cells, 1152 periods) and the same at seeds 0-63 (576 cells),
   contended (pool of 12) and uncontended, each on the card (after a warm-up
   run) and on the CPU, card == CPU on every field; the quick grid's host
   reference against the card's batch engine; a profile of the contended full
   grid on the card (kernels, read-backs and copies inside the period loop —
   it fails on any read-back there — and the device's busy share).  Prints one
   ``{"autoscale": ...}`` line.
9. The suite control plane: ``examples/suites/serving_diurnal.toml`` through
   ``repro_torch.suite.run_suite`` into a temporary store on the card, twice;
   the second pass must be all cache hits with no ``serving.run`` span, and a
   deep ``verify`` clean.  Prints one ``{"suite": ...}`` line.
10. Holds each model kernel (flash attention, RG-LRU scan, SSM scan) against
   its plain PyTorch version on the card at small shapes: causal and
   bidirectional attention, windows (one off the kv tile, one past Sk),
   ``q_offset`` with Sk > Sq, lengths off every tile, GQA G in {1, 2, 3, 4, 6, 7,
   8, 9, 12, 16} (3, 6, 7, 9 and 12 divide no tile: 126 or 120 of its 128 rows),
   head dims 16-256 with kimi-k2's 112, float32 and bfloat16; scans of
   ragged lengths and widths on random inputs from a seed, the RG-LRU scan
   bit for bit (``torch.equal``) on both of its bodies.
11. Serves every architecture of ``repro_torch.configs`` at its full published
   widths (random weights from a seeded ``torch.Generator`` on the card):
   glm4-9b, recurrentgemma-9b, falcon-mamba-7b, internlm2-20b, starcoder2-3b,
   starcoder2-7b, internvl2-1b (256 random vision embeddings over the first 256
   prompt positions) and whisper-large-v3 (2 x 1500 random encoder frames) with
   every layer; arctic-480b with 2 of its 35 layers and kimi-k2-1t-a32b with 1
   of its 61 (``MODEL_LAYERS``: their experts fill the card).  2 requests of
   4096 prompt tokens, prefill, then 16 greedy decode steps, through
   ``repro_torch.models.transformer``, after one untimed warm-up prefill.  The
   kernels' launch counts are reset just before the timed prefill and read just
   after (``MODELS``: 40 flash; 12 flash + 26 RG-LRU; 64 SSM; 48, 30, 32, 24,
   64 = 32 encoder + 32 decoder, 2 and 1 flash).  A MoE model's prefill runs
   twice more and must give the same bits (``torch.equal``).  The same requests
   then go through the plain versions on the card (``impl="plain"``) and the
   last-token logits are compared.  Each kernel is then held against its plain
   version (the RG-LRU scan bit for bit), and timed, on the full-width inputs
   of the first layer that called it (whisper: its encoder's and its decoder's
   attention), beside its bound and (attention)
   ``scaled_dot_product_attention``.
   Prints one ``{"serving": ...}`` line per model.
12. Holds the checkpoint codec kernel against its plain version on the card, bit
   for bit (``q`` and ``scales``): ragged sizes (1 to 1 M + 3 elements) in
   float32, bfloat16 and float16, all-zero blocks, exact .5 ties of a block's
   step, magnitudes across each type's finite range, and a NaN block.
13. Small training checks on the card: for the smoke configs of the ten
   models, one ``loss_fn`` value and every parameter's gradient through the
   kernels' autograd Functions against ``impl="plain"`` (bf16: the loss within
   the serving tolerances; float32: the loss and each leaf's gradient); every
   parameter must get a nonzero gradient through the kernels.
14. Trains glm4-9b at its published widths with 4 of its 40 layers (bf16,
   AdamW with float32 moments, batch 2 x 4096 tokens from ``TokenStream``,
   ``remat=False``, ``q_block = kv_block = 1024``) through
   ``repro_torch.train.steps.make_train_step``: holds the codec kernel against
   its plain version on every leaf of the initial state and times it on the
   biggest; one untimed warm-up step (its loss against the same step's loss
   through ``impl="plain"``), then timed steps with their flash-attention
   launches counted; then a split of one step (forward, backward, optimizer).
15. Runs a spot campaign on that model through ``SpotTrainer`` (int8 codec,
   async writes, ``keep=2``, a checkpoint directory removed at exit) on the
   trace of ``tests/train/test_spot_trainer.py``: one preemption, one restore,
   ``ckpt_codec`` launched once per quantized leaf per checkpoint, and the
   restored state within half a quantization step per block of the saved
   one.  Prints one ``{"training": ...}`` line.
16. Prints one ``{"kernels": [...]}`` line with the five kernels (the attention
   row with ``bound_share`` = bound / ms and ``vs_library`` = ms / library ms
   for each served model; the sweep row with ``by_scheme``, ``chain_steps``
   and ``ns_per_step`` = ms × 1e6 / chain_steps; its launches by path: the
   five-scheme study of phase 4, the six-scheme study of phase 5 and the
   contended studies of phase 6).
17. Prints ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

FIELDS = ("completed", "completion_time", "cost", "n_checkpoints", "n_kills", "work_lost_s")
#: The fields the six-scheme checks compare (``repro_torch.engine.parity.COMPARED``).
ACC_FIELDS = ("completed", "completion_time", "cost", "n_checkpoints", "n_kills", "n_self_terminations", "work_lost_s")
SWEEP_OUTPUTS = ("done", "comp_time", "n_ckpt", "work_lost", "n_kills", "rec_exists", "rec_end", "rec_user")

#: sha256 of the FIELDS arrays of the JAX package's batch / jax engines on golden_study()
GOLDEN_SHA256 = "deb6e6b79af47c3985bae6f24aca27db85bee815aee5629ea096f2aabd739cc4"
#: sha256 of the ACC_FIELDS arrays of the JAX package's batch engine on golden_study() with all six schemes
GOLDEN_ACC_SHA256 = "2ede5330a9c837554de8d0c40d5849ebd8e75a8bc669070023f7fcf6991aa20a"
#: the same on capacity_golden_study() (six schemes, capacity 4, demand 3)
GOLDEN_CAPACITY_SHA256 = "0bbb0c992233231c0fbd7199438c0c57ac71a474ec80669fd240a6e825505721"
#: fleet_digest of the JAX package's run_fleet_batch records on golden_fleet_scenarios()
GOLDEN_FLEET_SHA256 = "823cdaf45564086bb424ad051ac3b333742119498fe5b743b2531467ffe75276"
#: fleet_digest of the records of examples/market_contention.py's fleet replay (JAX package)
GOLDEN_REPLAY_SHA256 = "1b89293f36751171e882d8db5a9371439e054051be76a6c8c1cfec33f5efce1b"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, non-tensor float64 and float32
# rates, dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 34e12
F32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
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


def result_digest(res, fields=FIELDS) -> str:
    import numpy as np

    h = hashlib.sha256()
    for f in fields:
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


def six_schemes(sc):
    """The same study with all six schemes (ACC included)."""
    import dataclasses

    from repro_torch.engine import ALL_SCHEMES

    return dataclasses.replace(sc, schemes=ALL_SCHEMES)


def full_study(schemes=None):
    from repro_torch.engine import BID_LIMITED_SCHEMES, Scenario

    return Scenario.grid(
        work_s=24 * 3600.0,
        bids=[round(0.50 + 0.0025 * i, 4) for i in range(41)],
        schemes=BID_LIMITED_SCHEMES if schemes is None else schemes,
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


def compare_results(got, want, what, fields=FIELDS):
    import numpy as np

    if got.shape != want.shape:
        raise AssertionError(f"{what}: shapes {got.shape} vs {want.shape}")
    for f in fields:
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


def sweep_work(args, out):
    """What this sweep had to do, counted on the host from its inputs and the
    records it wrote: ``(processed, steps, read)``.

    ``processed`` (S, C, P) marks the periods each (scheme, cell) walks: valid,
    up to and including the completing one.  ``steps`` (S, C, P) counts the
    HOUR windows and EDGE edges inside each processed period's span, and at
    least ``span // (interval + t_c)`` ADAPT ticks in it.  ``read`` is the
    bytes the sweep must read: ``valid`` and ``horizon`` in full, ``B`` on valid
    periods (every valid period's record end is its ``B``), ``A`` on the
    periods some scheme processes, ``ptr0`` on the periods EDGE processes, the
    distinct rising edges EDGE's walks read, the per-cell offsets, and of the
    survival tables the distinct entries each cell's longest ADAPT run must
    gather (its ticks' bins strictly increase, so at least ticks + 1 of them).
    Where the work depends on the data, each count is a lower bound on what
    this run needs.
    """
    import numpy as np

    from repro_torch.core.schemes import Scheme

    schemes, A, B, valid, horizon, c, ptr0, edges, tables = args
    schemes = tuple(schemes)
    S, C, P = len(schemes), A.shape[0], A.shape[1]
    A, B, valid = A.cpu().numpy(), B.cpu().numpy(), valid.cpu().numpy()
    done, rend, ruser = out[0].cpu().numpy(), out[6].cpu().numpy(), out[7].cpu().numpy()
    t_r, t_c = c["t_r"], c["t_c"]

    p_last = np.where(done, ruser.argmax(axis=2), P - 1)
    processed = valid[None] & (np.arange(P)[None, None, :] <= p_last[:, :, None])
    span = np.where(processed, np.maximum(rend - (A + t_r)[None], 0.0), 0.0)  # walk time after recovery
    steps = np.zeros((S, C, P), dtype=np.int64)

    read = 4 * S + valid.size + 8 * horizon.numel() + 8 * int(valid.sum()) + 8 * int(processed.any(axis=0).sum())
    if Scheme.HOUR in schemes:
        si = schemes.index(Scheme.HOUR)
        delta = c["hour_delta"]
        k_min = np.floor((t_r + t_c) / delta) + 1  # first window after recovery
        k_max = np.ceil((span[si] + t_r + t_c) / delta) - 1  # last window start before the span ends
        steps[si] = np.where(processed[si], np.maximum(k_max - k_min + 1, 0), 0)
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
        steps[si] = np.where(used, hi - p0, 0)
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
        steps[si] = ticks
        top = tables[2].cpu().numpy()
        first = np.minimum(int((t_r + interval) / bin_s), top)  # bin of the first decision
        longest = ticks.max(axis=1)
        entries = np.where(longest > 0, np.minimum(longest + 1, top + 1 - first), 0)
        read += 8 * int(entries.sum()) + 16 * C
    return processed, steps, read


def sweep_bound(args, out) -> tuple[float, str]:
    """Least time the card could take for this sweep (see :func:`sweep_work`):
    the larger of the bytes that must move over HBM bandwidth (the reads and
    every output written once) and the float64 operations over the float64
    peak (``OPS_PER_PERIOD`` a processed period, ``OPS_PER_WINDOW`` an HOUR /
    EDGE window, ``OPS_PER_TICK`` an ADAPT tick)."""
    from repro_torch.core.schemes import Scheme

    processed, steps, read = sweep_work(args, out)
    schemes = tuple(args[0])
    S, (C, P) = len(schemes), args[1].shape
    ops = OPS_PER_PERIOD * int(processed.sum())
    for si, scheme in enumerate(schemes):
        ops += (OPS_PER_TICK if scheme == Scheme.ADAPT else OPS_PER_WINDOW) * int(steps[si].sum())
    written = S * C * (1 + 8 + 8 + 8 + 8) + S * C * P * (1 + 8 + 1)
    bytes_ms = 1e3 * (read + written) / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / F64_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def chain_steps(args, out) -> int:
    """The largest number of dependent steps any (scheme, cell) of this sweep
    needs: its processed periods plus its windows or ticks, counted as
    :func:`sweep_work` counts them.  It depends on the inputs, not on the
    kernel's design: the kernel's time over it is the time a step takes."""
    processed, steps, _ = sweep_work(args, out)
    return int((processed + steps).sum(axis=2).max(initial=0))


def sweep_row(launches, max_err, ms, plain_ms, bound, wrapper_ms, by_scheme, steps) -> dict:
    """The sweep's row of the kernels line."""
    bound_ms, bound_by = bound
    return {
        "name": "spot_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/spot_sweep/csrc/spot_sweep.cu",
        "replaces": "src/repro/kernels/spot_sweep/kernel.py:458",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "wrapper_ms": wrapper_ms,
        "by_scheme": by_scheme,
        "chain_steps": steps,
        "ns_per_step": ms * 1e6 / steps if steps else None,
        "match": True,
    }


def acc_timings(res) -> dict:
    """ACC's phase split of one engine run of ACC alone (host clock)."""
    t = res.timings
    return {"sim_s": t.sim_s, "bill_s": t.bill_s, "wall_s": res.wall_s, "grid_s": t.grid_s}


def acc_profile(sc, device, wall_s) -> dict:
    """One more run of ``sc`` (ACC alone) on the card under ``torch.profiler``.

    Reads the profiler's raw events (building its per-op tables for the
    ~0.6 M kernels of a full-width run takes minutes): the device's busy time
    (the sum of its kernels' durations; one stream, so they do not overlap),
    the kernels launched, the host's read-backs of device values
    (``.any()``, ``int()``), and the idle share of ``wall_s``, an unprofiled
    run's wall (the kernels take as long with the profiler as without it).
    """
    from collections import Counter

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine import run

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(sc, device=device)
        torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t0
    busy_us, host = 0.0, Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            busy_us += e.duration_ns() * 1e-3
        else:
            host[e.name()] += 1
    busy_s = busy_us * 1e-6
    return {
        "profiled_wall_s": profiled_s,
        "device_busy_s": busy_s if busy_s > 0 else None,  # None: the profiler saw no device time
        "idle_share": 1.0 - busy_s / wall_s if busy_s > 0 else None,
        "kernel_launches": host["cudaLaunchKernel"],
        "read_backs": host["aten::_local_scalar_dense"],
        "searchsorted": host["aten::searchsorted"],
    }


def acc_phase(device) -> int:
    """Phase 5: ACC beside the other five schemes, on the card; returns the
    sweep's launches on the six-scheme full-width study."""
    import dataclasses

    from repro_torch.core import Scheme
    from repro_torch.engine import ALL_SCHEMES, COST_RTOL, ReferenceEngine, compare_results as parity, run
    from repro_torch.engine.batch import grid_and_tables
    from repro_torch.launch import policy_compare

    for name, sc in small_studies().items():
        sc = six_schemes(sc)
        got = run(sc, device=device)
        compare_results(got, run(sc, device="cpu"), f"six schemes {name}", ACC_FIELDS)
        report = parity(sc, ReferenceEngine(keep_runs=False).run(sc), got)
        if not report.ok:
            raise AssertionError(f"six schemes {name}: card vs the scalar reference\n{report}")
        print(f"six schemes {name}: card == CPU on {len(ACC_FIELDS)} fields, == scalar reference "
              f"(cost within {COST_RTOL:g}), ACC completed {int(got.by_scheme(Scheme.ACC)['completed'].sum())} "
              f"of {got.shape[0] * got.shape[1]}", flush=True)
    golden = run(six_schemes(golden_study()), device=device)
    if result_digest(golden, ACC_FIELDS) != GOLDEN_ACC_SHA256:
        raise AssertionError("golden study, six schemes: results differ from the JAX package's")
    print("golden study, six schemes: digest equals the JAX package's results", flush=True)

    sc = full_study(ALL_SCHEMES)
    reset_launches()
    res = run(sc, device=device)  # the six-scheme main path, on the card
    counts = read_launches()
    launches = counts.pop("spot_sweep")
    if launches != 1 or any(counts.values()):
        raise AssertionError(f"six-scheme study: spot_sweep launched {launches} times (want 1), the others {counts}")
    acc_only = dataclasses.replace(sc, schemes=(Scheme.ACC,))
    grid_and_tables(acc_only, acc_only.materialize(), False)  # set-up, outside the timed runs
    run(acc_only, device=device)  # warm-up: the device copies of the grid
    card = run(acc_only, device=device)
    cpu = run(acc_only, device="cpu")
    a = sc.schemes.index(Scheme.ACC)
    for f in ACC_FIELDS:
        for label, other in (("card", card), ("cpu", cpu)):
            if not (getattr(res, f)[:, :, a] == getattr(other, f)[:, :, 0]).all():
                raise AssertionError(f"six-scheme study: ACC's {f} differs from ACC alone on the {label}")
    if not res.completed[:, :, a].any() or not (res.n_kills[:, :, a] == 0).all():
        raise AssertionError("six-scheme study: no ACC cell completed, or an ACC cell was provider-killed")
    vs = policy_compare.vs_opt(policy_compare.summarize(res))
    print(f"six schemes full width: {res.n_cells} cells, spot_sweep launches {launches}, ACC column == ACC alone "
          f"on the card and on the CPU; ACC completed {int(res.completed[:, :, a].sum())} of {card.n_cells}",
          flush=True)
    profile = acc_profile(acc_only, device, card.wall_s) if device.type == "cuda" else None
    print(json.dumps({"acc": {
        "cells": card.n_cells, "card": acc_timings(card), "cpu": acc_timings(cpu), "card_profile": profile,
        "self_terminations": int(card.n_self_terminations.sum()), "completed": int(card.completed.sum()),
        "vs_opt": {"cost_pct": vs["cost_pct"], "time_pct": vs["time_pct"]},
        "six_scheme_wall_s": res.wall_s,
    }}), flush=True)

    out = policy_compare.main(["--device", str(device)])
    print(json.dumps({"policy_compare": {
        "cells": out["cells"], "wall_s": out["wall_s"], "vs_opt": out["vs_opt"], "paper": policy_compare.PAPER_VS_OPT,
    }}), flush=True)
    return launches


# ---------------------------------------------------------------------------
# Contended markets (capacity studies) and the fleet
# ---------------------------------------------------------------------------

#: The contended pool of ``examples/market_contention.py``: capacity 4, a block
#: of 2; and the block of 3, the first depth at which that pool binds for bids
#: up to 0.60 of on-demand (a block of 2 fits the free depth wherever a bid can
#: clear, so its results equal the open market's).
CAPACITY, DEMAND, BINDING_DEMAND = 4, 2, 3
#: Cost gate of the fleet controller against the batch engine (the controller
#: folds with the compensated ``sum()``, the batch biller left to right).
FLEET_COST_RTOL = 1e-12
#: Seeds of the full-width fleet study the host controller is held on (a cut:
#: all eight take ~55 s of host time on top of the batch runs).
CONTROLLER_SEEDS = (0, 1)


def capacity_golden_study():
    """The golden study, all six schemes, in the contended pool with the
    block that binds."""
    import dataclasses

    from repro_torch.engine import ALL_SCHEMES

    return dataclasses.replace(golden_study(), schemes=ALL_SCHEMES, capacity=CAPACITY, demand=BINDING_DEMAND)


def small_capacity_studies():
    """Small contended studies: the engine sweep of ``market_contention``
    (HOUR, demand 1-4), the step-trace edges and the golden grid contended."""
    import dataclasses

    from repro_torch.launch import market_contention as mc
    from repro_torch.market import MarketParams

    out = {f"market_contention demand {d}": mc.sweep_scenario(d) for d in range(1, CAPACITY + 1)}
    out["step_trace_edges capacity 3, demand 2"] = six_schemes(dataclasses.replace(
        small_studies()["step_trace_edges"], capacity=3, demand=2, market=MarketParams(price_impact=0.1)))
    out["golden_grid contended"] = capacity_golden_study()
    return out


def capacity_study(demand=DEMAND):
    """Phase 4's full-width study in the contended pool (default MarketParams)."""
    import dataclasses

    return dataclasses.replace(full_study(), capacity=CAPACITY, demand=demand)


def capacity_phase(device, open_kills: int, open_completed: int) -> dict[str, int]:
    """Capacity studies on the card; returns the sweep's launches on each
    full-width contended study (exactly 1 each)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.engine import BID_LIMITED_SCHEMES, TorchEngine, run
    from repro_torch.kernels.spot_sweep import kernel, ref

    for name, sc in small_capacity_studies().items():
        bid_limited = dataclasses.replace(sc, schemes=tuple(x for x in sc.schemes if x in BID_LIMITED_SCHEMES))
        args = sweep_args(bid_limited, device)
        compare_outputs(kernel.spot_sweep(*args), ref.sweep_plain(*args), name)
        got = run(sc, device=device)
        compare_results(got, run(sc, device="cpu"), name, ACC_FIELDS)
        print(f"small {name}: kernel == plain on {len(SWEEP_OUTPUTS)} outputs, card == CPU on "
              f"{len(ACC_FIELDS)} fields, cells {sc.n_cells}, kills {int(got.n_kills.sum())}", flush=True)
    if result_digest(run(capacity_golden_study(), device=device), ACC_FIELDS) != GOLDEN_CAPACITY_SHA256:
        raise AssertionError("contended golden study: results differ from the JAX package's")
    print("contended golden study: digest equals the JAX package's results", flush=True)

    exogenous = full_study().materialize()
    rows, launches = {}, {}
    for demand in (DEMAND, BINDING_DEMAND):
        sc = capacity_study(demand)
        t0 = time.perf_counter()
        cleared = [sc._clear_cell(cell) for cell in exogenous]  # the clearing, host NumPy
        clear_s = time.perf_counter() - t0
        differ = sum(not np.array_equal(c.trace.prices, e.trace.prices) for c, e in zip(cleared, exogenous))
        del cleared

        reset_launches()
        res = run(sc)  # the contended main path, on the card
        torch.cuda.synchronize()
        counts = read_launches()
        n = launches[f"demand_{demand}"] = counts.pop("spot_sweep")
        if n != 1 or any(counts.values()):
            raise AssertionError(f"contended study: spot_sweep launched {n} times (want 1), the others {counts}")
        compare_results(res, TorchEngine(device=device, impl="plain").run(sc), f"contended full width, demand {demand}")
        args = sweep_args(sc, device)
        compare_outputs(kernel.spot_sweep(*args), ref.sweep_plain(*args), f"contended full width sweep, demand {demand}")
        del args
        warm = run(sc)
        compare_results(warm, res, f"contended full width demand {demand}, second run")
        kills, completed = int(res.n_kills.sum()), int(res.completed.sum())
        print(f"contended full width: {res.n_cells} cells, capacity {CAPACITY}, demand {demand}: cleared traces "
              f"differ from the exogenous ones in {differ} of {len(exogenous)} markets; spot_sweep launches {n}; "
              f"== plain version on {len(FIELDS)} fields; kills {kills} against {open_kills} uncontended, completed "
              f"{completed} against {open_completed}", flush=True)
        t = res.timings
        rows[f"demand_{demand}"] = {
            "markets_cleared_differ": differ, "kills": kills, "completed": completed, "spot_sweep_launches": n,
            "wall_s": res.wall_s, "grid_s": t.grid_s, "sim_s": t.sim_s, "bill_s": t.bill_s, "clear_s": clear_s,
            "warm": {"wall_s": warm.wall_s, "sim_s": warm.timings.sim_s, "bill_s": warm.timings.bill_s},
        }
        del res, warm
    print(json.dumps({"market": {
        "cells": full_study().n_cells, "capacity": CAPACITY, "markets": len(exogenous),
        "kills_uncontended": open_kills, "completed_uncontended": open_completed, **rows,
    }}), flush=True)
    return launches


def golden_fleet_scenarios():
    """``tests/fleet/test_batch_parity.py``'s small fleet grid under each scheme."""
    from repro_torch.core import Scheme
    from repro_torch.engine import FleetScenario

    return [FleetScenario(n_jobs=12, mean_interarrival_s=1800.0, mean_work_h=3.0, horizon_days=4.0, n_types=8,
                          seeds=(0, 1), scheme=scheme) for scheme in Scheme]


def fleet_full_scenario(seeds=tuple(range(8))):
    """``benchmarks/fleet_study.py::full_config``: 200 jobs over the whole
    64-type catalog, seeds 0-7, margins 0.54 / 0.56 / 0.60, the four
    policies, HOUR, 21 days (96 cells)."""
    from repro_torch.core import HOUR, SLA
    from repro_torch.engine import FleetScenario

    return FleetScenario(n_jobs=200, mean_interarrival_s=0.25 * HOUR, mean_work_h=6.0, horizon_days=21.0,
                         n_types=64, seeds=tuple(seeds), bid_margins=(0.54, 0.56, 0.60), sla=SLA())


def fleet_record(r, cost=True) -> tuple:
    """One AttemptRecord (of either package) as plain values; floats as hex."""
    vals = (r.job_id, r.replica, r.instance, r.bid, r.launch, r.end, r.termination.value, r.cost, r.work_start,
            r.initial_saved_ref, r.saved_after_ref, r.killed, r.completed, r.cancelled, r.self_terminated)
    out = tuple(float(v).hex() if isinstance(v, float) else v for v in vals)
    return out if cost else out[:7] + out[8:]


def fleet_digest(grids) -> str:
    """sha256 of every record of a sequence of ``{key: FleetResult}`` grids."""
    h = hashlib.sha256()
    for results in grids:
        for key, res in results.items():
            h.update(repr(tuple(float(k).hex() if isinstance(k, float) else k for k in key)).encode())
            for r in res.records:
                h.update(repr(fleet_record(r)).encode())
    return h.hexdigest()


def fleet_equal(got, want, what, cost_rtol=None) -> None:
    """Two ``{key: FleetResult}`` grids: every record and outcome ``==``;
    ``cost`` within ``cost_rtol`` relative when given."""
    if list(got) != list(want):
        raise AssertionError(f"{what}: cells differ")
    exact = cost_rtol is None

    def cost_ok(a: float, b: float) -> bool:
        return a == b if exact else abs(a - b) <= cost_rtol * abs(b)

    for key, w in want.items():
        g = got[key]
        if [fleet_record(r, exact) for r in g.records] != [fleet_record(r, exact) for r in w.records]:
            raise AssertionError(f"{what} {key}: records differ")
        if not all(cost_ok(a.cost, b.cost) for a, b in zip(g.records, w.records)):
            raise AssertionError(f"{what} {key}: a record's cost differs")
        if list(g.outcomes) != list(w.outcomes):
            raise AssertionError(f"{what} {key}: jobs differ")
        for j, o in w.outcomes.items():
            q = g.outcomes[j]
            if (q.completed, q.completion_time, q.n_kills, q.n_migrations, len(q.attempts)) != (
                    o.completed, o.completion_time, o.n_kills, o.n_migrations, len(o.attempts)) or not cost_ok(q.cost, o.cost):
                raise AssertionError(f"{what} {key}: job {j}'s outcome differs")


def fleet_timed(sc, device) -> tuple[dict, dict, float]:
    """One batch-engine run of ``sc`` from an empty memo (the host caches of
    pdfs, rows and walks built inside it, as a first run builds them), and
    its ``fleet_batch.*`` counters."""
    import torch

    from repro_torch import obs
    from repro_torch.engine import run_fleet
    from repro_torch.engine.fleetgrid import fleet_inputs
    from repro_torch.fleet.batch import _Memo

    inp = fleet_inputs(sc)
    inp.memo = _Memo(inp.traces_by_seed, inp.hist_by_seed)
    with obs.Telemetry() as tel:
        t0 = time.perf_counter()
        res = run_fleet(sc, device=device)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res.results, {k: v for k, v in tel.counters.items() if k.startswith("fleet_batch.")}, wall


def fleet_profile(sc, device, wall_s) -> dict:
    """One more cold batch run under ``torch.profiler``: the device's busy
    time, and the kernels launched, scalar read-backs (``.any()``,
    ``int()``) and ``cudaMemcpyAsync`` calls (the waves' inputs up, their
    results down) inside each kind of wave (``fleet.eet_wave`` /
    ``fleet.attempt_wave`` ranges) and in all."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fleet_timed(sc, device)
    busy_us, spans, marks = 0.0, {"fleet.eet_wave": [], "fleet.attempt_wave": []}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() not in spans:  # a range's annotation on the device's timeline is no work
                busy_us += e.duration_ns() * 1e-3
        elif e.name() in spans:
            spans[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name() in ("cudaLaunchKernel", "aten::_local_scalar_dense", "cudaMemcpyAsync"):
            marks.setdefault(e.name(), []).append(e.start_ns())
    out = {}
    for kind, iv in spans.items():
        iv.sort()
        starts = [a for a, _ in iv]

        def inside(ts, iv=iv, starts=starts):
            i = bisect.bisect_right(starts, ts) - 1
            return i >= 0 and ts < iv[i][1]

        out[kind.split(".")[1]] = {
            "ranges": len(iv),
            "kernel_launches": sum(inside(ts) for ts in marks.get("cudaLaunchKernel", [])),
            "read_backs": sum(inside(ts) for ts in marks.get("aten::_local_scalar_dense", [])),
            "memcpy_calls": sum(inside(ts) for ts in marks.get("cudaMemcpyAsync", [])),
        }
    busy_s = busy_us * 1e-6
    return {**out, "kernel_launches": len(marks.get("cudaLaunchKernel", [])),
            "read_backs": len(marks.get("aten::_local_scalar_dense", [])),
            "memcpy_calls": len(marks.get("cudaMemcpyAsync", [])),
            "device_busy_s": busy_s if busy_s > 0 else None, "idle_share": 1.0 - busy_s / wall_s if busy_s > 0 else None}


def eet_wave_ms(lanes: int, types: int, device) -> dict:
    """``fleet_step.ops.eet_scores`` on one wave of the study's mean shape:
    the op on inputs already on the card (CUDA events), and the engine's
    whole call from host arrays with the read-back (host clock)."""
    import numpy as np
    import torch

    from repro_torch.kernels.fleet_step.ops import eet_scores
    from repro_torch.kernels.fleet_step.ref import eet_scores_numpy

    rng = np.random.default_rng(0)
    p = rng.uniform(0, 1, (lanes, types))
    host = (p, rng.uniform(0, 5e4, (lanes, types)), rng.uniform(60.0, 2e5, (lanes, types)), rng.random((lanes, types)) < 0.9)
    on = [torch.from_numpy(x).to(device) for x in host]
    if not np.array_equal(eet_scores(*on).cpu().numpy(), eet_scores_numpy(*host)):
        raise AssertionError("eet_scores on the card differs from eet_scores_numpy")
    t0 = time.perf_counter()
    for _ in range(20):
        eet_scores(*host, device=device).cpu()
    return {"lanes": lanes, "types": types, "op_ms": time_ms(lambda: eet_scores(*on), reps=20),
            "call_ms": (time.perf_counter() - t0) * 1e3 / 20}


def fleet_phase(device) -> dict:
    """The fleet on the card: small grids of every scheme against the JAX
    package's digest, the contended replay, the full-width study card == CPU
    and against the host controller, timed and profiled."""
    from repro_torch.engine import run_fleet
    from repro_torch.engine.fleetgrid import fleet_inputs
    from repro_torch.launch import market_contention as mc

    grids = [run_fleet(fs, device=device).results for fs in golden_fleet_scenarios()]
    for fs, res in zip(golden_fleet_scenarios(), grids):
        fleet_equal(res, run_fleet(fs, device="cpu").results, f"small fleet {fs.scheme.value}: card vs CPU")
        fleet_equal(res, run_fleet(fs, engine="controller").results, f"small fleet {fs.scheme.value}: vs controller",
                    FLEET_COST_RTOL)
    if fleet_digest(grids) != GOLDEN_FLEET_SHA256:
        raise AssertionError("small fleet grids: records differ from the JAX package's batch engine")
    print(f"small fleet grids, {len(grids)} schemes: card == CPU, == controller (cost within {FLEET_COST_RTOL:g}), "
          "digest equals the JAX package's records", flush=True)
    replay = mc.fleet_replay()
    if fleet_digest([replay]) != GOLDEN_REPLAY_SHA256:
        raise AssertionError("market_contention fleet replay: records differ from the JAX package's")
    print("market_contention fleet replay: digest equals the JAX package's records", flush=True)

    sc = fleet_full_scenario()
    t0 = time.perf_counter()
    fleet_inputs(sc)  # catalog slice, traces, histories, workloads (set-up)
    setup_s = time.perf_counter() - t0
    card, waves, card_s = fleet_timed(sc, device)
    cpu, _, cpu_s = fleet_timed(sc, "cpu")
    fleet_equal(card, cpu, "fleet full width: card vs CPU")
    t0 = time.perf_counter()
    warm = run_fleet(sc, device=device).results  # memo filled: no EET waves left
    warm_card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_fleet(sc, device="cpu")
    warm_cpu_s = time.perf_counter() - t0
    fleet_equal(warm, card, "fleet full width: warm run")
    ctl_sc = fleet_full_scenario(CONTROLLER_SEEDS)
    t0 = time.perf_counter()
    ctl = run_fleet(ctl_sc, engine="controller").results
    ctl_s = time.perf_counter() - t0
    fleet_equal({k: card[k] for k in ctl}, ctl, "fleet full width: batch vs controller", FLEET_COST_RTOL)
    records = [r for res in card.values() for r in res.records]
    summary = {
        "cells": len(card), "jobs": sc.n_jobs, "types": sc.n_types, "records": len(records),
        "completed": sum(res.n_completed for res in card.values()),
        "kills": sum(res.n_kills for res in card.values()), "migrations": sum(res.n_migrations for res in card.values()),
    }
    print(f"fleet full width: {summary['cells']} cells, {summary['records']} records, card == CPU on every field, "
          f"== controller on seeds {list(CONTROLLER_SEEDS)} (cost within {FLEET_COST_RTOL:g}); card {card_s:.3f} s, "
          f"CPU {cpu_s:.3f} s", flush=True)
    profile = fleet_profile(sc, device, card_s) if device.type == "cuda" else None
    mean_lanes = max(1, round(waves.get("fleet_batch.eet_lanes", 0) / max(1, waves.get("fleet_batch.eet_waves", 0))))
    out = {**summary, "setup_s": setup_s,
           "card": {"wall_s": card_s, "warm_wall_s": warm_card_s},
           "cpu": {"wall_s": cpu_s, "warm_wall_s": warm_cpu_s},
           "cpu_over_card": cpu_s / card_s, "waves": waves,
           "controller": {"seeds": list(CONTROLLER_SEEDS), "cells": len(ctl), "wall_s": ctl_s},
           "card_profile": profile, "eet_wave": eet_wave_ms(mean_lanes, sc.n_types, device)}
    print(json.dumps({"fleet": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# Serving under spot auto-scaling, and the suite control plane
# ---------------------------------------------------------------------------

#: ``tests/serving/test_engine.py``'s QUICK grid (6 hours, 2 seeds, 2 margins,
#: ``max_spot`` 8; a flash crowd; all three policies)
AUTOSCALE_QUICK = dict(base_rps=1200.0, flash_crowds=1, horizon_days=0.25, seeds=(0, 1), bid_margins=(0.5, 1.1),
                       max_spot=8)
#: The array fields of ``ServingResult``, in its order.
SERVING_FIELDS = ("availability", "p99_latency_s", "slo_violation_s", "cost", "served_requests", "offered_requests",
                  "cost_per_mreq", "n_preempted", "n_scale_out", "n_scale_in", "n_boot_lost", "capacity_rps",
                  "spot_price", "rates")
#: serving_digest of the JAX package's batch engine on autoscale_small_grids()
GOLDEN_AUTOSCALE_SHA256 = "b24dcb2bb531e7d3fa04684c3acab5ba39aed9b7134377b4847c7987a5357ea4"
#: Seeds of the wide serving grid (``serving_bench.py``'s full grid at 8× its seeds: 576 cells).
WIDE_SEEDS = tuple(range(64))


def autoscale_small_grids():
    """Small serving grids: QUICK uncontended and in a pool of 12, and
    ``examples/spot_serving.py``'s day in a pool of 12."""
    from repro_torch.serving import ServingScenario

    return {
        "quick_uncontended": ServingScenario(**AUTOSCALE_QUICK),
        "quick_capacity_12": ServingScenario(**AUTOSCALE_QUICK, capacity=12),
        "example_capacity_12": ServingScenario(base_rps=1500.0, flash_crowds=1, horizon_days=1.0, seeds=(0, 1),
                                               bid_margins=(0.5, 1.1), capacity=12, max_spot=16),
    }


def autoscale_bench_scenario(quick=False, capacity=12, seeds=None):
    """``benchmarks/serving_bench.py::bench_scenario``: the full grid is 3
    policies × 3 margins × 8 seeds (72 cells), 4 days of 300 s periods
    (1152), a pool of 12, ``max_spot`` 16, two flash crowds; the quick grid 2
    days, 4 seeds, one flash crowd.  ``capacity=None`` is the uncontended
    market; ``seeds`` widens the grid."""
    from repro_torch.serving import ServingScenario

    if quick:
        return ServingScenario(base_rps=1500.0, flash_crowds=1, horizon_days=2.0, seeds=(0, 1, 2, 3),
                               bid_margins=(0.5, 0.7, 1.1), capacity=capacity, max_spot=16)
    return ServingScenario(base_rps=1500.0, flash_crowds=2, horizon_days=4.0,
                           seeds=tuple(range(8)) if seeds is None else tuple(seeds),
                           bid_margins=(0.5, 0.7, 1.1), capacity=capacity, max_spot=16)


def serving_digest(results) -> str:
    """sha256 of every array field (dtype, shape, bytes) of a sequence of
    ``ServingResult`` (of either package)."""
    import numpy as np

    h = hashlib.sha256()
    for res in results:
        h.update(repr((res.policies, res.bid_margins, res.seeds, res.spot_types)).encode())
        for name in SERVING_FIELDS:
            a = np.ascontiguousarray(getattr(res, name))
            h.update(f"{name}|{a.dtype.str}|{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def serving_equal(got, want, what) -> None:
    """Every field of two ``ServingResult`` but the engine and wall ``==``
    (NaN == NaN)."""
    import numpy as np

    if (got.policies, got.bid_margins, got.seeds, got.spot_types) != (
            want.policies, want.bid_margins, want.seeds, want.spot_types):
        raise AssertionError(f"{what}: grid axes differ")
    for name in SERVING_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype != b.dtype or not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"{what}: {name} differs")


def serving_timed(sc, device, engine="batch"):
    """One run of ``sc`` (its host inputs already built), and its wall."""
    from repro_torch.serving import run_serving

    t0 = time.perf_counter()
    res = run_serving(sc, engine=engine, device=device)  # the results come home inside: no sync needed
    return res, time.perf_counter() - t0


def exogenous_prices(sc):
    """(T, S, P) period-start prices from the market plane alone."""
    import numpy as np

    from repro_torch.core.market import TraceModel, ensemble_seed, sample_traces_batch

    models, streams = [], []
    for it in sc.spot_types:
        for s in sc.seeds:
            models.append(TraceModel.for_instance(it))
            streams.append(ensemble_seed(it, s))
    traces = sample_traces_batch(models, sc.horizon_s, streams)
    starts = np.arange(sc.n_periods, dtype=np.float64) * sc.control_period_s
    S = len(sc.seeds)
    base = np.empty((len(sc.spot_types), S, sc.n_periods))
    for i, tr in enumerate(traces):
        idx = np.clip(np.searchsorted(tr.times, starts, side="right") - 1, 0, len(tr.prices) - 1)
        base[i // S, i % S] = tr.prices[idx]
    return base


def serving_profile(sc, device, wall_s) -> dict:
    """One more card run of ``sc`` under ``torch.profiler``: the device's
    busy time (its kernels and copies; the range's own annotation on the
    device's timeline excluded) against ``wall_s``, an unprofiled run's wall,
    and the kernels launched, scalar read-backs, copies and stream syncs, in
    all and inside the period loop (the ``serving.period_loop`` range)."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        serving_timed(sc, device)
    busy_us, n_device, loop, marks = 0.0, 0, [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() != "serving.period_loop":  # the range's annotation on the device's timeline is no work
                busy_us += e.duration_ns() * 1e-3
                n_device += 1
        elif e.name() == "serving.period_loop":
            loop.append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.name() in ("cudaLaunchKernel", "aten::_local_scalar_dense", "cudaMemcpyAsync", "cudaStreamSynchronize"):
            marks.setdefault(e.name(), []).append(e.start_ns())
    loop.sort()
    starts = [a for a, _ in loop]

    def inside(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ts < loop[i][1]

    def count(name, where=None):
        return sum(1 for ts in marks.get(name, []) if where is None or where(ts))

    busy_s = busy_us * 1e-6
    return {
        "kernel_launches": count("cudaLaunchKernel"), "read_backs": count("aten::_local_scalar_dense"),
        "memcpy_calls": count("cudaMemcpyAsync"), "stream_syncs": count("cudaStreamSynchronize"),
        "period_loop": {"ranges": len(loop), "kernel_launches": count("cudaLaunchKernel", inside),
                        "read_backs": count("aten::_local_scalar_dense", inside),
                        "memcpy_calls": count("cudaMemcpyAsync", inside),
                        "stream_syncs": count("cudaStreamSynchronize", inside)},
        "kernels_per_period": count("cudaLaunchKernel", inside) / sc.n_periods,
        "device_busy_s": busy_s if busy_s > 0 else None,
        "mean_device_op_us": busy_us / n_device if n_device else None,
        "busy_share": busy_s / wall_s if busy_s > 0 else None,
    }


def autoscale_phase(device) -> dict:
    """Serving under spot auto-scaling on the card: the small grids card ==
    CPU == the host reference and against the JAX package's digest, the
    zero-traffic anchor, ``serving_bench.py``'s full grid (72 cells) and the
    576-cell grid, contended and uncontended, on the card and on the CPU,
    the quick grid's reference engine, and a profile of the contended full
    grid on the card."""
    import numpy as np

    from repro_torch.serving import ServingScenario, run_serving
    from repro_torch.serving.engine import _serving_inputs

    small = autoscale_small_grids()
    cards = []
    for name, sc in small.items():
        card = run_serving(sc, device=device)
        serving_equal(card, run_serving(sc, device="cpu"), f"small {name}: card vs CPU")
        serving_equal(card, run_serving(sc, engine="reference"), f"small {name}: card vs reference")
        if card.n_scale_out.sum() == 0 or (sc.capacity is not None and card.n_preempted.sum() == 0):
            raise AssertionError(f"small {name}: the grid scaled out nothing or preempted nothing")
        cards.append(card)
    if serving_digest(cards) != GOLDEN_AUTOSCALE_SHA256:
        raise AssertionError("small serving grids: results differ from the JAX package's batch engine")
    print(f"small serving grids {list(small)}: card == CPU == reference on {len(SERVING_FIELDS)} fields, "
          "digest equals the JAX package's results", flush=True)
    for capacity in (None, 6):
        sc = ServingScenario(base_rps=0.0, horizon_days=0.25, seeds=(0, 1), bid_margins=(0.5, 1.1), capacity=capacity)
        res = run_serving(sc, device=device)
        base = exogenous_prices(sc)
        if not all(np.array_equal(res.spot_price[pi, mi, si], base[:, si])
                   for pi in range(len(res.policies)) for mi in range(len(res.bid_margins))
                   for si in range(len(res.seeds))) or res.n_scale_out.any() or (res.availability != 1.0).any():
            raise AssertionError(f"zero traffic, capacity {capacity}: the card's spot_price is not the exogenous trace")
    print("zero traffic on the card: spot_price == the exogenous trace, uncontended and in a pool of 6", flush=True)

    grids = {}
    for label, sc in (("full_contended", autoscale_bench_scenario()),
                      ("full_uncontended", autoscale_bench_scenario(capacity=None)),
                      ("wide_contended", autoscale_bench_scenario(seeds=WIDE_SEEDS)),
                      ("wide_uncontended", autoscale_bench_scenario(capacity=None, seeds=WIDE_SEEDS))):
        t0 = time.perf_counter()
        _serving_inputs(sc)  # traffic, traces, free depths, hazards, the ladder (set-up, host)
        setup_s = time.perf_counter() - t0
        serving_timed(sc, device)  # warm-up: the card's first launches of these shapes
        card, card_s = serving_timed(sc, device)
        cpu, cpu_s = serving_timed(sc, "cpu")
        serving_equal(card, cpu, f"{label}: card vs CPU")
        grids[label] = {
            "cells": sc.n_cells, "periods": sc.n_periods, "capacity": sc.capacity, "setup_s": setup_s,
            "card_s": card_s, "cpu_s": cpu_s, "cpu_over_card": cpu_s / card_s,
            "preempted": int(card.n_preempted.sum()), "scale_out": int(card.n_scale_out.sum()),
            "mean_availability": float(card.availability.mean()),
        }
        print(f"{label}: {sc.n_cells} cells x {sc.n_periods} periods, card == CPU on every field; card {card_s:.4f} s,"
              f" CPU {cpu_s:.4f} s, {grids[label]['preempted']} preemptions", flush=True)
    quick = autoscale_bench_scenario(quick=True)
    _serving_inputs(quick)
    serving_timed(quick, device)
    q_card, q_card_s = serving_timed(quick, device)
    q_ref, q_ref_s = serving_timed(quick, None, engine="reference")
    serving_equal(q_card, q_ref, "quick grid: card vs reference")
    profile = serving_profile(autoscale_bench_scenario(), device, grids["full_contended"]["card_s"])
    if profile["period_loop"]["read_backs"] or profile["period_loop"]["stream_syncs"]:
        raise AssertionError(f"the serving period loop read back from the card: {profile['period_loop']}")
    out = {"small": list(small), "grids": grids,
           "quick": {"cells": quick.n_cells, "periods": quick.n_periods, "card_s": q_card_s, "reference_s": q_ref_s,
                     "speedup": q_ref_s / q_card_s},
           "card_profile": profile}
    print(json.dumps({"autoscale": out}), flush=True)
    return out


def suite_phase(device) -> dict:
    """``examples/suites/serving_diurnal.toml`` through the suite runner into
    a temporary store on the card, twice: the second pass all cache hits with
    no ``serving.run`` span; ``verify`` (deep) clean."""
    from repro_torch import obs
    from repro_torch.suite import RunStore, load_suite, run_suite

    suite = load_suite(ROOT / "examples/suites/serving_diurnal.toml")
    with tempfile.TemporaryDirectory(prefix="suite_store_") as tmp:
        store = RunStore(tmp)
        passes = []
        for _ in range(2):
            with obs.Telemetry() as tel:
                rep = run_suite(suite, store, device=device)
            if not rep.ok:
                raise AssertionError(f"suite {suite.name}: {rep.n_failed} cells failed")
            passes.append({"hits": rep.n_hits, "simulated": rep.n_misses, "wall_s": rep.wall_s,
                           "serving_runs": len(tel.find_spans("serving.run"))})
        if passes[0]["simulated"] != len(rep.outcomes) or passes[1]["hits"] != len(rep.outcomes) \
                or passes[1]["serving_runs"]:
            raise AssertionError(f"suite {suite.name}: the second pass simulated: {passes}")
        stats = store.verify(deep=True)
        if not stats.ok or stats.n_records != len(rep.outcomes):
            raise AssertionError(f"suite {suite.name}: verify found {stats.summary()}")
        out = {"suite": suite.name, "cells": len(rep.outcomes), "engines": sorted({o.record.engine for o in rep.outcomes}),
               "passes": passes, "verify": stats.summary()}
    print(f"suite {suite.name}: {out['cells']} cells simulated on the card, then {passes[1]['hits']} cache hits with no "
          f"serving.run span; verify: {out['verify']}", flush=True)
    print(json.dumps({"suite": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# The model kernels: flash attention, RG-LRU scan, SSM scan
# ---------------------------------------------------------------------------

#: Kernel vs plain version, atol = rtol.  Attention: the JAX tests' own tolerances
#: (tests/kernels/test_flash_attention.py:42): 2e-6 in float32 (both sum D products
#: and a softmax over the same keys in float32, in other orders), 2e-2 in bfloat16
#: (the kernel rounds P to bf16 for the PV product on the tensor cores and takes its
#: exponentials with ex2.approx, and both round the output to bf16: they differ by a few
#: bf16 ulps).
#: SSM scan: tests/kernels/test_scans.py's 1e-4 (h rounds the same in both; y_t's
#: 16-term sum over n is a shuffle tree in the kernel, PyTorch's reduction in the
#: plain version).  The RG-LRU scan rounds every operation as its plain version does
#: and is held bit for bit (:func:`check_equal`).
ATTN_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
SCAN_TOL = 1e-4
#: Last-token logits of the kernel path vs the plain path at full width (bf16):
#: max |diff| <= LOGITS_TOL * (1 + max |plain logits|).  Each layer's bf16 output may
#: differ by an ulp between the two paths (the kernels sum in other orders), and the
#: differences pass through every later layer, so the bound is bf16's 2e-2 taken
#: relative to the logits' scale rather than element by element.
LOGITS_TOL = 2e-2

#: The served models and the kernel launches one prefill makes (whisper: 32 encoder + 32
#: decoder self-attentions; its cross-attention is plain, as in the JAX package).
MODELS = (
    ("glm4-9b", {"flash_attention": 40}),
    ("recurrentgemma-9b", {"flash_attention": 12, "rglru_scan": 26}),
    ("falcon-mamba-7b", {"ssm_scan": 64}),
    ("internlm2-20b", {"flash_attention": 48}),
    ("starcoder2-3b", {"flash_attention": 30}),
    ("starcoder2-7b", {"flash_attention": 32}),
    ("internvl2-1b", {"flash_attention": 24}),
    ("whisper-large-v3", {"flash_attention": 64}),
    ("arctic-480b", {"flash_attention": 2}),
    ("kimi-k2-1t-a32b", {"flash_attention": 1}),
)
#: Layers served of the MoE models, at their published widths (every other model serves
#: all its layers): arctic-480b's experts are 26.8 GB a layer, kimi-k2's 33.8 GB (+ 4.7 GB
#: of embeddings); two of kimi-k2's would be ~73 GB of the card's 80.
MODEL_LAYERS = {"arctic-480b": 2, "kimi-k2-1t-a32b": 1}
BATCH, PROMPT, DECODE_STEPS = 2, 4096, 16
MODEL_KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:107"),
    "rglru_scan": ("src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/kernel.py:38"),
    "ssm_scan": ("src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu", "src/repro/kernels/ssm_scan/kernel.py:49"),
}

#: Small attention cases: (B, Sq, Sk, KV, G, D, causal, window, q_offset), each in
#: float32 and bfloat16.  The bf16 wgmma + TMA body's tiles are 128 rows (128 // G
#: positions) x 128 keys (64 at D = 256).
ATTN_CASES = (
    (2, 200, 200, 2, 4, 64, True, 0, 0),  # causal GQA, ragged S (no multiple of a tile)
    (2, 256, 256, 4, 1, 64, False, 0, 0),  # bidirectional, G = 1
    (1, 300, 300, 1, 16, 128, True, 100, 0),  # window < S, G = 16, ragged
    (1, 256, 256, 2, 4, 64, True, 64, 0),  # window == the kv tile (64)
    (1, 96, 320, 2, 4, 32, True, 0, 224),  # q_offset > 0: suffix queries
    (1, 64, 320, 1, 16, 256, True, 96, 256),  # q_offset with a window, D = 256
    (2, 77, 77, 2, 2, 16, True, 0, 0),  # D = 16 (the smoke configs'), ragged
    (1, 150, 150, 1, 16, 256, True, 0, 0),  # D = 256 causal, ragged
    (1, 333, 333, 2, 3, 128, True, 0, 0),  # G = 3 (H = 6, KV = 2): 42 positions, 126 of 128 rows
    (2, 257, 257, 2, 4, 128, True, 0, 0),  # G = 4, one row past a tile
    (1, 200, 455, 1, 2, 64, True, 100, 255),  # Sk > Sq with q_offset; window off the kv tile; G = 2
    (2, 130, 130, 2, 1, 256, True, 300, 0),  # window > Sk; G = 1 at D = 256
    (1, 129, 300, 1, 4, 256, True, 70, 171),  # window 70 (kv tile 64), q_offset, D = 256
    (1, 190, 190, 1, 16, 128, False, 77, 0),  # bidirectional with a window, G = 16
    (2, 333, 333, 1, 8, 112, True, 0, 0),  # D = 112 (kimi-k2), G = 8, causal, ragged
    (1, 200, 455, 2, 8, 112, True, 100, 255),  # D = 112 with q_offset and a window off the kv tile
    (1, 150, 150, 1, 4, 112, False, 0, 0),  # D = 112 bidirectional
    (1, 300, 300, 2, 9, 128, True, 0, 0),  # G = 9 (starcoder2-7b): 14 positions, 126 of 128 rows
    (2, 250, 250, 1, 12, 128, True, 0, 0),  # G = 12 (starcoder2-3b): 10 positions, 120 rows
    (1, 301, 301, 2, 7, 64, True, 0, 0),  # G = 7 at D = 64 (internvl2-1b): 18 positions, 126 rows
    (2, 200, 200, 2, 6, 128, True, 0, 0),  # G = 6 (internlm2-20b): 21 positions, 126 rows
    (1, 300, 300, 4, 1, 64, False, 0, 0),  # bidirectional, G = 1, D = 64 (whisper's encoder)
)
#: Small scan cases: SSM (B, S, D, N, C dtype) and RG-LRU (B, S, W); no S is a multiple
#: of the steps a thread loads ahead (4 and 8) or of the RG-LRU chunk (64 steps).  RG-LRU
#: widths that are multiples of 4 take its TMA body (32 channels a block; 100 and 36 are
#: no multiple of 32), the others (130, 5) its per-channel body.
SSM_CASES = ((2, 77, 40, 16, "float32"), (1, 301, 24, 4, "bfloat16"), (2, 5, 8, 2, "float32"))
RGLRU_CASES = ((2, 77, 96), (1, 1001, 130), (3, 9, 5), (2, 333, 100), (1, 4100, 36))
#: Instructions counted in the kernels' SASS, and the kernels whose counts phase 2 prints.
SASS_OPS = ("HGMMA", "UTMALDG", "UTMASTG", "UBLKCP")
SASS_KERNELS = ("flash_attention_tma_kernel", "flash_attention_mma_kernel", "rglru_scan_tma_kernel",
                "rglru_scan_kernel")


def kernel_wrappers() -> dict:
    """Every kernel's launch wrapper (each keeps a ``launches`` count)."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru_scan import kernel as rglru
    from repro_torch.kernels.spot_sweep import kernel as sweep
    from repro_torch.kernels.ssm_scan import kernel as ssm

    from repro_torch.kernels.ckpt_codec import kernel as codec

    return {"spot_sweep": sweep, "flash_attention": flash, "rglru_scan": rglru, "ssm_scan": ssm, "ckpt_codec": codec}


def reset_launches() -> None:
    for mod in kernel_wrappers().values():
        mod.launches = 0


def read_launches() -> dict[str, int]:
    return {name: mod.launches for name, mod in kernel_wrappers().items()}


def torch_dtype(name):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def check_close(got, want, tol, what) -> float:
    """Fail unless ``got`` is finite and within atol = rtol = ``tol`` of ``want``;
    return the max abs error."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs plain {want.dtype}{tuple(want.shape)}")
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()):
        raise AssertionError(f"{what}: max abs err {float(err.max())} beyond atol = rtol = {tol}")
    return float(err.max()) if err.numel() else 0.0


def check_equal(got, want, what) -> float:
    """Fail unless ``got`` equals ``want`` bit for bit in value (``torch.equal``);
    return the max abs error, 0.0."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs plain {want.dtype}{tuple(want.shape)}")
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: differs from the plain version, max abs err {float((got - want).abs().max())}")
    return 0.0


def sass_counts(text: str) -> dict[str, dict[str, int]]:
    """Per function of a ``cuobjdump -sass`` listing, how many instructions of each
    of SASS_OPS it holds."""
    counts: dict[str, dict[str, int]] = {}
    current = None
    for line in text.splitlines():
        fn = re.search(r"Function\s*:\s*(\S+)", line)
        if fn:
            current = counts.setdefault(fn.group(1), dict.fromkeys(SASS_OPS, 0))
        elif current is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    current[op] += 1
    return counts


def kernel_sass(counts: dict[str, dict[str, int]]) -> dict[str, dict[str, int]]:
    """SASS_KERNELS' counts, summed over each kernel's template instances; a kernel
    name that is a prefix of another (``rglru_scan_kernel``) matches only itself."""
    out = {}
    for name in SASS_KERNELS:
        fns = [ops for fn, ops in counts.items() if re.search(rf"\d{name}(I|E|v|$)", fn)]
        out[name] = {"functions": len(fns), **{op: sum(ops[op] for ops in fns) for op in SASS_OPS}}
    return out


def print_sass(lib) -> None:
    """Phase 2's SASS line; fails when the attention's wgmma + TMA kernel has no HGMMA."""
    from repro_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        print(f"sass: no cuobjdump beside nvcc ({tool}); instructions not counted", flush=True)
        return
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    per_kernel = kernel_sass(sass_counts(text))
    print("sass:", json.dumps(per_kernel), flush=True)
    tma = per_kernel["flash_attention_tma_kernel"]
    if not tma["functions"] or tma["HGMMA"] == 0:
        raise AssertionError(f"the attention's wgmma kernel has no HGMMA instruction: {tma}")


def visible_pairs(sq, sk, causal, window, q_offset) -> int:
    """The (q, k) pairs that attention scores: k <= q + q_offset if causal, k > q +
    q_offset - window with a window."""
    import numpy as np

    qp = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(qp, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(sq, dtype=np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def attention_bound(q, k, causal, window, q_offset) -> tuple[float, str]:
    """Least time for one attention: 4 * D tensor-core operations per visible (q, k)
    pair and head (QK^T and PV) at the bf16 rate, or q, k, v read and o written once
    at HBM bandwidth, whichever is larger."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    ops = 4 * D * visible_pairs(Sq, Sk, causal, window, q_offset) * B * H
    nbytes = q.element_size() * (2 * B * Sq * H * D + 2 * B * Sk * KV * D)
    ops_ms, bytes_ms = 1e3 * ops / BF16_TENSOR_OPS_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def scan_bound(name, args) -> tuple[float, str]:
    """Least time for one scan: inputs read and outputs written once at HBM bandwidth,
    or its float32 operations (8 per element for RG-LRU, 5 per state element for the
    SSM scan) at the non-tensor float32 rate, whichever is larger."""
    if name == "rglru_scan":
        B, S, W = args[0].shape
        nbytes, ops = 4 * (3 * B * S * W + B * W), 8 * B * S * W
    else:
        dtA, _, C = args
        B, S, D, N = dtA.shape
        nbytes = 4 * 2 * dtA.numel() + C.element_size() * C.numel() + 4 * (B * S * D + B * D * N)
        ops = 5 * dtA.numel()
    ops_ms, bytes_ms = 1e3 * ops / F32_OPS_PER_S, 1e3 * nbytes / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def model_kernel_modules():
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rglru_scan import kernel as rglru
    from repro_torch.kernels.rglru_scan import ref as rglru_ref
    from repro_torch.kernels.ssm_scan import kernel as ssm
    from repro_torch.kernels.ssm_scan import ref as ssm_ref

    # name -> (wrapper module, its entry, the plain version)
    return {
        "flash_attention": (flash, flash.flash_attention, flash_ref.block_attention),
        "rglru_scan": (rglru, rglru.rglru_scan, rglru_ref.rglru_scan),
        "ssm_scan": (ssm, ssm.ssm_scan, ssm_ref.ssm_scan),
    }


def small_kernel_checks(device) -> dict[str, float]:
    """Each model kernel against its plain version at small shapes, on the card; returns
    the largest max abs error per kernel."""
    import numpy as np
    import torch

    mods = model_kernel_modules()
    rng = np.random.default_rng(0)
    errs = dict.fromkeys(mods, 0.0)

    def dev(x, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device=device, dtype=dtype)

    _, flash, flash_plain = mods["flash_attention"]
    for B, Sq, Sk, KV, G, D, causal, window, q_offset in ATTN_CASES:
        qn = rng.standard_normal((B, Sq, KV * G, D))
        kn, vn = rng.standard_normal((2, B, Sk, KV, D))
        for dtype in ATTN_TOL:
            q, k, v = (dev(x, torch_dtype(dtype)) for x in (qn, kn, vn))
            kw = dict(causal=causal, window=window, q_offset=q_offset)
            got = flash(q, k, v, **kw)
            want = flash_plain(q, k, v, q_block=64, kv_block=64, **kw)
            torch.cuda.synchronize()
            what = f"flash_attention B{B} Sq{Sq} Sk{Sk} KV{KV} G{G} D{D} causal={causal} window={window} q_offset={q_offset} {dtype}"
            errs["flash_attention"] = max(errs["flash_attention"], check_close(got, want, ATTN_TOL[dtype], what))
    print(f"small flash_attention: kernel == plain within tolerance on {2 * len(ATTN_CASES)} cases", flush=True)

    _, ssm, ssm_plain = mods["ssm_scan"]
    for B, S, D, N, c_dtype in SSM_CASES:
        dtA = dev(-np.logaddexp(rng.standard_normal((B, S, D, N)), 0.0))
        dBx = dev(rng.standard_normal((B, S, D, N)))
        C = dev(rng.standard_normal((B, S, N)), torch_dtype(c_dtype))
        got, want = ssm(dtA, dBx, C), ssm_plain(dtA, dBx, C)
        torch.cuda.synchronize()
        for g, w, out in zip(got, want, ("y", "h_last")):
            errs["ssm_scan"] = max(errs["ssm_scan"], check_close(g, w, SCAN_TOL, f"ssm_scan {out} {(B, S, D, N, c_dtype)}"))
    _, rglru, rglru_plain = mods["rglru_scan"]
    for B, S, W in RGLRU_CASES:
        log_a = dev(-np.logaddexp(rng.standard_normal((B, S, W)), 0.0))
        gx = dev(rng.standard_normal((B, S, W)))
        got, want = rglru(log_a, gx), rglru_plain(log_a, gx)
        torch.cuda.synchronize()
        for g, w, out in zip(got, want, ("h", "h_last")):
            errs["rglru_scan"] = max(errs["rglru_scan"], check_equal(g, w, f"rglru_scan {out} {(B, S, W)}"))
    print(f"small scans: kernel == plain within {SCAN_TOL} on {len(SSM_CASES)} SSM cases and bit for bit on "
          f"{len(RGLRU_CASES)} RG-LRU cases; max abs err {errs}", flush=True)
    return errs


def model_batch(cfg, device, seed=1, batch=BATCH, prompt=PROMPT) -> dict:
    """The requests: random prompt tokens from a seeded generator on the card, with
    random ``frames`` (an enc-dec's encoder input) or ``vision_embeds`` over the
    first ``vision_tokens`` positions of each prompt (a VLM's)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen, device=device)}
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if cfg.family == "encdec":
        out["frames"] = torch.randn((batch, cfg.encoder_positions, cfg.d_model), generator=gen, device=device,
                                    dtype=dtype)
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.randn((batch, cfg.vision_tokens, cfg.d_model), generator=gen, device=device,
                                           dtype=dtype)
        out["vision_mask"] = (torch.arange(prompt, device=device) < cfg.vision_tokens).expand(batch, prompt)
    return out


def serve(T, cfg, params, batch, impl) -> tuple:
    """Prefill the requests, then DECODE_STEPS greedy steps; returns (last-token
    prefill logits, the generated tokens, timings).  Decode runs the plain step
    functions on every path, as the JAX package does."""
    import torch

    from repro_torch.train.steps import greedy_sample

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, params, batch, PROMPT + DECODE_STEPS, impl=impl)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tok = greedy_sample(logits)
    tokens = [tok]
    for _ in range(DECODE_STEPS):
        step_logits, cache = T.decode_step(cfg, params, tok, cache)
        tok = greedy_sample(step_logits)
        tokens.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stats = {
        "prefill_s": t1 - t0,
        "ms_per_token": 1e3 * (t2 - t1) / DECODE_STEPS,
        "prompt_tokens_per_s": BATCH * PROMPT / (t1 - t0),
        "generated_tokens_per_s": BATCH * DECODE_STEPS / (t2 - t1),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    return logits, torch.cat(tokens, dim=1), stats


class FirstCalls:
    """Within the block, records the arguments of each kernel wrapper's first
    ``prepare`` (the full-width inputs of the first layer that calls it), and in
    ``shapes`` the first call of each other shape or mask."""

    def __init__(self, mods):
        self.mods = mods
        self.inputs: dict[str, tuple] = {}
        self.shapes: dict[str, dict] = {}
        self._orig: dict = {}

    def __enter__(self):
        for name, (mod, _, _) in self.mods.items():
            orig = self._orig[name] = mod.prepare

            def wrapped(*args, _name=name, _orig=orig, **kw):
                self.inputs.setdefault(_name, (args, kw))
                key = (tuple(tuple(a.shape) for a in args), tuple(sorted(kw.items())))
                self.shapes.setdefault(_name, {}).setdefault(key, (args, kw))
                return _orig(*args, **kw)

            mod.prepare = wrapped
        return self

    def __exit__(self, *exc):
        for name, (mod, _, _) in self.mods.items():
            mod.prepare = self._orig[name]


def sdpa_ms(q, k, v, causal, window, q_offset) -> float:
    """``scaled_dot_product_attention`` on the same inputs (``enable_gqa``, an explicit
    mask for a window), timed as the library's yardstick; the port never calls it."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    Sq, Sk = q.shape[1], k.shape[1]
    mask = None
    if window or q_offset:
        qp = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kp = torch.arange(Sk, device=q.device)[None, :]
        mask = kp <= qp if causal else torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if window:
            mask &= kp > qp - window
    is_causal = causal and mask is None
    try:
        F.scaled_dot_product_attention(qt[:, :, :1], kt, vt, attn_mask=None if mask is None else mask[:1],
                                       enable_gqa=True)
        kw = {"enable_gqa": True}
    except TypeError:  # a PyTorch without enable_gqa: expand the kv heads beforehand
        g = q.shape[2] // k.shape[2]
        kt, vt, kw = kt.repeat_interleave(g, dim=1), vt.repeat_interleave(g, dim=1), {}
    return time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, is_causal=is_causal, **kw), reps=10)


def attention_body(q) -> str:
    """The body of flash_attention.cu that serves q's dtype and head dim."""
    from repro_torch.kernels.flash_attention import kernel as flash

    d = q.shape[-1]
    if q.dtype != torch_dtype("bfloat16"):
        return f"fma D={d}"
    if d not in flash.TMA_HEAD_DIMS:
        return f"mma.sync D={d}"
    return f"wgmma+tma D={d}" + (" in the D=128 layout (TMA zero-fills columns 112-127)" if d == 112 else "")


def measure_kernel(name, mods, args, kw) -> dict:
    """Hold a kernel against its plain version on one layer's full-width inputs, then
    time its bare launch, its whole wrapper and the plain version."""
    import torch

    mod, entry, plain = mods[name]
    plain_kw = dict(kw, q_block=1024, kv_block=1024) if name == "flash_attention" else kw
    job = mod.prepare(*args, **kw)  # checks and allocation, outside the timed region
    got = mod.launch(job)
    want = plain(*args, **plain_kw)
    torch.cuda.synchronize()
    if name == "flash_attention":
        got, want = (got,), (want,)
        err = check_close(got[0], want[0], ATTN_TOL[str(args[0].dtype).removeprefix("torch.")], "full width attention")
    elif name == "rglru_scan":
        err = max(check_equal(g, w, "full width rglru_scan") for g, w in zip(got, want))
    else:
        err = max(check_close(g, w, SCAN_TOL, f"full width {name}") for g, w in zip(got, want))
    del got, want
    row = {
        "shape": [list(a.shape) for a in args],
        "dtype": str(args[0].dtype).removeprefix("torch."),
        "max_abs_err": err,
        "ms": time_ms(lambda: mod.launch(job), reps=10),
        "wrapper_ms": time_ms(lambda: entry(*args, **kw), reps=10),
        "plain_ms": time_ms(lambda: plain(*args, **plain_kw), reps=3),
    }
    if name == "flash_attention":
        row["bound_ms"], row["bound_by"] = attention_bound(args[0], args[1], kw["causal"], kw["window"], kw["q_offset"])
        row["library_ms"] = sdpa_ms(*args, kw["causal"], kw["window"], kw["q_offset"])
        row["bound_share"] = row["bound_ms"] / row["ms"]
        row["vs_library"] = row["ms"] / row["library_ms"]
        row["body"] = attention_body(args[0])
        row.update({k: kw[k] for k in ("causal", "window", "q_offset")})
    else:
        row["bound_ms"], row["bound_by"] = scan_bound(name, args)
        row["library_ms"] = None
    return row


def serve_models(device) -> dict[str, dict]:
    """Phase 6: serve each model at full width, kernel path then plain path, and
    measure each kernel on the inputs of its first layer.  Returns per kernel its
    launches per model and its full-width measurements per model."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    mods = model_kernel_modules()
    found = {name: {"launches": {}, "full_width": {}} for name in mods}
    for arch, expected in MODELS:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=MODEL_LAYERS.get(arch, full.n_layers))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = T.init_params(cfg, seed=0, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in params.values() if isinstance(x, torch.Tensor))
        n_params += sum(x.numel() for name in ("layers", "encoder") for layer in params.get(name, ())
                        for x in layer.values())
        batch = model_batch(cfg, device)
        # warm-up, not timed or counted: the first prefill at these shapes also pays for
        # loading and choosing the library's matmul kernels
        T.prefill(cfg, params, batch, PROMPT + DECODE_STEPS)
        torch.cuda.synchronize()

        reset_launches()
        logits, tokens, kernel_stats = serve(T, cfg, params, batch, impl=None)  # the main path
        launches = read_launches()
        if launches != {name: expected.get(name, 0) for name in launches}:
            raise AssertionError(f"{arch}: kernel launches {launches}, expected {expected}")
        same_bits = None
        if cfg.family == "moe":  # the dispatch and combine use no atomics: a rerun gives the same bits
            again, _ = T.prefill(cfg, params, batch, PROMPT + DECODE_STEPS)
            first, _ = T.prefill(cfg, params, batch, PROMPT + DECODE_STEPS)
            same_bits = torch.equal(again, first) and torch.equal(first, logits)
            if not same_bits:
                raise AssertionError(f"{arch}: two prefills of the same requests differ in their logits' bits")
            del again, first
        plain_logits, plain_tokens, plain_stats = serve(T, cfg, params, batch, impl="plain")
        if logits.shape != (BATCH, 1, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: logits {tuple(logits.shape)} or non-finite values")
        err = float((logits.float() - plain_logits.float()).abs().max())
        scale = float(plain_logits.float().abs().max())
        if not err <= LOGITS_TOL * (1.0 + scale):
            raise AssertionError(f"{arch}: kernel-path logits differ from the plain path's by {err} (scale {scale})")
        agree = torch.equal(tokens, plain_tokens)
        del logits, plain_logits

        # the model's first layers up to the first of each kind again (an enc-dec's first
        # encoder layer too), recording the kernels' inputs (the same as the full model's
        # first layers get); each shape an attention takes there is measured
        kinds = T.layer_kinds(cfg)
        n_first = max(kinds.index(kind) for kind in set(kinds)) + 1
        head = dataclasses.replace(cfg, n_layers=n_first, encoder_layers=min(cfg.encoder_layers, 1))
        head_params = dict(params, layers=params["layers"][:n_first])
        if "encoder" in params:
            head_params["encoder"] = params["encoder"][:1]
        with FirstCalls(mods) as calls:
            T.prefill(head, head_params, batch, PROMPT)
        del head_params
        for name in list(calls.inputs):
            found[name]["launches"][arch] = launches[name]
            for i, (args, kw) in enumerate(calls.shapes.pop(name).values()):
                label = arch if i == 0 else f"{arch} ({'decoder' if cfg.family == 'encdec' else i})"
                found[name]["full_width"][label] = measure_kernel(name, mods, args, kw)
            del args, kw
        calls.inputs.clear()

        print(json.dumps({"serving": {
            "model": arch, "layers": cfg.n_layers, "of_layers": full.n_layers,
            "encoder_layers": cfg.encoder_layers, "params_b": n_params / 1e9, "batch": BATCH,
            "prompt_tokens": PROMPT, "decode_steps": DECODE_STEPS, "init_s": init_s, "launches": launches,
            "logits_max_abs_err": err, "logits_scale": scale, "logits_tol": LOGITS_TOL * (1.0 + scale),
            "greedy_tokens_agree": agree, "moe_prefill_same_bits": same_bits, "kernel": kernel_stats,
            "plain": plain_stats,
        }}), flush=True)
        del params, batch, tokens, plain_tokens
        torch.cuda.empty_cache()
    return found


def model_kernel_rows(found, small_errs) -> list[dict]:
    """One row per model kernel for the kernels line: the first model that runs it
    gives the row's numbers, every model's are under ``by_model``."""
    rows = []
    for name, (source, replaces) in MODEL_KERNELS.items():
        runs = found[name]["full_width"]
        first = next(iter(runs))
        m = runs[first]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(found[name]["launches"].values()),
            "max_abs_err": max(max(r["max_abs_err"] for r in runs.values()), small_errs[name]),
            "ms": m["ms"], "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": m["library_ms"], "wrapper_ms": m["wrapper_ms"], "match": True,
            "model": first, "launches_by_model": found[name]["launches"], "by_model": runs,
        })
    return rows


# ---------------------------------------------------------------------------
# The training path: checkpoint codec, loss and gradients, train steps, campaign
# ---------------------------------------------------------------------------

CODEC_SOURCE = ("src/repro_torch/kernels/ckpt_codec/csrc/ckpt_codec.cu", "src/repro/kernels/ckpt_codec/kernel.py:27")
#: Small codec cases: element counts, each in float32, bfloat16 and float16.
CODEC_SIZES = (1, 255, 256, 257, 1000, 4096, (1 << 20) + 3)
#: Training checks on the smoke configs, kernels vs plain path.  bf16: the loss within
#: the serving tolerances (2e-2, 3e-2 for the hybrid; atol = rtol).  float32: the loss
#: within 1e-5 relative, and each leaf's gradient within 1e-4 of the largest |gradient|
#: of the plain path's leaf: the backward recomputes the plain version in both paths,
#: so they differ only where the kernel's float32 forward (within 2e-6 of the plain
#: version) moves the activations the backward starts from.
TRAIN_LOSS_TOL = {"dense": 2e-2, "vlm": 2e-2, "moe": 2e-2, "encdec": 2e-2, "hybrid": 3e-2, "ssm": 2e-2}
TRAIN_F32_LOSS_RTOL, TRAIN_F32_GRAD_TOL = 1e-5, 1e-4
#: The full-width training run: glm4-9b cut to 4 of its 40 layers (all 40 with AdamW are
#: 9.4 B parameters x 12 bytes = 113 GB, above the card's 80 GB).
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = "glm4-9b", 4, 2, 4096, 3
#: The spot campaign: tests/train/test_spot_trainer.py's trace, bid, step time and length.
CAMPAIGN_TRACE = ((0.0, 0.40), (3200.0, 1.00), (4000.0, 0.40))
CAMPAIGN = dict(a_bid=0.5, step_time_s=300.0, max_steps=12, codec="int8", async_io=True, keep=2)
#: A restored leaf against the saved one: half a quantization step of its block, plus the
#: rounding of q * scale to the leaf's dtype (relative to |saved| + half a step).
RESTORE_ROUNDING = {"bfloat16": 2.0**-8, "float16": 2.0**-10, "float32": 2.0**-22}


def codec_equal(got, want, what) -> None:
    """Fail unless the kernel's (q, scales, shape) equal the plain version's bit for
    bit (NaN scales where the plain version's are NaN; q of a NaN block is
    undefined in both and not compared)."""
    import torch

    (q, sc, shape), (q2, sc2, shape2) = got, want
    if shape != shape2 or q.shape != q2.shape or q.dtype != q2.dtype or sc.dtype != sc2.dtype:
        raise AssertionError(f"{what}: outputs {q.dtype}{tuple(q.shape)} / {sc.dtype}, plain {q2.dtype}{tuple(q2.shape)}")
    nan = torch.isnan(sc2)
    if not torch.equal(torch.isnan(sc), nan):
        raise AssertionError(f"{what}: NaN scales differ")
    if not torch.equal(sc[~nan].view(torch.int32), sc2[~nan].view(torch.int32)):
        raise AssertionError(f"{what}: scales differ")
    if not torch.equal(q[~nan], q2[~nan]):
        raise AssertionError(f"{what}: q differs in {int((q[~nan] != q2[~nan]).sum())} entries")


def small_codec_checks(device) -> int:
    """The codec kernel against its plain version on small inputs; returns the count of cases."""
    import torch

    from repro_torch.kernels.ckpt_codec import kernel as codec
    from repro_torch.kernels.ckpt_codec import ref as codec_ref

    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for dtype, top in ((torch.float32, 1e30), (torch.bfloat16, 1e30), (torch.float16, 6e4)):
        for n in CODEC_SIZES:
            cases.append((f"randn n={n}", (torch.randn(n, generator=gen, device=device) * 3).to(dtype)))
        x = torch.zeros(5 * 256 + 17, device=device)
        x[256:512] = torch.arange(256, device=device) * 0.5 - 64.0  # with 127 below: step 1, x.5 ties
        x[300] = 127.0
        x[512:768] = torch.linspace(-1.0, 1.0, 256, device=device) * top  # the type's range
        x[768:1024] = torch.logspace(-30 if dtype != torch.float16 else -7, 0, 256, device=device)  # tiny to 1
        x[1024:1280] = float("nan")
        x[1280:] = -0.0
        cases.append(("zeros, ties, range, NaN, -0", x.to(dtype)))
        # blocks of magnitude 1e-30 .. 1e30 (float16: 1e-7 .. 6e4), clipped to the type's finite range
        mags = torch.logspace(-30 if dtype != torch.float16 else -7, 30 if dtype != torch.float16 else 4.7, 64,
                              device=device)
        big = torch.finfo(dtype).max
        x = (torch.randn((64, 256), generator=gen, device=device) * mags[:, None]).clamp(-big, big)
        cases.append(("magnitudes", x.to(dtype)))
    for what, x in cases:
        got = codec.quantize(x)
        want = codec_ref.quantize(x)
        torch.cuda.synchronize()
        codec_equal(got, want, f"ckpt_codec {what} {x.dtype}")
    print(f"small ckpt_codec: kernel == plain bit for bit on {len(cases)} cases", flush=True)
    return len(cases)


def small_training_checks(device) -> dict:
    """loss_fn and its gradients through the kernels against impl="plain" on the smoke
    configs (bf16 and float32); every leaf must get a nonzero gradient through the
    kernels.  Returns the loss and largest relative gradient difference per model."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import _launch
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.models import transformer as T

    # the repair of the autograd graph: a launch outside its Function with grad-requiring
    # inputs raises instead of returning an output without a gradient
    q = torch.zeros((1, 16, 2, 16), device=device, requires_grad=True)
    try:
        flash.prepare(q, q[:, :, :1].detach(), q[:, :, :1].detach())
    except RuntimeError as e:
        if "outside its autograd Function" not in str(e):
            raise
    else:
        raise AssertionError("flash_attention.prepare accepted grad-requiring inputs outside its Function")
    del q, _launch

    out = {}
    for arch, _ in MODELS:
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
            params = T.init_params(cfg, seed=0, device=device)
            tokens = model_batch(cfg, device, seed=3, batch=2, prompt=65)
            batch = {**tokens, "tokens": tokens["tokens"][:, :-1], "labels": tokens["tokens"][:, 1:]}
            if "vision_mask" in batch:
                batch["vision_mask"] = batch["vision_mask"][:, :-1]
            res = {}
            for impl in (None, "plain"):
                leaves, treedef = tree_lib.flatten(params)
                wrt = [x.detach().requires_grad_(True) for x in leaves]
                reset_launches()
                loss, _ = T.loss_fn(cfg, treedef.unflatten(wrt), batch, q_block=16, kv_block=16, impl=impl,
                                   device=device)
                loss.backward()
                res[impl] = (float(loss.detach()), [x.grad for x in wrt], read_launches())
            (loss_k, grads_k, launched), (loss_p, grads_p, _) = res[None], res["plain"]
            if not any(launched[k] for k in ("flash_attention", "rglru_scan", "ssm_scan")):
                raise AssertionError(f"{arch} {dtype}: the kernel path launched no model kernel: {launched}")
            for i, g in enumerate(grads_k):
                if g is None or not bool((g != 0).any()) or not bool(torch.isfinite(g.float()).all()):
                    raise AssertionError(f"{arch} {dtype}: leaf {i} got no (or a non-finite) gradient through the kernels")
            rel = max(float((g.float() - gp.float()).abs().max()) / max(float(gp.float().abs().max()), 1e-30)
                      for g, gp in zip(grads_k, grads_p))
            if dtype == "bfloat16":
                tol = TRAIN_LOSS_TOL[cfg.family]
                if not abs(loss_k - loss_p) <= tol + tol * abs(loss_p):
                    raise AssertionError(f"{arch} bf16: loss {loss_k} vs plain {loss_p} beyond {tol}")
            else:
                if not abs(loss_k - loss_p) <= TRAIN_F32_LOSS_RTOL * abs(loss_p):
                    raise AssertionError(f"{arch} float32: loss {loss_k} vs plain {loss_p}")
                if not rel <= TRAIN_F32_GRAD_TOL:
                    raise AssertionError(f"{arch} float32: a gradient leaf differs by {rel} of its scale")
            out[f"{arch} {dtype}"] = {"loss": loss_k, "loss_plain": loss_p, "grad_max_rel_diff": rel,
                                      "launches": {k: v for k, v in launched.items() if v}}
    print(f"small training: loss and gradients through the kernels == plain path within tolerance: {out}", flush=True)
    return out


def codec_bound(x) -> tuple[float, str]:
    """Least time to quantize ``x``: the leaf read once and n_blocks * 260 bytes (q and
    scales) written once, at HBM bandwidth; its few operations per element are far below
    the card's rates."""
    n_blocks = -(-x.numel() // 256)
    return 1e3 * (x.numel() * x.element_size() + n_blocks * 260) / HBM_BYTES_PER_S, "bytes"


def check_codec_on_state(state, device) -> dict:
    """The codec kernel against its plain version, bit for bit, on every float leaf of
    1024 elements or more of ``state``; then its time on the biggest leaf."""
    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.checkpoint.manager import quantized
    from repro_torch.kernels.ckpt_codec import kernel as codec
    from repro_torch.kernels.ckpt_codec import ref as codec_ref

    leaves = [x for x in tree_lib.leaves(state) if quantized(x, "int8")]
    for i, x in enumerate(leaves):
        got = codec.quantize(x)
        want = codec_ref.quantize(x)
        torch.cuda.synchronize()
        codec_equal(got, want, f"full-width leaf {i} {x.dtype}{tuple(x.shape)}")
        del got, want
    def measure(x) -> dict:
        job = codec.prepare(x)
        bound_ms, bound_by = codec_bound(x)
        return {"shape": list(x.shape), "dtype": str(x.dtype).removeprefix("torch."),
                "ms": time_ms(lambda: codec.launch(job), reps=10),
                "wrapper_ms": time_ms(lambda: codec.quantize(x), reps=10),
                "plain_ms": time_ms(lambda: codec_ref.quantize(x), reps=3), "bound_ms": bound_ms, "bound_by": bound_by}

    size = lambda x: x.numel() * x.element_size()  # noqa: E731
    big = measure(max(leaves, key=size))  # a float32 moment of the embedding
    big_bf16 = measure(max((x for x in leaves if x.dtype == torch.bfloat16), key=size))  # the embedding
    print(f"full-width state: ckpt_codec kernel == plain bit for bit on all {len(leaves)} quantized leaves; "
          f"biggest {big['dtype']}{tuple(big['shape'])}: {big['ms']:.4f} ms (bound {big['bound_ms']:.4f} ms, "
          f"plain {big['plain_ms']:.3f} ms); {big_bf16['dtype']}{tuple(big_bf16['shape'])}: {big_bf16['ms']:.4f} ms "
          f"(bound {big_bf16['bound_ms']:.4f} ms)", flush=True)
    return {"leaves_checked": len(leaves), "max_abs_err": 0.0, **big, "bf16_leaf": big_bf16}


def train_cfg():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)


def step_split(cfg, opt_cfg, params, opt_state, batch, device) -> dict:
    """Seconds of one train step's parts, each ended by a synchronize: forward
    (loss_fn), backward (autograd.grad), AdamW; and one layer's attention alone:
    the kernel's forward and the plain version's recompute + gradient of the backward."""
    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.kernels import _launch
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_update

    leaves, treedef = tree_lib.flatten(params)
    wrt = [x.detach().requires_grad_(True) for x in leaves]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with FirstCalls({"flash_attention": (flash, None, None)}) as calls:
        loss, _ = T.loss_fn(cfg, treedef.unflatten(wrt), batch, remat=False, device=device)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, wrt)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del loss, wrt
    new = adamw_update(params, treedef.unflatten(list(grads)), opt_state, opt_cfg)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    del new, grads
    args, kw = calls.inputs["flash_attention"]
    q, k, v = (a.detach() for a in args)
    with torch.no_grad():
        fwd_ms = time_ms(lambda: flash.flash_attention(q, k, v, **kw), reps=5)
    g = torch.randn_like(q)
    plain_kw = dict(kw, q_block=1024, kv_block=1024)
    bwd_ms = time_ms(lambda: _launch.recompute_grads(flash_ref.block_attention, (q, k, v), (True,) * 3, (g,), **plain_kw),
                     reps=3)
    return {"forward_s": t1 - t0, "backward_s": t2 - t1, "adamw_s": t3 - t2,
            "attention_forward_ms_per_layer": fwd_ms, "attention_backward_recompute_ms_per_layer": bwd_ms,
            "layers": cfg.n_layers}


def train_full_width(device) -> tuple[dict, dict]:
    """Phase 9: the full-width train step.  Returns the training numbers and the
    codec's full-width measurement."""
    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = train_cfg()
    opt_cfg = AdamWConfig(lr=1e-4, moment_dtype="float32")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=device)
    opt_state = adamw_init(params, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_lib.leaves(params))
    state_bytes = sum(x.numel() * x.element_size() for x in tree_lib.leaves((params, opt_state)))
    codec_row = check_codec_on_state((params, opt_state), device)

    data = TokenStream(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=11, device=device)
    step = make_train_step(cfg, opt_cfg, remat=False, q_block=1024, kv_block=1024)
    batch = next(data)
    with torch.no_grad():  # the first step's loss through the plain versions, on the same params and batch
        loss_plain, _ = T.loss_fn(cfg, params, batch, impl="plain", device=device)
        loss_plain = float(loss_plain)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state, metrics = step(params, opt_state, batch)  # warm-up, untimed in the steps below
    first_loss = float(metrics["loss"])
    warmup_s = time.perf_counter() - t0
    tol = TRAIN_LOSS_TOL[cfg.family]
    if not abs(first_loss - loss_plain) <= tol + tol * abs(loss_plain):
        raise AssertionError(f"full-width training: first loss {first_loss} vs plain path {loss_plain}")

    times, launches, losses = [], [], []
    for _ in range(TRAIN_STEPS):
        batch = next(data)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        params, opt_state, metrics = step(params, opt_state, batch)  # the main path
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(read_launches())
        losses.append(float(metrics["loss"]))
    want = {name: (TRAIN_LAYERS if name == "flash_attention" else 0) for name in launches[0]}
    if any(l != want for l in launches):
        raise AssertionError(f"full-width training: launches per step {launches}, expected {want}")
    if not all(map(lambda x: x == x and abs(x) < 1e4, losses)):
        raise AssertionError(f"full-width training: losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    split = step_split(cfg, opt_cfg, params, opt_state, next(data), device)
    step_s = statistics.median(times)
    out = {
        "model": TRAIN_ARCH, "layers": TRAIN_LAYERS, "of_layers": 40, "params_b": n_params / 1e9,
        "state_gb": state_bytes / 1e9, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "init_s": init_s,
        "warmup_step_s": warmup_s, "step_s": times, "step_s_median": step_s,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "peak_memory_gb": peak_gb,
        "flash_attention_launches_per_step": launches[0]["flash_attention"],
        "first_loss": first_loss, "first_loss_plain": loss_plain, "losses": losses, "split": split,
    }
    print(f"full-width training: {TRAIN_LAYERS} layers, step {step_s:.3f} s, {out['tokens_per_s']:.0f} tokens/s, "
          f"peak {peak_gb:.2f} GB, first loss {first_loss:.4f} (plain {loss_plain:.4f})", flush=True)
    del params, opt_state, metrics, batch
    torch.cuda.empty_cache()
    return out, codec_row


class CampaignWatch:
    """Wraps a trainer's checkpoint manager: times each save (the trainer's pause),
    keeps a host copy of the saved state after the timed save, and holds each restore
    against it: a quantized leaf within half a quantization step of its block (plus the
    rounding of q * scale to the leaf's dtype), every other leaf equal."""

    def __init__(self, mgr):
        self.mgr = mgr
        self.saves: list[dict] = []
        self.restores: list[dict] = []
        self._saved: dict[int, list] = {}
        self._save, self._restore = mgr.save, mgr.restore
        mgr.save, mgr.restore = self.save, self.restore

    def save(self, step, tree, extra=None, *, block=True):
        import torch

        from repro_torch.checkpoint import tree as tree_lib

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        meta = self._save(step, tree, extra, block=block)
        torch.cuda.synchronize()
        self.saves.append({"step": step, "save_wall_s": time.perf_counter() - t0, "snapshot_s": meta.wall_time_s})
        self._saved[step] = [x.detach().to("cpu", copy=True) for x in tree_lib.leaves(tree)]
        return meta

    def restore(self, template, step=None):
        import torch

        from repro_torch.checkpoint import tree as tree_lib
        from repro_torch.checkpoint.manager import quantized

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, extra = self._restore(template, step)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        saved = self._saved[int(extra["step"])]
        worst: dict[str, float] = {}
        for i, (got, want) in enumerate(zip(tree_lib.leaves(tree), saved)):
            want = want.to(got.device)
            if got.dtype != want.dtype or got.shape != want.shape:
                raise AssertionError(f"restored leaf {i}: {got.dtype}{tuple(got.shape)} vs saved {want.dtype}{tuple(want.shape)}")
            if not quantized(want, "int8"):
                if not torch.equal(got, want):
                    raise AssertionError(f"restored leaf {i} differs from the saved one")
                continue
            n = want.numel()
            w = torch.nn.functional.pad(want.reshape(-1).float(), (0, (-n) % 256)).reshape(-1, 256)
            g = torch.nn.functional.pad(got.reshape(-1).float(), (0, (-n) % 256)).reshape(-1, 256)
            half = 0.5 * torch.clamp_min(w.abs().amax(dim=1, keepdim=True), 1e-12) / 127.0
            bound = half + (w.abs() + half) * RESTORE_ROUNDING[str(want.dtype).removeprefix("torch.")]
            err = (g - w).abs()
            if not bool((err <= bound).all()):
                raise AssertionError(f"restored leaf {i}: {float((err - bound).max())} beyond half a step")
            name = str(want.dtype).removeprefix("torch.")
            worst[name] = max(worst.get(name, 0.0), float((err / (2 * half)).max()))
            del w, g, half, bound, err
        self.restores.append({"step": int(extra["step"]), "restore_wall_s": restore_s, "max_err_in_steps_by_dtype": worst})
        return tree, extra


def d2h_rates(device) -> dict:
    """GB/s of one 2.5 GB device-to-host copy into pageable and into pinned host memory
    (a checkpoint's snapshot copies into pageable memory)."""
    import torch

    src = torch.empty(620_756_992, dtype=torch.float32, device=device)  # the size of an embedding moment
    out = {}
    for kind, pinned in (("pageable", False), ("pinned", True)):
        dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=pinned)
        dst.copy_(src)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize()
        out[kind] = src.numel() * 4 / 1e9 / (time.perf_counter() - t0)
        del dst
    return out


def spot_campaign(device) -> dict:
    """Phase 10: SpotTrainer on the full-width model with the int8 codec; one
    preemption, one restore."""
    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.checkpoint.manager import quantized
    from repro_torch.core import SimParams, step_trace
    from repro_torch.data import TokenStream
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.spot_trainer import SpotTrainer, SpotTrainerConfig
    from repro_torch.train.steps import make_train_step

    cfg = train_cfg()
    opt_cfg = AdamWConfig(lr=1e-4, moment_dtype="float32")
    shapes = T.init_params(cfg, seed=0, device="meta")
    state_meta = (shapes, adamw_init(shapes, opt_cfg))
    n_quantized = sum(quantized(x, "int8") for x in tree_lib.leaves(state_meta))
    ckpt_bytes = sum((-(-x.numel() // 256)) * 260 if quantized(x, "int8") else x.numel() * x.element_size()
                     for x in tree_lib.leaves(state_meta))
    need = (CAMPAIGN["keep"] + 1) * ckpt_bytes
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    free = shutil.disk_usage(build).free
    if free < need:
        raise RuntimeError(f"the campaign needs {need / 1e9:.1f} GB of disk under {build}, {free / 1e9:.1f} GB are free")

    def init():
        params = T.init_params(cfg, seed=0, device=device)
        return params, adamw_init(params, opt_cfg)

    with tempfile.TemporaryDirectory(dir=build, prefix="chip_smoke_ckpt_") as ckpt_dir:
        trainer = SpotTrainer(
            SpotTrainerConfig(a_bid=CAMPAIGN["a_bid"], ckpt_dir=ckpt_dir, max_steps=CAMPAIGN["max_steps"],
                              step_time_s=CAMPAIGN["step_time_s"], sim=SimParams(t_c=300.0, t_r=600.0),
                              codec=CAMPAIGN["codec"], async_io=CAMPAIGN["async_io"], keep=CAMPAIGN["keep"]),
            train_step=make_train_step(cfg, opt_cfg, remat=False, q_block=1024, kv_block=1024),
            init_params=init,
            data=TokenStream(vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=11, device=device),
            trace=step_trace(list(CAMPAIGN_TRACE)),
        )
        watch = CampaignWatch(trainer.mgr)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        report = trainer.run()  # the main path
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        launches = read_launches()
        written = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*") if f.is_file())
    if not (report.completed and report.n_preemptions == 1 and report.n_restores == 1 and report.n_checkpoints >= 1):
        raise AssertionError(f"campaign: {report}")
    if launches["ckpt_codec"] != report.n_checkpoints * n_quantized:
        raise AssertionError(f"campaign: ckpt_codec launched {launches['ckpt_codec']} times, expected "
                             f"{report.n_checkpoints} checkpoints x {n_quantized} quantized leaves")
    executed = len(report.losses)
    if launches["flash_attention"] != executed * TRAIN_LAYERS or not all(x == x for x in report.losses):
        raise AssertionError(f"campaign: {launches} over {executed} steps, losses {report.losses}")
    if len(watch.restores) != 1:
        raise AssertionError(f"campaign: {len(watch.restores)} restores checked")
    out = {
        "steps_done": report.steps_done, "steps_executed": executed, "virtual_time_s": report.virtual_time_s,
        "cost": report.cost, "n_checkpoints": report.n_checkpoints, "n_preemptions": report.n_preemptions,
        "n_restores": report.n_restores, "lease_log": report.lease_log, "wall_s": wall_s,
        "checkpoint_bytes": ckpt_bytes, "bytes_on_disk_at_end": written, "quantized_leaves": n_quantized,
        "launches": {k: v for k, v in launches.items() if v}, "saves": watch.saves, "restores": watch.restores,
        "t_c_estimate_s": trainer.t_c_estimate, "losses": report.losses, "d2h_gb_per_s": d2h_rates(device),
    }
    print(f"campaign: completed, {report.n_checkpoints} checkpoint(s), 1 preemption, 1 restore within half a step; "
          f"ckpt_codec launches {launches['ckpt_codec']}, wall {wall_s:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return out


def codec_row(measured, launches) -> dict:
    source, replaces = CODEC_SOURCE
    return {"name": "ckpt_codec", "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
            "max_abs_err": measured["max_abs_err"], "ms": measured["ms"], "plain_ms": measured["plain_ms"],
            "bound_ms": measured["bound_ms"], "bound_by": measured["bound_by"], "library_ms": None,
            "wrapper_ms": measured["wrapper_ms"], "match": True, "shape": measured["shape"], "dtype": measured["dtype"],
            "leaves_checked": measured["leaves_checked"], "bf16_leaf": measured["bf16_leaf"]}


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
        entry = re.search(r"Compiling entry function '.*_cu_[0-9a-f]{8}\d+(\w+?_kernel)(\w*)'", line)
        if entry:  # the kernel's name and its integer template arguments
            print("  ptxas:", entry.group(1), *re.findall(r"Li(\d+)E", entry.group(2)))
        elif "registers" in line or "spill" in line or "wgmma" in line or "setmaxnreg" in line:
            print("  ptxas:   ", line.replace("ptxas info    :", "").strip())
    print_sass(_build.library_path())

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

    reset_launches()
    res = run(sc)  # the main path, on the card
    torch.cuda.synchronize()
    counts = read_launches()
    launches = counts.pop("spot_sweep")
    if launches < 1 or any(counts.values()):
        raise AssertionError(f"the study's path launched spot_sweep {launches} times and the others {counts}")
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
    by_scheme = {}
    for scheme in sc.schemes:  # each scheme alone: which walk sets the time
        one = kernel.prepare((scheme,), *args[1:])
        by_scheme[scheme.value] = time_ms(lambda: kernel.launch(one), reps=10)
        del one
    plain_ms = time_ms(lambda: ref.sweep_plain(*args), reps=3)
    sweep_entry = sweep_row(launches, max_err, kernel_ms, plain_ms, sweep_bound(args, out), wrapper_ms, by_scheme,
                            chain_steps(args, out))

    walls = {}
    for label, eng in (("cuda", TorchEngine(device=device)), ("plain", TorchEngine(device=device, impl="plain"))):
        r = eng.run(sc)  # grid, tables and device copies are cached: this times the run itself
        t = r.timings
        walls[label] = {
            "wall_s": r.wall_s, "cells_per_s": r.cells_per_s, "sim_s": t.sim_s, "bill_s": t.bill_s,
            "grid_s": t.grid_s,
        }
    print(json.dumps({"engine": {"cells": res.n_cells, "setup_s": setup_s, **walls}}), flush=True)
    open_kills, open_completed = int(res.n_kills.sum()), int(res.completed.sum())
    del sc, args, res, res_plain, out, out_plain, job

    # -- 5. ACC beside the other five schemes -----------------------------------
    six_launches = acc_phase(device)
    sweep_entry["launches_by_path"] = {"five_schemes": sweep_entry["launches"], "six_schemes": six_launches}
    sweep_entry["launches"] += six_launches

    # -- 6. contended markets: capacity studies through the sweep kernel --------
    capacity_launches = capacity_phase(device, open_kills, open_completed)
    sweep_entry["launches_by_path"]["capacity"] = capacity_launches
    sweep_entry["launches"] += sum(capacity_launches.values())

    # -- 7. the fleet: placement and attempt waves on the card ----------------
    fleet_phase(device)

    # -- 8. serving under spot auto-scaling: the batch engine's waves on the card
    autoscale_phase(device)

    # -- 9. the suite control plane: a serving suite through the run store -----
    suite_phase(device)

    # -- 10. the model kernels vs their plain versions at small shapes --------
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    small_errs = small_kernel_checks(device)

    # -- 11. serving at full width -------------------------------------------
    found = serve_models(device)

    # -- 12. the codec kernel vs its plain version at small sizes ---------------
    small_codec_checks(device)

    # -- 13. training through the kernels at small sizes -----------------------
    small_train = small_training_checks(device)

    # -- 14. training at full width --------------------------------------------
    training, codec_measured = train_full_width(device)

    # -- 15. the spot campaign at full width ----------------------------------
    campaign = spot_campaign(device)
    print(json.dumps({"training": {"card": card, **training, "campaign": campaign, "small": small_train}}), flush=True)

    # -- 16. the kernels line -------------------------------------------------
    rows = model_kernel_rows(found, small_errs)
    for row in rows:
        extra = campaign["launches"].get(row["name"], 0) + (
            TRAIN_STEPS * training["flash_attention_launches_per_step"] if row["name"] == "flash_attention" else 0)
        if extra:
            row["launches_by_path"] = {"serving": row["launches"], "training": extra}
            row["launches"] += extra
    codec = codec_row(codec_measured, campaign["launches"]["ckpt_codec"])
    print(json.dumps({"kernels": [sweep_entry, *rows, codec]}), flush=True)

    # -- 17. the result line ------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
