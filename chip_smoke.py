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
   full-width inputs with CUDA events and prints one JSON line for the engine.
5. Holds each model kernel (flash attention, RG-LRU scan, SSM scan) against
   its plain PyTorch version on the card at small shapes: causal and
   bidirectional attention, windows, ``q_offset``, ragged lengths, GQA
   G in {1, 4, 16}, head dims 16-256, float32 and bfloat16; scans of ragged
   lengths on random inputs from a seed.
6. Serves each of glm4-9b, recurrentgemma-9b and falcon-mamba-7b at its full
   published config (every layer, random weights from a seeded
   ``torch.Generator`` on the card): 2 requests of 4096 prompt tokens, prefill,
   then 16 greedy decode steps, through ``repro_torch.models.transformer``,
   after one untimed warm-up prefill.  The kernels' launch counts are reset
   just before the timed prefill and read just after (40 flash; 12 flash + 26
   RG-LRU; 64 SSM).  The same requests then go
   through the plain versions on the card (``impl="plain"``) and the
   last-token logits are compared.  Each kernel is then held against its plain
   version, and timed, on the full-width inputs of the first layer that called
   it, beside its bound and (attention) ``scaled_dot_product_attention``.
   Prints one ``{"serving": ...}`` line per model.
7. Prints one ``{"kernels": [...]}`` line with the four kernels.
8. Prints ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import re
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


# ---------------------------------------------------------------------------
# The model kernels: flash attention, RG-LRU scan, SSM scan
# ---------------------------------------------------------------------------

#: Kernel vs plain version, atol = rtol.  Attention: the JAX tests' own tolerances
#: (tests/kernels/test_flash_attention.py:42): 2e-6 in float32 (both sum D products
#: and a softmax over the same keys in float32, in other orders), 2e-2 in bfloat16
#: (the kernel rounds P to bf16 for the PV product on the tensor cores, and both round
#: the output to bf16: they differ by a few bf16 ulps).
#: Scans: tests/kernels/test_scans.py's 1e-4 (h rounds the same in both; y_t's
#: 16-term sum over n is a shuffle tree in the kernel, PyTorch's reduction in the
#: plain version).
ATTN_TOL = {"float32": 2e-6, "bfloat16": 2e-2}
SCAN_TOL = 1e-4
#: Last-token logits of the kernel path vs the plain path at full width (bf16):
#: max |diff| <= LOGITS_TOL * (1 + max |plain logits|).  Each layer's bf16 output may
#: differ by an ulp between the two paths (the kernels sum in other orders), and the
#: differences pass through every later layer, so the bound is bf16's 2e-2 taken
#: relative to the logits' scale rather than element by element.
LOGITS_TOL = 2e-2

#: The served models and the kernel launches one prefill makes.
MODELS = (
    ("glm4-9b", {"flash_attention": 40}),
    ("recurrentgemma-9b", {"flash_attention": 12, "rglru_scan": 26}),
    ("falcon-mamba-7b", {"ssm_scan": 64}),
)
BATCH, PROMPT, DECODE_STEPS = 2, 4096, 16
MODEL_KERNELS = {
    "flash_attention": ("src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:107"),
    "rglru_scan": ("src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/kernel.py:38"),
    "ssm_scan": ("src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu", "src/repro/kernels/ssm_scan/kernel.py:49"),
}

#: Small attention cases: (B, Sq, Sk, KV, G, D, causal, window, q_offset), each in
#: float32 and bfloat16.
ATTN_CASES = (
    (2, 200, 200, 2, 4, 64, True, 0, 0),  # causal GQA, ragged S (no multiple of a tile)
    (2, 256, 256, 4, 1, 64, False, 0, 0),  # bidirectional, G = 1
    (1, 300, 300, 1, 16, 128, True, 100, 0),  # window < S, G = 16, ragged
    (1, 256, 256, 2, 4, 64, True, 64, 0),  # window == the kv tile (64)
    (1, 96, 320, 2, 4, 32, True, 0, 224),  # q_offset > 0: suffix queries
    (1, 64, 320, 1, 16, 256, True, 96, 256),  # q_offset with a window, D = 256
    (2, 77, 77, 2, 2, 16, True, 0, 0),  # D = 16 (the smoke configs'), ragged
    (1, 150, 150, 1, 16, 256, True, 0, 0),  # D = 256 causal, ragged
)
#: Small scan cases: SSM (B, S, D, N, C dtype) and RG-LRU (B, S, W); no S is a multiple
#: of the steps a thread loads ahead (4 and 8).
SSM_CASES = ((2, 77, 40, 16, "float32"), (1, 301, 24, 4, "bfloat16"), (2, 5, 8, 2, "float32"))
RGLRU_CASES = ((2, 77, 96), (1, 1001, 130), (3, 9, 5))


def kernel_wrappers() -> dict:
    """Every kernel's launch wrapper (each keeps a ``launches`` count)."""
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.rglru_scan import kernel as rglru
    from repro_torch.kernels.spot_sweep import kernel as sweep
    from repro_torch.kernels.ssm_scan import kernel as ssm

    return {"spot_sweep": sweep, "flash_attention": flash, "rglru_scan": rglru, "ssm_scan": ssm}


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
            errs["rglru_scan"] = max(errs["rglru_scan"], check_close(g, w, SCAN_TOL, f"rglru_scan {out} {(B, S, W)}"))
    print(f"small scans: kernel == plain within {SCAN_TOL} on {len(SSM_CASES)} SSM and {len(RGLRU_CASES)} RG-LRU cases; "
          f"max abs err {errs}", flush=True)
    return errs


def serve(T, cfg, params, prompt, impl) -> tuple:
    """Prefill the prompt, then DECODE_STEPS greedy steps; returns (last-token
    prefill logits, the generated tokens, timings).  Decode runs the plain step
    functions on every path, as the JAX package does."""
    import torch

    from repro_torch.train.steps import greedy_sample

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, params, {"tokens": prompt}, PROMPT + DECODE_STEPS, impl=impl)
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
    ``prepare`` (the full-width inputs of the first layer that calls it)."""

    def __init__(self, mods):
        self.mods = mods
        self.inputs: dict[str, tuple] = {}
        self._orig: dict = {}

    def __enter__(self):
        for name, (mod, _, _) in self.mods.items():
            orig = self._orig[name] = mod.prepare

            def wrapped(*args, _name=name, _orig=orig, **kw):
                self.inputs.setdefault(_name, (args, kw))
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
        got, want, tol = (got,), (want,), ATTN_TOL[str(args[0].dtype).removeprefix("torch.")]
    else:
        tol = SCAN_TOL
    err = max(check_close(g, w, tol, f"full width {name}") for g, w in zip(got, want))
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
        cfg = get_config(arch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = T.init_params(cfg, seed=0, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(x.numel() for x in params.values() if isinstance(x, torch.Tensor))
        n_params += sum(x.numel() for layer in params["layers"] for x in layer.values())
        gen = torch.Generator(device=device).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device)
        # warm-up, not timed or counted: the first prefill at these shapes also pays for
        # loading and choosing the library's matmul kernels
        T.prefill(cfg, params, {"tokens": prompt}, PROMPT + DECODE_STEPS)
        torch.cuda.synchronize()

        reset_launches()
        logits, tokens, kernel_stats = serve(T, cfg, params, prompt, impl=None)  # the main path
        launches = read_launches()
        if launches != {name: expected.get(name, 0) for name in launches}:
            raise AssertionError(f"{arch}: kernel launches {launches}, expected {expected}")
        plain_logits, plain_tokens, plain_stats = serve(T, cfg, params, prompt, impl="plain")
        if logits.shape != (BATCH, 1, cfg.padded_vocab) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: logits {tuple(logits.shape)} or non-finite values")
        err = float((logits.float() - plain_logits.float()).abs().max())
        scale = float(plain_logits.float().abs().max())
        if not err <= LOGITS_TOL * (1.0 + scale):
            raise AssertionError(f"{arch}: kernel-path logits differ from the plain path's by {err} (scale {scale})")
        agree = torch.equal(tokens, plain_tokens)
        del logits, plain_logits

        # the model's first layers up to the first of each kind again, recording the
        # kernels' inputs (the same as the full model's first layers get)
        kinds = T.layer_kinds(cfg)
        n_first = max(kinds.index(kind) for kind in set(kinds)) + 1
        head = dataclasses.replace(cfg, n_layers=n_first)
        with FirstCalls(mods) as calls:
            T.prefill(head, dict(params, layers=params["layers"][:n_first]), {"tokens": prompt}, PROMPT)
        for name in list(calls.inputs):
            args, kw = calls.inputs.pop(name)
            found[name]["launches"][arch] = launches[name]
            found[name]["full_width"][arch] = measure_kernel(name, mods, args, kw)
            del args, kw

        print(json.dumps({"serving": {
            "model": arch, "layers": cfg.n_layers, "params_b": n_params / 1e9, "batch": BATCH,
            "prompt_tokens": PROMPT, "decode_steps": DECODE_STEPS, "init_s": init_s, "launches": launches,
            "logits_max_abs_err": err, "logits_scale": scale, "logits_tol": LOGITS_TOL * (1.0 + scale),
            "greedy_tokens_agree": agree, "kernel": kernel_stats, "plain": plain_stats,
        }}), flush=True)
        del params, prompt, tokens, plain_tokens
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
        elif "registers" in line or "spill" in line:
            print("  ptxas:   ", line.replace("ptxas info    :", "").strip())

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
    plain_ms = time_ms(lambda: ref.sweep_plain(*args), reps=3)
    bound_ms, bound_by = sweep_bound(args, out)
    sweep_row = {
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
    }

    walls = {}
    for label, eng in (("cuda", TorchEngine(device=device)), ("plain", TorchEngine(device=device, impl="plain"))):
        r = eng.run(sc)  # grid, tables and device copies are cached: this times the run itself
        t = r.timings
        walls[label] = {
            "wall_s": r.wall_s, "cells_per_s": r.cells_per_s, "sim_s": t.sim_s, "bill_s": t.bill_s,
            "grid_s": t.grid_s,
        }
    print(json.dumps({"engine": {"cells": res.n_cells, "setup_s": setup_s, **walls}}), flush=True)
    del sc, args, res, res_plain, out, out_plain, job

    # -- 5. the model kernels vs their plain versions at small shapes --------
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    small_errs = small_kernel_checks(device)

    # -- 6. serving at full width -------------------------------------------
    found = serve_models(device)

    # -- 7. the kernels line --------------------------------------------------
    print(json.dumps({"kernels": [sweep_row, *model_kernel_rows(found, small_errs)]}), flush=True)

    # -- 8. the result line -------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
