#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one GPU: build, check, run the §VII study, contended markets, the fleet, auto-scaled serving and the suite, serve all ten models, train, run the distribution substrate as four ranks, train placed on a mesh of four ranks, serve placed on four ranks and run the dry run.

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
   widths (random weights from a seed, drawn on the card in the JAX package's
   ``jax.random`` stream, after a check that the card draws the CPU's words):
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
   launches counted.
15. Runs a spot campaign on that model through ``SpotTrainer`` (int8 codec,
   async writes, ``keep=2``, a checkpoint directory removed at exit) on the
   trace of ``tests/train/test_spot_trainer.py``: one preemption, one restore,
   ``ckpt_codec`` launched once per quantized leaf per checkpoint, and the
   restored state within half a quantization step per block of the saved
   one.  Prints one ``{"training": ...}`` line.
16. The distribution substrate, with four ranks of one gloo process group as
   four processes on the one card (``repro_torch.parallel.ranks.run_ranks``;
   the kernels are built before any rank starts).  Error-feedback int8
   gradient compression of phase 14's model (a random bf16 gradient tree from
   a seed, 3 steps carrying the residual): card == CPU bit for bit on the sent
   gradients and residuals of ``COMPRESS_SAMPLE``'s leaves, the invariant
   sent + new residual == gradient + old residual on every leaf, and the time
   of a call.  Sequence-parallel decode of internlm2-20b (``SP_*``: 8 of its 48
   layers at its published widths, one request, a cache of 32,768 slots, 8,192
   a rank): a flash-attention prefill of ``SP_PROMPT`` tokens, then 8 decode
   steps, on a 1 x 4 (data, model) mesh with ``kv_seq`` on ``model``, against
   the same model's single-process decode on the card (run first, its logits
   and layer 0's cache kept on the host; its layer-0 prefill flash attention at
   the full 24,584 tokens held against ``naive_attention`` within
   ``ATTN_TOL``): the ranks' logits equal each other and lie within
   ``LOGITS_TOL`` of the single-process ones; the ranks' layer-0 cache slices
   side by side equal the single-process cache bit for bit; layer 0's merged
   attention at every step lies within ``SP_MERGE_TOL`` of the plain decode
   attention over that cache, and two broken merges (alpha left out, rank 0's
   partial dropped) miss that bound; the prefill's flash launches are counted
   in each rank.  Expert-parallel MoE: arctic-480b's MoE block at its
   published widths (128 experts, 32 a rank; the parent's weights reach the
   ranks through CUDA IPC) on 2 x 4096 tokens against the single-process
   ``apply_moe`` (run first, its output kept on the host): every element of y
   within ``EP_ULPS`` bf16 ulp, the load-balance loss within ``EP_LB_RTOL``,
   the dropped assignments equal.  Each rank also times gloo's ``all_reduce``
   at its path's sizes.  Prints one ``{"parallel": ...}`` line with the
   times, the cuts and the tolerances.
17. Mesh-placed execution, four gloo ranks on the one card on a 2 x 2 ``data x
   model`` mesh (``MESH_*``; DTensor's all-gather of CUDA tensors goes through
   :mod:`repro_torch.parallel.gloo_cuda`, built on gloo's ``all_reduce``):
   (a) glm4-9b at its published widths with 4 of its 40 layers, parameters,
   AdamW state (bf16 moments: four ranks share the card) and a 2 x 2048 batch
   placed by ``shard_params``, one warm-up and one timed step, the loss and
   the grad norm of both against the single-process step on the card (run
   first) within ``TRAIN_LOSS_TOL``, flash attention launched 4 times a
   forward in each rank, every leaf split both ways holding a quarter a rank,
   the timed step's all-gathers (calls, bytes), and gloo's collectives of the
   path timed at their sizes in the ranks; (b)
   one ``loss_fn`` and its gradient of falcon-mamba-7b (2 layers) and
   recurrentgemma-9b (3 layers) at published widths, 2 x 512 tokens, the
   ``ssm_scan`` / ``rglru_scan`` / flash launches counted in each rank,
   against the single process; (c) ``repro_torch.launch.elastic_restart``'s
   two launches at (a)'s widths and depth, int8 checkpoint, 2 steps each: 2
   ranks on ``(2,)`` (rank 0 alone quantizes), then 4 on ``(2, 2)`` restoring
   with ``shardings=``; every rank's restored shard equal to the single
   process's restored leaf's slice (a 64-bit checksum of its bits), launch 2's
   losses against one process restoring the same checkpoint within
   ``TRAIN_LOSS_TOL``.  Prints one ``{"mesh": ...}`` line.
18. Placed serving, four gloo ranks on the one card (``PLACED_*``): prefill and
   decode through ``repro_torch.models.transformer`` on parameters placed by
   ``shard_params`` and a cache placed by ``cache_axes``, each case against the
   same model's single-process run on the card (run first, its logits and greedy
   tokens kept on the host; the ranks' decode fed its tokens): every step's
   logits within ``LOGITS_TOL`` of one process, the ranks' own greedy tokens
   compared and their agreement printed, the kernels' launches a prefill counted
   in each rank and decode launching none, each kernel's first call of each shape
   in every rank's prefill held against its plain version on the same local
   shards (flash attention within ``ATTN_TOL``, the RG-LRU scan bit for bit, the
   SSM scan within ``SCAN_TOL``).  (a) glm4-9b at its published widths
   with 4 of 40 layers on 2 x 2: 2 x 2048 tokens into a 4096-slot cache, 8 decode
   steps (flash attention 4 a prefill a rank), then the same with ``kv_seq`` on
   ``model`` (the cache split along its slots, the SP merge placed); (b)
   recurrentgemma-9b (3 layers; its 2048-slot window cache wraps in decode) and
   falcon-mamba-7b (2 layers) likewise, ``rglru_scan`` / ``ssm_scan`` / flash
   launches counted; (c) arctic-480b with 1 of 35 layers on 1 x 4 (32 experts a
   rank, the parent's weights by CUDA IPC), 2 x 1024 and 4 steps, the placed
   ``apply_moe`` and ``moe_impl="ep"``; (d) whisper-large-v3 (32 + 32 layers)
   and internvl2-1b (24 layers) at full depth, 2 x 1024 and 8 steps, then one
   placed ``loss_fn`` and its gradient at 2 x 512, the loss and the gradient's
   norm within ``TRAIN_LOSS_TOL`` of one process; (e) ``python -m
   repro_torch.launch.dryrun`` for ``PLACED_DRYRUN``'s two cells on the host
   (started with the phase, beside the single-process runs), each record ``ok``.  Prints one
   ``{"placed_serving": ...}`` line.
19. Prints one ``{"phase_s": ...}`` line (each phase's wall seconds, by number), then
   one ``{"kernels": [...]}`` line with the five kernels (the attention
   row with ``bound_share`` = bound / ms and ``vs_library`` = ms / library ms
   for each served model; the sweep row with ``by_scheme``, ``chain_steps``
   and ``ns_per_step`` = ms × 1e6 / chain_steps; its launches by path: the
   five-scheme study of phase 4, the six-scheme study of phase 5 and the
   contended studies of phase 6; the model kernels' and the codec's: serving,
   training and the campaign, the SP decode's prefills in the ranks of phase
   16, the mesh phase's ranks and the placed-serving phase's ranks; a model
   kernel's ``max_abs_err`` the worst of its checks, phase 18's included).
20. Prints ``{"ok": true, "device": {...}}`` as the last line.

Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
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
            if not e.is_user_annotation():  # a range's annotation on the device's timeline is no work
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
            if not e.is_user_annotation():  # a range's annotation on the device's timeline is no work
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
            if not e.is_user_annotation():  # a range's annotation on the device's timeline is no work
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


def init_stream_check(device) -> None:
    """The random init's stream on the card: its threefry words equal the CPU's, and
    its truncated normal the CPU's but for log / log1p rounding (an ulp)."""
    import torch

    from repro_torch.data import threefry
    from repro_torch.models.params import truncated_normal

    key, start, n = threefry.split(threefry.prng_key(7), 3)[2], 2**32 - 4096, 1 << 20
    if not torch.equal(threefry.random_bits(key, start, n, device).cpu(), threefry.random_bits(key, start, n)):
        raise AssertionError("init stream: the card's threefry words differ from the CPU's")
    got, want = truncated_normal(key, start, n, device).cpu(), truncated_normal(key, start, n, "cpu")
    same = float((got.view(torch.int32) == want.view(torch.int32)).float().mean())
    err = float((got - want).abs().max())
    if not err <= 2.0**-20:
        raise AssertionError(f"init stream: the card's truncated normal {err} from the CPU's")
    print(f"init stream: threefry words card == CPU on {n}; truncated normal {same:.6f} bit for bit, "
          f"within {err:.3g}", flush=True)


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
    step_s = statistics.median(times)
    out = {
        "model": TRAIN_ARCH, "layers": TRAIN_LAYERS, "of_layers": 40, "params_b": n_params / 1e9,
        "state_gb": state_bytes / 1e9, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "init_s": init_s,
        "warmup_step_s": warmup_s, "step_s": times, "step_s_median": step_s,
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s, "peak_memory_gb": peak_gb,
        "flash_attention_launches_per_step": launches[0]["flash_attention"],
        "first_loss": first_loss, "first_loss_plain": loss_plain, "losses": losses,
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

    def restore(self, template, step=None, **kw):
        import torch

        from repro_torch.checkpoint import tree as tree_lib
        from repro_torch.checkpoint.manager import quantized

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, extra = self._restore(template, step, **kw)
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


# ---------------------------------------------------------------------------
# The parallel phase: four ranks on the one card (gloo), compression, SP, EP
# ---------------------------------------------------------------------------

PARALLEL_RANKS = 4
#: Gradient compression: the training phase's model (glm4-9b, 4 of 40 layers), a
#: random bf16 gradient tree from a seed, steps that carry the residual, and the
#: leaves also compressed on the CPU (every block of each, bit for bit).
COMPRESS_STEPS = 3
COMPRESS_SAMPLE = (("final_norm.scale",), ("layers", 0, "norm1.scale"), ("layers", 1, "attn.wk"),
                   ("layers", 2, "attn.wq"), ("layers", 3, "mlp.wo"))
#: SP decode: internlm2-20b at its published attention widths (48 q heads, 8 KV, D 128)
#: with 8 of its 48 layers and one request (four copies of 48 layers do not fit the
#: card: each rank holds the whole model), a cache of decode_32k's 32,768 slots,
#: 8,192 a rank; the prompt fills three ranks' slices and 8 slots of the fourth, and
#: 8 decode steps (teacher-forced from the same seeded tokens) append into the fourth.
SP_ARCH, SP_LAYERS, SP_BATCH, SP_CACHE, SP_STEPS = "internlm2-20b", 8, 1, 32768, 8
SP_PROMPT = 3 * SP_CACHE // PARALLEL_RANKS + 8
#: EP MoE: arctic-480b's MoE block at its published widths (128 experts, 32 a rank,
#: top-2, capacity factor 1.25: some assignments drop) on 2 x 4096 tokens.
EP_ARCH, EP_BATCH, EP_TOKENS, EP_REPS = "arctic-480b", 2, 4096, 3
#: The phase's tolerances.  Compression: bit for bit against the CPU; the
#: error-feedback invariant within one bf16 ulp of what was sent (the transform
#: rounds the float32 dequantized gradient to the leaf's dtype; the residual keeps
#: the float32 error).  SP decode: the logits against the single-process decode on
#: the card within LOGITS_TOL of their scale (both bf16 models; the SP merge sums
#: four float32 partial softmaxes).  The logits barely see the merge (with random
#: weights attention over 24k keys is near uniform and adds little to the residual
#: stream), so layer 0's merged attention is held directly: max |sp - plain| <=
#: SP_MERGE_TOL * max |plain| over the 8 steps, plain the port's plain decode
#: attention over the whole cache (both round a float32 result to bf16 once, so
#: they differ by at most one bf16 ulp, 2^-8 of an element).  The prefill's flash
#: attention at layer 0 against naive_attention within ATTN_TOL, SP_CHUNK queries
#: at a time.  EP MoE: every element of y within EP_ULPS bf16 ulp of apply_moe's
#: (a token's two experts may sit on two ranks, whose float32 sum rounds once to
#: bf16 as the dense layer's add does, unless it was inexact in float32), the
#: load-balance loss within EP_LB_RTOL, the dropped assignments equal in number.
EP_ULPS, EP_LB_RTOL = 1, 1e-5
SP_MERGE_TOL, SP_CHUNK = 1e-2, 512
#: Broken merges that the SP merge check must catch.
SP_FAULTS = ("alpha_left_out", "rank0_dropped")


def parallel_cuts() -> dict:
    """What the parallel phase cuts from its models' published sizes."""
    return {
        "compression": {"model": TRAIN_ARCH, "layers": TRAIN_LAYERS, "of_layers": 40},
        "sp_decode": {"model": SP_ARCH, "layers": SP_LAYERS, "of_layers": 48, "batch": SP_BATCH,
                      "prompt": SP_PROMPT, "cache": SP_CACHE, "decode_steps": SP_STEPS},
        "ep_moe": {"model": EP_ARCH, "layers": "one MoE block", "of_layers": 35, "tokens": EP_BATCH * EP_TOKENS},
    }


def parallel_tolerances() -> dict:
    return {"compression": "bit for bit vs the CPU; invariant within 1 bf16 ulp", "sp_decode_logits": LOGITS_TOL,
            "sp_merge_of_scale": SP_MERGE_TOL, "sp_prefill_flash": ATTN_TOL["bfloat16"], "ep_moe_y_bf16_ulps": EP_ULPS,
            "ep_moe_load_balance_rtol": EP_LB_RTOL, "ep_moe_dropped": "equal"}


def bf16_ulps(got, want) -> float:
    """The largest |got - want| in units of one bf16 ulp of ``want``, element by
    element (an element of ``want`` that is 0 must be matched exactly)."""
    import torch

    got, want = got.float(), want.float()
    _, exp = torch.frexp(want)  # |want| = m * 2**exp, 0.5 <= m < 1: bf16 steps by 2**(exp - 8)
    ulp = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(want), exp - 8))
    err = (got - want).abs()
    return float(torch.where(err == 0, 0.0, err / ulp).max()) if err.numel() else 0.0


class Recorder:
    """Wraps ``getattr(module, name)`` while in use and keeps ``(args, kwargs,
    result)`` of every ``every``-th call, from the first, at most ``limit``."""

    def __init__(self, module, name, every=1, limit=None):
        self.module, self.name, self.every, self.limit = module, name, every, limit
        self.calls, self.n = [], 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self._call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def _call(self, *args, **kwargs):
        out = self.orig(*args, **kwargs)
        if self.n % self.every == 0 and (self.limit is None or len(self.calls) < self.limit):
            self.calls.append((args, kwargs, out))
        self.n += 1
        return out


def sp_partials(q, k, v, pos: int, ranks: int):
    """The float32 partials ``(m, l, o)`` of one decode query ``q (b, 1, H, D)``
    against each of ``ranks`` equal slices of the cache ``k``, ``v``, as
    :func:`repro_torch.parallel.sp_decode.sp_decode_attention_update` computes
    them on each rank (slots past ``pos`` masked)."""
    import torch

    b, _, h, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, n_kv, h // n_kv, d).float()
    parts = []
    for kr, vr, start in zip(k.chunk(ranks, dim=1), v.chunk(ranks, dim=1), range(0, k.shape[1], k.shape[1] // ranks)):
        s = torch.einsum("bkgd,bckd->bkgc", qg, kr.float()) * (1.0 / d ** 0.5)
        mask = (start + torch.arange(kr.shape[1], device=q.device)) <= pos
        s = torch.where(mask, s, -1e30)
        m = s.amax(dim=-1)
        p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
        parts.append((m, p.sum(dim=-1), torch.einsum("bkgc,bckd->bkgd", p, vr.float())))
    return parts


def merge_partials(parts, shape, dtype, fault=None):
    """The flash-decoding merge of ``parts`` (:func:`sp_partials`), or a broken
    one: ``alpha_left_out`` adds the partials unscaled, ``rank0_dropped``
    merges all but rank 0's."""
    import torch

    if fault == "rank0_dropped":
        parts = parts[1:]
    m = torch.stack([p[0] for p in parts]).amax(dim=0)
    alphas = [torch.ones_like(m) if fault == "alpha_left_out" else torch.exp(p[0] - m) for p in parts]
    o = sum(p[2] * a[..., None] for p, a in zip(parts, alphas))
    l_sum = sum(p[1] * a for p, a in zip(parts, alphas))
    return (o / torch.clamp_min(l_sum, 1e-37)[..., None]).reshape(shape).to(dtype)


def sp_merge_check(calls, k, v, ranks: int, device="cuda") -> dict:
    """Layer 0's merged decode attention at each step (``calls``: ``(q, pos,
    out)``) against the port's plain decode attention over the whole cache
    ``k``, ``v``, and the two broken merges of :data:`SP_FAULTS` against the
    same: each must miss the bound that the ranks' merge meets."""
    import torch

    from repro_torch.kernels.flash_attention.ref import decode_attention

    k, v = k.to(device), v.to(device)
    errs, scale = dict.fromkeys(("sp", *SP_FAULTS), 0.0), 0.0
    for q, pos, out in calls:
        q = q.to(device)
        want = decode_attention(q, k, v, pos + 1).float()
        scale = max(scale, float(want.abs().max()))
        parts = sp_partials(q, k, v, pos, ranks)
        got = {"sp": out.to(device), **{f: merge_partials(parts, q.shape, q.dtype, f) for f in SP_FAULTS}}
        for name, x in got.items():
            if not bool(torch.isfinite(x.float()).all()):
                raise AssertionError(f"SP merge {name}: non-finite values")
            errs[name] = max(errs[name], float((x.float() - want).abs().max()))
    bound = SP_MERGE_TOL * scale
    if not errs["sp"] <= bound:
        raise AssertionError(f"SP decode: layer 0's merged attention {errs['sp']} from the plain one (bound {bound})")
    for f in SP_FAULTS:
        if not errs[f] > bound:
            raise AssertionError(f"SP decode: the broken merge {f} ({errs[f]}) stays within the bound {bound}")
    return {"max_abs_err": errs["sp"], "bound": bound, "scale": scale, "steps": len(calls),
            "broken_merges": {f: errs[f] for f in SP_FAULTS}}


def hold_flash_prefill(call, what="SP prefill flash attention") -> float:
    """One layer's prefill flash attention (a recorded call) against the plain
    ``naive_attention`` on the same q / k / v, ``SP_CHUNK`` queries at a time."""
    from repro_torch.kernels.flash_attention.ref import naive_attention

    (q, k, v), kw, out = call
    if kw.get("q_offset", 0):
        raise AssertionError(f"{what}: a prefill's flash attention starts at position 0")
    err = 0.0
    for i in range(0, q.shape[1], SP_CHUNK):
        want = naive_attention(q[:, i:i + SP_CHUNK], k, v, causal=kw.get("causal", True), window=kw.get("window", 0),
                               q_offset=i)
        err = max(err, check_close(out[:, i:i + SP_CHUNK], want, ATTN_TOL["bfloat16"],
                                   f"{what}, queries {i}..{i + SP_CHUNK}"))
    return err


def tree_at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def same_bits(a, b) -> bool:
    """Equal bit for bit (-0.0 differs from 0.0; NaNs compare by their bits)."""
    import torch

    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.view(view[a.dtype]), b.view(view[b.dtype]))


def ef_violation(sent, g, r_old, r_new) -> float:
    """Largest breach of the error-feedback invariant sent + r_new == g + r_old,
    as a multiple of its bound (one ulp of sent's dtype, plus float32 rounding of
    the two sums): <= 1 holds."""
    import torch

    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10, torch.float32: 2.0 ** -23}[sent.dtype]
    lhs = sent.float() + r_new
    rhs = g.float() + r_old
    bound = ulp * sent.float().abs() + 2.0 ** -22 * (lhs.abs() + rhs.abs()) + 1e-30
    return float(((lhs - rhs).abs() / bound).max())


def compression_phase(device) -> dict:
    """Error-feedback int8 compression of a glm4-9b gradient tree on the card."""
    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.models import transformer as T
    from repro_torch.optim import compress as C

    shape_tree = T.abstract_params(train_cfg())
    shapes, treedef = tree_lib.flatten(shape_tree)
    gen = torch.Generator(device=device).manual_seed(11)
    n_elements = sum(x.numel() for x in shapes)

    def grads(step):
        out = []
        for x in shapes:
            g = torch.randn(x.shape, generator=gen, device=device, dtype=torch.float32).mul_(1 + step)
            out.append(g.to(x.dtype))
        return treedef.unflatten(out)

    def zeros(tree, dev):
        leaves, tdef = tree_lib.flatten(tree)
        return tdef.unflatten([torch.zeros(x.shape, dtype=torch.float32, device=dev) for x in leaves])

    sample = {"/".join(map(str, p)): p for p in COMPRESS_SAMPLE}
    state = C.CompressionState(residual=zeros(shape_tree, device))
    cpu_state = C.CompressionState(residual=zeros({k: tree_at(shape_tree, p) for k, p in sample.items()}, "cpu"))
    worst, checked = 0.0, 0
    for step in range(COMPRESS_STEPS):
        g = grads(step)
        r_old = state.residual
        sent, state = C.compressed_grad_transform(g, state)
        torch.cuda.synchronize()
        for gl, rl, sl, nl in zip(*(tree_lib.leaves(t) for t in (g, r_old, sent, state.residual))):
            worst = max(worst, ef_violation(sl, gl, rl, nl))
        cpu_g = {k: tree_at(g, p).cpu() for k, p in sample.items()}
        cpu_sent, cpu_state = C.compressed_grad_transform(cpu_g, cpu_state)
        for k, p in sample.items():
            for what, card_t, cpu_t in (("sent", tree_at(sent, p), cpu_sent[k]),
                                        ("residual", tree_at(state.residual, p), cpu_state.residual[k])):
                if not same_bits(card_t.cpu(), cpu_t):
                    raise AssertionError(f"compression step {step} {k} {what}: the card differs from the CPU")
                checked += 1
        del g, r_old, sent
    if worst > 1.0:
        raise AssertionError(f"compression: the error-feedback invariant is off by {worst} x its bound")
    g = grads(COMPRESS_STEPS)
    ms = time_ms(lambda: C.compressed_grad_transform(g, state), reps=3)
    print(f"compression {TRAIN_ARCH} ({TRAIN_LAYERS} layers, {len(shapes)} leaves, {n_elements} elements): "
          f"card == CPU bit for bit on {len(sample)} leaves x {COMPRESS_STEPS} steps (sent and residual); "
          f"error-feedback invariant over {COMPRESS_STEPS} steps at {worst:.3f} of its bound; {ms:.3f} ms a call",
          flush=True)
    del g, state
    torch.cuda.empty_cache()
    return {"leaves": len(shapes), "elements": n_elements, "steps": COMPRESS_STEPS, "leaves_vs_cpu": len(sample),
            "tensors_vs_cpu": checked, "invariant_worst_of_bound": worst, "ms": ms}


def sp_cfg():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(SP_ARCH), n_layers=SP_LAYERS)


def sp_tokens(device):
    import torch

    gen = torch.Generator(device=device).manual_seed(5)
    return torch.randint(0, sp_cfg().vocab_size, (SP_BATCH, SP_PROMPT + SP_STEPS), generator=gen, device=device)


def sp_decode_run(tokens, mesh=None) -> dict:
    """Prefill ``SP_PROMPT`` tokens into a cache of ``SP_CACHE`` slots, then
    ``SP_STEPS`` decode steps fed the following tokens; on a mesh, with
    ``kv_seq`` on ``model``.  The logits of every step (host, float32), layer
    0's cache (host), the prefill's flash-attention launches and the times.
    In one process, also layer 0's prefill flash attention held against the
    plain version; on a mesh, layer 0's query, position and merged attention
    at each step (``layer0``)."""
    import contextlib

    import torch

    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.models import transformer as T
    from repro_torch.parallel import sharding as S
    from repro_torch.parallel import sp_decode

    cfg = sp_cfg()
    params = T.init_params(cfg, seed=0, device=tokens.device)
    ctx = contextlib.ExitStack()
    if mesh is not None:
        ctx.enter_context(S.use_compat_mesh(mesh))
        ctx.enter_context(S.axis_rules({**S.DEFAULT_RULES, "kv_seq": "model"}))
    with ctx:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash.launches = 0
        with Recorder(attn_ops, "flash_attention", limit=1 if mesh is None else 0) as prefill_calls:
            t0 = time.perf_counter()
            _, cache = T.prefill(cfg, params, {"tokens": tokens[:, :SP_PROMPT]}, SP_CACHE)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        launches = flash.launches
        logits, step_ms = [], []
        with Recorder(sp_decode, "sp_decode_attention_update", every=SP_LAYERS) as merges:
            for i in range(SP_PROMPT, SP_PROMPT + SP_STEPS):
                t0 = time.perf_counter()
                out, cache = T.decode_step(cfg, params, tokens[:, i:i + 1], cache)
                torch.cuda.synchronize()
                step_ms.append(1e3 * (time.perf_counter() - t0))
                logits.append(out.float().cpu())
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        run = {"logits": torch.cat(logits, dim=1), "flash_launches": launches, "prefill_s": prefill_s,
               "ms_per_step": statistics.median(step_ms), "cache_slots": cache["layers"][0]["k"].shape[1],
               "peak_memory_gb": peak_gb, "k0": cache["layers"][0]["k"].cpu(), "v0": cache["layers"][0]["v"].cpu()}
        if mesh is None:
            run["prefill_flash_err"] = hold_flash_prefill(prefill_calls.calls[0])
        else:
            run["layer0"] = [(a[0].cpu(), a[5], o[0].cpu()) for a, _, o in merges.calls]
    return run


def sp_rank(rank, tokens_path) -> dict:
    """One rank of the SP decode: its own copy of the model (the same seed),
    then gloo's ``all_reduce`` timed at the merge's two sizes."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel import sharding as S

    mesh = S.make_compat_mesh((1, PARALLEL_RANKS), ("data", "model"), device_type="cuda")
    tokens = torch.load(tokens_path).cuda()
    out = sp_decode_run(tokens, mesh)
    cfg = sp_cfg()
    group = mesh.get_group("model")
    m = torch.zeros((SP_BATCH, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads), device="cuda")
    lo = torch.zeros((*m.shape, cfg.d_head + 1), device="cuda")
    out["all_reduce_ms"] = {
        "max_m": time_ms(lambda: dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group), reps=20),
        "sum_o_l": time_ms(lambda: dist.all_reduce(lo, group=group), reps=20),
    }
    out["all_reduce_bytes"] = {"max_m": m.numel() * 4, "sum_o_l": lo.numel() * 4}
    return out


def ep_rank(rank, params, x) -> dict:
    """One rank of the EP MoE: the whole layer's weights from the parent (CUDA
    IPC), of which ``apply_moe_ep`` takes this rank's 32 experts; then gloo's
    ``all_reduce`` timed at the output's size (summed in float32)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.models import moe_ep as MEP
    from repro_torch.parallel import sharding as S

    cfg = get_config(EP_ARCH)
    mesh = S.make_compat_mesh((1, PARALLEL_RANKS), ("data", "model"), device_type="cuda")
    with S.use_compat_mesh(mesh):
        y, aux = MEP.apply_moe_ep(cfg, params, "moe", x)
        ms = time_ms(lambda: MEP.apply_moe_ep(cfg, params, "moe", x), reps=EP_REPS)
    buf = torch.zeros(y.shape, device="cuda")
    all_reduce_ms = time_ms(lambda: dist.all_reduce(buf, group=mesh.get_group("model")), reps=EP_REPS)
    return {"y": y.cpu(), "load_balance_loss": float(aux["load_balance_loss"]),
            "drop_frac": float(aux["drop_frac"]), "ms": ms, "all_reduce_ms": all_reduce_ms,
            "all_reduce_bytes": buf.numel() * 4}


def parallel_phase(device, card) -> dict:
    """Phase 16: compression on the card, then SP decode and EP MoE as four ranks
    of a gloo group on the one card, each against the single-process path."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import moe as M
    from repro_torch.data.threefry import prng_key
    from repro_torch.models.params import ParamBuilder, model_dtype
    from repro_torch.parallel.ranks import run_ranks

    _build.load_library()  # built once, here: the ranks load it and never race an nvcc build
    torch.cuda.empty_cache()
    compression = compression_phase(device)

    # -- SP decode: the single-process decode first, its logits kept on the host --
    tokens = sp_tokens(device)
    ref = sp_decode_run(tokens)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(tokens.cpu(), Path(tmp) / "tokens.pt")
        t0 = time.perf_counter()
        ranks = run_ranks(sp_rank, PARALLEL_RANKS, str(Path(tmp) / "tokens.pt"))
        sp_wall_s = time.perf_counter() - t0
    want = ref["logits"]
    for r, out in enumerate(ranks):
        if not torch.equal(out["logits"], ranks[0]["logits"]):
            raise AssertionError(f"SP decode: rank {r}'s logits differ from rank 0's")
        if out["flash_launches"] != SP_LAYERS or out["cache_slots"] != SP_CACHE // PARALLEL_RANKS:
            raise AssertionError(f"SP decode rank {r}: {out['flash_launches']} flash launches, "
                                 f"{out['cache_slots']} cache slots")
        if len(out["layer0"]) != SP_STEPS or any(not torch.equal(o, a[2]) for (*_, o), a in
                                                  zip(out["layer0"], ranks[0]["layer0"])):
            raise AssertionError(f"SP decode rank {r}: layer 0's merged attention differs from rank 0's")
    for name in ("k0", "v0"):  # the ranks' slices side by side are the single-process cache
        if not same_bits(torch.cat([o[name] for o in ranks], dim=1), ref[name]):
            raise AssertionError(f"SP decode: the ranks' layer-0 {name[0]} cache slices differ from the whole cache")
    merge = sp_merge_check(ranks[0]["layer0"], ref["k0"], ref["v0"], PARALLEL_RANKS)
    got = ranks[0]["logits"]
    sp_err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or sp_err > LOGITS_TOL * (1 + float(want.abs().max())):
        raise AssertionError(f"SP decode: logits {sp_err} from the single-process decode")
    sp = {"logits_max_abs_err": sp_err, "logits_tol": LOGITS_TOL * (1 + float(want.abs().max())),
          "merge": merge, "prefill_flash_max_abs_err": ref["prefill_flash_err"],
          "prefill_flash_shape": [SP_BATCH, SP_PROMPT, sp_cfg().n_heads, sp_cfg().d_head],
          "ms_per_step": max(o["ms_per_step"] for o in ranks), "single_process_ms_per_step": ref["ms_per_step"],
          "prefill_s": max(o["prefill_s"] for o in ranks), "single_process_prefill_s": ref["prefill_s"],
          "flash_launches": sum(o["flash_launches"] for o in ranks), "wall_s": sp_wall_s,
          "all_reduce_ms": {k: max(o["all_reduce_ms"][k] for o in ranks) for k in ranks[0]["all_reduce_ms"]},
          "all_reduce_bytes": ranks[0]["all_reduce_bytes"],
          "rank_peak_memory_gb": max(o["peak_memory_gb"] for o in ranks),
          "single_process_peak_memory_gb": ref["peak_memory_gb"]}
    print(f"SP decode {SP_ARCH} ({SP_LAYERS} layers, prompt {SP_PROMPT}, cache {SP_CACHE}, {PARALLEL_RANKS} ranks "
          f"x {SP_CACHE // PARALLEL_RANKS} slots): ranks agree bit for bit, their cache slices are the whole "
          f"cache, layer 0's merge within {merge['max_abs_err']:.4g} of the plain attention (bound "
          f"{merge['bound']:.4g}; broken merges {merge['broken_merges']}), prefill flash attention within "
          f"{ref['prefill_flash_err']:.4g} of naive_attention, logits within {sp_err:.4g} of the single-process "
          f"decode; {sp['ms_per_step']:.2f} ms a step against {ref['ms_per_step']:.2f}", flush=True)
    del tokens, ranks, ref

    # -- EP MoE: the single-process layer first, its output kept on the host ------
    cfg = get_config(EP_ARCH)
    b = ParamBuilder(prng_key(3), device, model_dtype(cfg))
    M.init_moe(b, "moe", cfg)
    params = b.params
    gen = torch.Generator(device=device).manual_seed(4)
    x = torch.randn((EP_BATCH, EP_TOKENS, cfg.d_model), generator=gen, device=device).to(model_dtype(cfg))
    y_dense, aux_dense = M.apply_moe(cfg, params, "moe", x)
    dense_ms = time_ms(lambda: M.apply_moe(cfg, params, "moe", x), reps=EP_REPS)
    y_dense, lb_dense, drop_dense = y_dense.cpu(), float(aux_dense["load_balance_loss"]), float(aux_dense["drop_frac"])
    del aux_dense
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(ep_rank, PARALLEL_RANKS, params, x)
    ep_wall_s = time.perf_counter() - t0
    assignments = EP_BATCH * EP_TOKENS * cfg.top_k
    for r, out in enumerate(ranks):
        if not torch.equal(out["y"], ranks[0]["y"]):
            raise AssertionError(f"EP MoE: rank {r}'s output differs from rank 0's")
        if round(out["drop_frac"] * assignments) != round(drop_dense * assignments):
            raise AssertionError(f"EP MoE rank {r}: drop_frac {out['drop_frac']} against {drop_dense}")
        if abs(out["load_balance_loss"] - lb_dense) > EP_LB_RTOL * abs(lb_dense):
            raise AssertionError(f"EP MoE rank {r}: load_balance_loss {out['load_balance_loss']} against {lb_dense}")
    y = ranks[0]["y"]
    ep_err = float((y.float() - y_dense.float()).abs().max())
    ep_ulps = bf16_ulps(y, y_dense)
    if not bool(torch.isfinite(y.float()).all()) or not ep_ulps <= EP_ULPS:
        raise AssertionError(f"EP MoE: output {ep_ulps} bf16 ulp ({ep_err}) from the single-process apply_moe")
    ep = {"max_abs_err": ep_err, "max_bf16_ulps": ep_ulps, "same_bits": bool(torch.equal(y, y_dense)),
          "drop_frac": ranks[0]["drop_frac"], "single_process_drop_frac": drop_dense,
          "dropped": round(drop_dense * assignments), "assignments": assignments,
          "load_balance_loss": ranks[0]["load_balance_loss"], "single_process_load_balance_loss": lb_dense,
          "ms": max(o["ms"] for o in ranks), "single_process_ms": dense_ms, "wall_s": ep_wall_s,
          "all_reduce_ms": max(o["all_reduce_ms"] for o in ranks), "all_reduce_bytes": ranks[0]["all_reduce_bytes"],
          "experts_per_rank": cfg.n_experts // PARALLEL_RANKS}
    print(f"EP MoE {EP_ARCH} ({cfg.n_experts} experts, {ep['experts_per_rank']} a rank, {EP_BATCH} x {EP_TOKENS} "
          f"tokens): ranks agree bit for bit, y within {ep_ulps:g} bf16 ulp of apply_moe, dropped "
          f"{ep['dropped']} of {assignments} on both; {ep['ms']:.2f} ms a call against {dense_ms:.2f}", flush=True)
    del params, x, b, ranks
    gc.collect()
    torch.cuda.ipc_collect()  # the layer the ranks held by IPC
    torch.cuda.empty_cache()
    out = {"card": card, "ranks": PARALLEL_RANKS, "backend": "gloo", "compression": compression, "sp_decode": sp,
           "ep_moe": ep, "cuts": parallel_cuts(), "tolerances": parallel_tolerances()}
    print(json.dumps({"parallel": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# The mesh phase: placed training on four ranks of the one card (gloo)
# ---------------------------------------------------------------------------

#: Placed execution (DTensors by the logical-axes rules) on a 2 x 2 data x model mesh of
#: four gloo ranks on the one card.  (a) glm4-9b at its published widths with phase 14's
#: 4 of 40 layers, batch 2 x 2048 (half of phase 14's sequence: four ranks share the
#: 80 GB), one warm-up and one timed step; (b) one loss_fn and its gradient of
#: falcon-mamba-7b (2 of 64 layers) and recurrentgemma-9b (3 of 38) at published widths,
#: batch 2 x 512; (c) examples/elastic_restart.py's two launches at (a)'s widths and
#: depth, int8 checkpoint, 2 steps each: 2 ranks on (2,), then 4 on (2, 2), so that
#: launch 2's second step runs on the restored AdamW moments.  AdamW keeps its moments
#: in bfloat16 here (phase 14: float32): each rank holds the embeddings whole over the
#: data axis, and with float32 moments four ranks' states and their updates would not
#: fit the card.  The phase's time is cut by the scans' sequence (1024 -> 512); the rest
#: is the ranks' start, the checkpoint's gather and write, and its restore in four ranks.
MESH_SHAPE, MESH_AXES = (2, 2), ("data", "model")
MESH_BATCH, MESH_SEQ, MESH_STEPS, MESH_MOMENTS = 2, 2048, 2, "bfloat16"
MESH_SCAN_MODELS = (("falcon-mamba-7b", 2, {"ssm_scan": 2}), ("recurrentgemma-9b", 3,
                                                                 {"rglru_scan": 2, "flash_attention": 1}))
MESH_SCAN_BATCH, MESH_SCAN_SEQ = 2, 512
ELASTIC_STEPS, ELASTIC_CODEC = 2, "int8"
#: The keys of the phase's ``{"mesh": ...}`` line.
MESH_LINE_KEYS = ("card", "ranks", "mesh", "backend", "parent_gb_at_start", "train", "scans", "elastic", "launches", "phase_s", "cuts",
                  "tolerances")


def mesh_cuts() -> dict:
    from repro_torch.launch import elastic_restart as E

    return {
        "train": {"model": TRAIN_ARCH, "layers": TRAIN_LAYERS, "of_layers": 40, "batch": MESH_BATCH,
                  "seq": MESH_SEQ, "steps": MESH_STEPS, "moment_dtype": MESH_MOMENTS,
                  "why": "four ranks share the card's 80 GB: half of phase 14's sequence, bf16 moments"},
        "scans": {arch: {"layers": layers, "batch": MESH_SCAN_BATCH, "seq": MESH_SCAN_SEQ}
                  for arch, layers, _ in MESH_SCAN_MODELS},
        "elastic": {"model": E.ARCH, "layers": TRAIN_LAYERS, "batch": MESH_BATCH, "seq": MESH_SEQ,
                    "steps_each": ELASTIC_STEPS, "codec": ELASTIC_CODEC, "first_mesh": list(E.FIRST_MESH),
                    "second_mesh": list(MESH_SHAPE)},
    }


def mesh_tolerances() -> dict:
    return {"loss_and_grad_norm": TRAIN_LOSS_TOL, "restored_shards": "bit for bit (a 64-bit weighted sum of "
            "each shard's 16-bit words against the single process's slice)"}


def mesh_opt():
    from repro_torch.optim import AdamWConfig

    return AdamWConfig(lr=1e-4, moment_dtype=MESH_MOMENTS)


def mesh_batches(cfg, device, n):
    from repro_torch.data import TokenStream

    data = TokenStream(vocab_size=cfg.vocab_size, batch=MESH_BATCH, seq_len=MESH_SEQ, seed=11, device=device)
    return [next(data) for _ in range(n)]


def held(got, want, tol) -> bool:
    return abs(got - want) <= tol + tol * abs(want)


def mesh_train_single(device) -> dict:
    """(a)'s steps in one process on the card: the losses, grad norms and times."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.train.steps import make_train_step

    cfg = train_cfg()
    params = T.init_params(cfg, seed=0, device=device)
    opt_state = adamw_init(params, mesh_opt())
    step = make_train_step(cfg, mesh_opt(), remat=False, q_block=1024, kv_block=1024)
    out = {"losses": [], "grad_norms": [], "step_s": []}
    torch.cuda.reset_peak_memory_stats()
    for batch in mesh_batches(cfg, device, MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        torch.cuda.synchronize()
        out["step_s"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt_state, m
    torch.cuda.empty_cache()
    return out


def time_collectives(mesh, shard, table_shard) -> dict:
    """gloo's collectives of the path at its sizes, on the data axis: the FSDP gather of a
    layer weight's shard (the all-gather built on all_reduce), the reduce-scatter of its
    gradient, and the all-reduce of an embedding's gradient (whole over data)."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol

    group = mesh.get_group("data")
    n = dist.get_world_size(group)
    whole = torch.zeros((shard.shape[0] * n, *shard.shape[1:]), dtype=shard.dtype, device=shard.device)
    grad = torch.zeros_like(table_shard)

    def gather():
        y = funcol.all_gather_tensor(shard, 0, group)
        return y.wait() if hasattr(y, "wait") else y

    def scatter():
        y = funcol.reduce_scatter_tensor(whole, "sum", 0, group)
        return y.wait() if hasattr(y, "wait") else y

    size = lambda x: x.numel() * x.element_size()  # noqa: E731
    return {
        "all_gather_on_all_reduce": {"ms": time_ms(gather, reps=3), "bytes_in": size(shard), "bytes_out": size(whole)},
        "reduce_scatter": {"ms": time_ms(scatter, reps=3), "bytes_in": size(whole), "bytes_out": size(shard)},
        "all_reduce": {"ms": time_ms(lambda: dist.all_reduce(grad, group=group), reps=3), "bytes": size(grad)},
    }


def mesh_rank(rank) -> dict:
    """(a), then (b), in one rank."""
    out = {"train": mesh_train_rank(rank), "scans": {}}
    for arch, layers, _ in MESH_SCAN_MODELS:
        out["scans"][arch] = mesh_scan_rank(rank, arch, layers)
    return out


def mesh_train_rank(rank) -> dict:
    """(a) in one rank: glm4-9b placed on the 2 x 2 mesh, a warm-up and a timed step."""
    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import gloo_cuda
    from repro_torch.parallel import sharding as S
    from repro_torch.train.steps import make_train_step

    mesh = S.make_compat_mesh(MESH_SHAPE, MESH_AXES, device_type="cuda")
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = train_cfg()
    out = {"losses": [], "grad_norms": [], "step_s": [], "launches": [], "gathers": []}
    with S.use_compat_mesh(mesh):
        params = T.init_params(cfg, seed=0, device=device)  # every rank the same whole init; each keeps its shards
        params = S.place(params, mesh, S.shard_params(mesh, T.param_axes(cfg), abstract_tree=params))
        opt_state = adamw_init(params, mesh_opt())  # the moments placed as their parameters
        torch.cuda.empty_cache()
        split = [x for x in tree_lib.leaves(params) if sum(p.is_shard() for p in x.placements) == 2]
        quarter = all(x.to_local().numel() * 4 == x.numel() for x in split)
        step = make_train_step(cfg, mesh_opt(), remat=False, q_block=1024, kv_block=1024)
        torch.cuda.reset_peak_memory_stats()
        for batch in mesh_batches(cfg, device, MESH_STEPS):
            batch = T.place_batch(mesh, batch)
            torch.cuda.synchronize()
            reset_launches()
            gloo_cuda.STATS.calls = gloo_cuda.STATS.bytes = 0
            t0 = time.perf_counter()
            params, opt_state, m = step(params, opt_state, batch)  # the main path
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["launches"].append(read_launches())
            out["gathers"].append({"calls": gloo_cuda.STATS.calls, "bytes": gloo_cuda.STATS.bytes})
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        out["split_leaves"], out["split_leaves_hold_a_quarter"] = len(split), quarter
        w = params["layers"][0]["mlp.wi_up"]  # the biggest layer weight, (fsdp, mlp)
        out["collectives"] = time_collectives(mesh, w.to_local(), params["embed.tokens"].to_local())
        out["collective_shapes"] = {"layer_weight_shard": list(w.to_local().shape),
                                    "embedding_shard": list(params["embed.tokens"].to_local().shape)}
    del params, opt_state, m, batch
    torch.cuda.empty_cache()
    return out


def mesh_scan_rank(rank, arch, layers) -> dict:
    """(b) in one rank: one placed loss_fn and its gradient; the loss, the gradient's
    global norm and the kernels' launches."""
    import dataclasses

    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import global_norm
    from repro_torch.parallel import sharding as S
    from repro_torch.train.steps import as_placed_like

    mesh = S.make_compat_mesh(MESH_SHAPE, MESH_AXES, device_type="cuda")
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    tokens = mesh_scan_tokens(cfg, device)
    with S.use_compat_mesh(mesh):
        params = T.init_params(cfg, seed=0, device=device)
        params = S.place(params, mesh, S.shard_params(mesh, T.param_axes(cfg), abstract_tree=params))
        batch = T.place_batch(mesh, tokens)
        leaves, treedef = tree_lib.flatten(params)
        wrt = [x.detach().requires_grad_(True) for x in leaves]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        loss, _ = T.loss_fn(cfg, treedef.unflatten(wrt), batch, remat=False)  # the main path
        grads = [as_placed_like(g, x) for x, g in zip(wrt, torch.autograd.grad(loss, wrt))]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        out = {"loss": float(loss.detach().to_local()), "grad_norm": float(global_norm(grads)), "launches": launches,
               "s": seconds, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, wrt, grads, loss, leaves
    torch.cuda.empty_cache()
    return out


def mesh_scan_tokens(cfg, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(13)
    t = torch.randint(0, cfg.vocab_size, (MESH_SCAN_BATCH, MESH_SCAN_SEQ + 1), generator=gen, device=device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def mesh_scan_single(arch, layers, device) -> dict:
    import dataclasses

    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import global_norm

    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    params = T.init_params(cfg, seed=0, device=device)
    leaves, treedef = tree_lib.flatten(params)
    wrt = [x.detach().requires_grad_(True) for x in leaves]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = T.loss_fn(cfg, treedef.unflatten(wrt), mesh_scan_tokens(cfg, device), remat=False)
    grads = torch.autograd.grad(loss, wrt)
    torch.cuda.synchronize()
    out = {"loss": float(loss.detach()), "grad_norm": float(global_norm(grads)), "s": time.perf_counter() - t0}
    del params, wrt, grads, loss
    torch.cuda.empty_cache()
    return out


def elastic_run(ckpt_dir):
    from repro_torch.launch.elastic_restart import ElasticRun

    return ElasticRun(ckpt_dir=ckpt_dir, preset="full", layers=TRAIN_LAYERS, batch=MESH_BATCH, seq=MESH_SEQ,
                      steps=ELASTIC_STEPS, lr=1e-4, moment_dtype=MESH_MOMENTS, codec=ELASTIC_CODEC, block=1024,
                      second_mesh=MESH_SHAPE, device="cuda")


def elastic_first_rank(rank, run) -> dict:
    """Launch 1 of (c), its kernels' launches counted in the rank."""
    from repro_torch.launch import elastic_restart as E

    reset_launches()
    out = E.first_launch(rank, run)  # the main path
    out["launches"] = read_launches()
    return out


def elastic_second_rank(rank, run) -> dict:
    from repro_torch.launch import elastic_restart as E

    reset_launches()
    out = E.second_launch(rank, run)  # the main path
    out["launches"] = read_launches()
    return out


def elastic_single(run, device) -> dict:
    """One process on the card restores launch 1's checkpoint and takes launch 2's
    steps; returns the losses and the restored leaves' slices' digests checked against
    the ranks' (by the caller)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.launch import elastic_restart as E
    from repro_torch.train.steps import make_train_step

    meta = E.abstract_state(run)
    leaves, treedef = tree_lib.flatten(meta)
    template = treedef.unflatten([torch.empty(x.shape, dtype=x.dtype, device=device) for x in leaves])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (params, opt_state), extra = CheckpointManager(run.ckpt_dir, keep=1, codec_name=run.codec).restore(
        template, step=run.steps)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del template
    restored = tree_lib.leaves((params, opt_state))
    data = run.stream(device)
    data.load_state_dict(extra["data"])
    step = make_train_step(run.config(), run.opt_config(), remat=False, q_block=run.block, kv_block=run.block)
    return {"restored": restored, "params": params, "opt_state": opt_state, "data": data, "step": step,
            "restore_s": restore_s}


def mesh_phase(device, card) -> dict:
    """Phase 17: placed training on four ranks of the one card."""
    import os

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import elastic_restart as E
    from repro_torch.parallel.ranks import run_ranks

    _build.load_library()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")  # the ranks share the card
    gc.collect()
    torch.cuda.ipc_collect()  # blocks phase 16 shared with its ranks by IPC
    torch.cuda.empty_cache()
    parent_gb = {"allocated": torch.cuda.memory_allocated() / 1e9, "reserved": torch.cuda.memory_reserved() / 1e9}
    print(f"mesh: the parent holds {parent_gb['allocated']:.2f} GB of the card ({parent_gb['reserved']:.2f} GB "
          f"reserved) as the phase starts", flush=True)
    t_phase = time.perf_counter()
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # (a) and (b): one process first, its numbers kept on the host; then one spawn of four ranks
    torch.cuda.empty_cache()
    single = mesh_train_single(device)
    singles = {arch: mesh_scan_single(arch, layers, device) for arch, layers, _ in MESH_SCAN_MODELS}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    both = run_ranks(mesh_rank, math.prod(MESH_SHAPE))
    train_wall = time.perf_counter() - t0
    ranks = [o["train"] for o in both]
    tol = TRAIN_LOSS_TOL["dense"]
    for r, out in enumerate(ranks):
        if out["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"mesh train: rank {r}'s losses {out['losses']} differ from rank 0's")
        for i in range(MESH_STEPS):
            for key in ("losses", "grad_norms"):
                if not held(out[key][i], single[key][i], tol):
                    raise AssertionError(f"mesh train step {i}: {key} {out[key][i]} vs one process {single[key][i]}")
            if out["launches"][i]["flash_attention"] != TRAIN_LAYERS:
                raise AssertionError(f"mesh train rank {r} step {i}: launches {out['launches'][i]}")
        if not out["split_leaves"] or not out["split_leaves_hold_a_quarter"]:
            raise AssertionError(f"mesh train rank {r}: a leaf split both ways holds more than a quarter")
        add(out["launches"][-1])
    train = {"losses": ranks[0]["losses"], "grad_norms": ranks[0]["grad_norms"],
             "single_process": {k: single[k] for k in ("losses", "grad_norms", "step_s", "peak_memory_gb")},
             "step_s": [max(o["step_s"][i] for o in ranks) for i in range(MESH_STEPS)],
             "rank_peak_memory_gb": max(o["peak_memory_gb"] for o in ranks), "spawn_wall_s": train_wall,
             "flash_launches_per_rank_per_step": TRAIN_LAYERS,
             "split_leaves": ranks[0]["split_leaves"], "all_gathers_a_step": ranks[0]["gathers"][-1],
             "collectives": {k: {kk: max(o["collectives"][k][kk] for o in ranks) if kk == "ms" else v[kk]
                                 for kk in v} for k, v in ranks[0]["collectives"].items()},
             "collective_shapes": ranks[0]["collective_shapes"]}
    print(f"mesh train {TRAIN_ARCH} ({TRAIN_LAYERS} layers, {MESH_BATCH} x {MESH_SEQ}, {MESH_SHAPE} data x model, "
          f"4 ranks): losses {train['losses']} vs one process {single['losses']}, grad norms within {tol}; "
          f"step {train['step_s'][-1]:.2f} s against {single['step_s'][-1]:.3f} s; flash {TRAIN_LAYERS} a rank a "
          f"step; {train['split_leaves']} leaves split both ways hold a quarter a rank", flush=True)

    scans = {}
    for arch, layers, want in MESH_SCAN_MODELS:
        one, family = singles[arch], "ssm" if arch == "falcon-mamba-7b" else "hybrid"
        outs = [o["scans"][arch] for o in both]
        for r, out in enumerate(outs):
            if not (held(out["loss"], one["loss"], TRAIN_LOSS_TOL[family])
                    and held(out["grad_norm"], one["grad_norm"], TRAIN_LOSS_TOL[family])):
                raise AssertionError(f"mesh {arch} rank {r}: loss {out['loss']} / norm {out['grad_norm']} vs one "
                                     f"process {one['loss']} / {one['grad_norm']}")
            got = {k: v for k, v in out["launches"].items() if v}
            if got != want:
                raise AssertionError(f"mesh {arch} rank {r}: launches {got}, expected {want} a rank")
            add(out["launches"])
        scans[arch] = {"loss": outs[0]["loss"], "grad_norm": outs[0]["grad_norm"], "single_process": one,
                       "s": max(o["s"] for o in outs), "launches_per_rank": want,
                       "rank_peak_memory_gb": max(o["peak_memory_gb"] for o in outs)}
        print(f"mesh {arch} ({layers} layers, {MESH_SCAN_BATCH} x {MESH_SCAN_SEQ}): loss {outs[0]['loss']:.4f} vs "
              f"one process {one['loss']:.4f}, launches {want} a rank", flush=True)
    del both, ranks
    torch.cuda.empty_cache()

    # (c) the elastic restore
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build, prefix="chip_smoke_elastic_") as ckpt_dir:
        run = elastic_run(ckpt_dir)
        t0 = time.perf_counter()
        first = run_ranks(elastic_first_rank, math.prod(E.FIRST_MESH), run)
        second = run_ranks(elastic_second_rank, math.prod(run.second_mesh), run)
        elastic_wall = time.perf_counter() - t0
        single = elastic_single(run, device)
        for r, out in enumerate(second):
            for i, (got, want) in enumerate(zip(out["digests"], single["restored"])):
                if E.slice_digest(want, got["offset"], got["shape"]) != got["digest"]:
                    raise AssertionError(f"elastic: rank {r}'s restored shard of leaf {i} differs from the "
                                         f"single process's slice {got['offset']} + {got['shape']}")
        del single["restored"]
        params, opt_state, data, step = single["params"], single["opt_state"], single["data"], single["step"]
        losses = []
        for _ in range(run.steps):
            params, opt_state, m = step(params, opt_state, next(data))
            losses.append(float(m["loss"]))
        del params, opt_state, m, single["params"], single["opt_state"]
        torch.cuda.empty_cache()
        for r, out in enumerate(second):
            if out["losses"] != second[0]["losses"] or not all(held(g, w, tol) for g, w in zip(out["losses"], losses)):
                raise AssertionError(f"elastic launch 2 rank {r}: losses {out['losses']} vs one process {losses}")
        for out in (*first, *second):
            add(out["launches"])
        if first[0]["launches"]["ckpt_codec"] < 1 or any(o["launches"]["ckpt_codec"] for o in first[1:]):
            raise AssertionError(f"elastic: rank 0 alone quantizes: {[o['launches'] for o in first]}")
        written = sum(f.stat().st_size for f in Path(ckpt_dir).rglob("*") if f.is_file())
    elastic = {"first_losses": first[0]["losses"], "second_losses": second[0]["losses"],
               "single_process_second_losses": losses, "checkpoint_bytes": written,
               "save_s": first[0]["save_s"], "restore_s": max(o["restore_s"] for o in second),
               "single_process_restore_s": single["restore_s"],
               "first_step_s": [max(o["step_s"][i] for o in first) for i in range(run.steps)],
               "second_step_s": [max(o["step_s"][i] for o in second) for i in range(run.steps)],
               "rank_peak_memory_gb": {"first": max(o["peak_memory_gb"] for o in first),
                                       "second": max(o["peak_memory_gb"] for o in second)},
               "restored_placements": second[0]["restored_placements"], "wall_s": elastic_wall,
               "leaves_checked": len(second[0]["digests"]), "ckpt_codec_launches": first[0]["launches"]["ckpt_codec"]}
    print(f"elastic {E.ARCH}: {E.FIRST_MESH} -> {run.second_mesh}, losses {elastic['first_losses']} then "
          f"{elastic['second_losses']} (one process restoring the same checkpoint: {losses}); every rank's restored "
          f"shard of {elastic['leaves_checked']} leaves equals the single process's slice; checkpoint "
          f"{written / 1e9:.2f} GB, save {elastic['save_s']:.1f} s, restore {elastic['restore_s']:.1f} s", flush=True)
    out = {"card": card, "ranks": math.prod(MESH_SHAPE), "mesh": list(MESH_SHAPE), "backend": "gloo",
           "parent_gb_at_start": parent_gb, "train": train, "scans": scans, "elastic": elastic, "launches": launches,
           "phase_s": time.perf_counter() - t_phase, "cuts": mesh_cuts(), "tolerances": mesh_tolerances()}
    assert tuple(out) == MESH_LINE_KEYS
    print(json.dumps({"mesh": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# The placed-serving phase: prefill and decode on placed parameters and caches,
# four ranks of the one card (gloo), and the dry run on the host
# ---------------------------------------------------------------------------

#: Placed serving (DTensors by the logical-axes rules; the cache placed by cache_axes).
#: Each case: (name, arch, layers served (None: all), prompt tokens, cache slots, decode
#: steps, rules over the defaults, mesh, config changes, kernel launches one prefill makes
#: in each rank).  (a) glm4-9b at its published widths with 4 of 40 layers (phase 14's
#: cut), then with kv_seq on model (the SP merge placed); (b) the two scan models at
#: phase 17's depths (recurrentgemma-9b's 2048-slot window cache wraps at the first decode
#: step); (c) arctic-480b with 1 of its 35 layers on a 1 x 4 mesh (32 experts a rank, no
#: FSDP gather of the 26.8 GB of experts: the data axis is 1), placed apply_moe and
#: moe_impl="ep"; (d) whisper-large-v3 (32 + 32 layers) and internvl2-1b (24) at full
#: depth.
PLACED_SHAPE, PLACED_AXES, PLACED_MOE_SHAPE = (2, 2), ("data", "model"), (1, 4)
PLACED_BATCH = 2
PLACED_CASES = (
    ("glm4-9b", "glm4-9b", 4, 2048, 4096, 8, {}, PLACED_SHAPE, {}, {"flash_attention": 4}),
    ("glm4-9b_sp_kv", "glm4-9b", 4, 2048, 4096, 8, {"kv_seq": "model"}, PLACED_SHAPE, {}, {"flash_attention": 4}),
    ("recurrentgemma-9b", "recurrentgemma-9b", 3, 2048, 4096, 8, {}, PLACED_SHAPE, {},
     {"rglru_scan": 2, "flash_attention": 1}),
    ("falcon-mamba-7b", "falcon-mamba-7b", 2, 2048, 4096, 8, {}, PLACED_SHAPE, {}, {"ssm_scan": 2}),
    ("arctic-480b", "arctic-480b", 1, 1024, 2048, 4, {}, PLACED_MOE_SHAPE, {}, {"flash_attention": 1}),
    ("arctic-480b_ep", "arctic-480b", 1, 1024, 2048, 4, {}, PLACED_MOE_SHAPE, {"moe_impl": "ep"},
     {"flash_attention": 1}),
    ("whisper-large-v3", "whisper-large-v3", None, 1024, 2048, 8, {}, PLACED_SHAPE, {}, {"flash_attention": 64}),
    ("internvl2-1b", "internvl2-1b", None, 1024, 2048, 8, {}, PLACED_SHAPE, {}, {"flash_attention": 24}),
)
#: (d)'s loss_fn and its gradient: (arch, sequence), batch PLACED_BATCH.
PLACED_LOSS = (("whisper-large-v3", 512), ("internvl2-1b", 512))
#: (e)'s dry-run cells: (arch, shape, mesh, variant).
PLACED_DRYRUN = (("glm4-9b", "decode_32k", "single", "baseline"), ("arctic-480b", "prefill_32k", "multi", "ep_moe"))
#: The keys of the phase's ``{"placed_serving": ...}`` line.
PLACED_LINE_KEYS = ("card", "ranks", "backend", "cases", "loss", "dryrun", "launches", "kernel_vs_plain",
                    "rank_peak_memory_gb", "parent_gb", "phase_s", "cuts", "tolerances")


def placed_cuts() -> dict:
    from repro_torch.configs import get_config

    return {name: {"model": arch, "layers": layers or get_config(arch).n_layers, "of_layers": get_config(arch).n_layers,
                   "batch": PLACED_BATCH, "prompt": prompt, "cache_slots": slots, "decode_steps": steps,
                   "mesh": list(mesh)}
            for name, arch, layers, prompt, slots, steps, _, mesh, _, _ in PLACED_CASES}


def placed_tolerances() -> dict:
    return {"logits": f"max |diff| <= {LOGITS_TOL} * (1 + max |single-process logits|)",
            "loss_and_grad_norm": TRAIN_LOSS_TOL}


def placed_cfg(arch, layers, changes):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, **changes)


def logits_err(got, want) -> tuple[float, float]:
    """(max |got - want|, max |want|) of two logits tensors (float32 on the host)."""
    return float((got.float() - want.float()).abs().max()), float(want.float().abs().max())


def placed_params(cases, with_loss, device) -> dict:
    """The parameters of ``cases`` (and of (d)'s loss), drawn once on the card, by
    ``(arch, layers)``: the single process runs on them, and the ranks take them by CUDA
    IPC (each rank's shards views of them: ``place(..., copy=False)``)."""
    from repro_torch.models import transformer as T

    keys = dict.fromkeys((arch, layers) for _, arch, layers, *_ in cases)
    keys.update(dict.fromkeys((arch, None) for arch, _ in PLACED_LOSS if with_loss))
    return {(arch, layers): T.init_params(placed_cfg(arch, layers, {}), seed=0, device=device)
            for arch, layers in keys}


def placed_single(case, params, device) -> dict:
    """One case in one process on the card: the prefill logits, the decode steps' logits
    fed the greedy tokens, the tokens (all on the host) and the times."""
    import torch

    from repro_torch.models import transformer as T
    from repro_torch.train.steps import greedy_sample

    name, arch, layers, prompt, slots, steps, _, _, changes, _ = case
    cfg = placed_cfg(arch, layers, changes)
    batch = model_batch(cfg, device, batch=PLACED_BATCH, prompt=prompt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = T.prefill(cfg, params, batch, slots)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = {"logits": [logits.float().cpu()], "tokens": [greedy_sample(logits).cpu()]}
    for _ in range(steps):
        logits, cache = T.decode_step(cfg, params, out["tokens"][-1].to(device), cache)
        out["logits"].append(logits.float().cpu())
        out["tokens"].append(greedy_sample(logits).cpu())
    torch.cuda.synchronize()
    out.update(prefill_s=t1 - t0, decode_ms=1e3 * (time.perf_counter() - t1) / steps)
    del cache, logits, batch
    torch.cuda.empty_cache()
    return out


def placed_loss_single(arch, seq, params, device) -> dict:
    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.models import transformer as T
    from repro_torch.optim import global_norm

    cfg = placed_cfg(arch, None, {})
    batch = model_batch(cfg, device, seed=5, batch=PLACED_BATCH, prompt=seq)
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    leaves, treedef = tree_lib.flatten(params)
    wrt = [x.detach().requires_grad_(True) for x in leaves]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = T.loss_fn(cfg, treedef.unflatten(wrt), batch)
    grads = torch.autograd.grad(loss, wrt)
    torch.cuda.synchronize()
    out = {"loss": float(loss.detach()), "grad_norm": float(global_norm(grads)), "s": time.perf_counter() - t0}
    del wrt, grads, loss, leaves
    torch.cuda.empty_cache()
    return out


class FirstOfEach(Recorder):
    """A :class:`Recorder` that keeps the first call of each shape and keyword set."""

    def __enter__(self):
        self.seen = set()
        return super().__enter__()

    def _call(self, *args, **kwargs):
        out = self.orig(*args, **kwargs)
        key = (tuple(tuple(a.shape) for a in args), tuple(sorted(kwargs.items())))
        if key not in self.seen:
            self.seen.add(key)
            self.calls.append((args, kwargs, out))
        return out


def hold_local_calls(name, calls) -> dict:
    """A kernel's calls on one rank's local shards (recorded by :class:`FirstOfEach` on
    its wrapper) against its plain version on the same inputs, on the card, as phase 11
    holds it: flash attention within ``ATTN_TOL`` (``SP_CHUNK`` queries at a time), the
    RG-LRU scan bit for bit, the SSM scan within ``SCAN_TOL``."""
    plain = model_kernel_modules()[name][2]
    err = 0.0
    for args, kw, out in calls:
        what = f"placed prefill {name} {[tuple(a.shape) for a in args]}"
        if name == "flash_attention":
            err = max(err, hold_flash_prefill((args, kw, out), what))
        elif name == "rglru_scan":
            err = max(err, *(check_equal(g, w, what) for g, w in zip(out, plain(*args), strict=True)))
        else:
            err = max(err, *(check_close(g, w, SCAN_TOL, what) for g, w in zip(out, plain(*args), strict=True)))
    return {"max_abs_err": err, "shapes": [[list(a.shape) for a in args] for args, _, _ in calls]}


def placed_rank(rank, tokens, params, names, with_loss) -> dict:
    """The cases ``names`` of the phase in one rank: the placed prefill and the decode
    steps fed the single process's tokens (``tokens[name]``), each kernel's first call
    of each shape in the prefill held against its plain version, then, ``with_loss``,
    (d)'s loss and gradient, on the parent's parameters (``params``, by CUDA IPC: each
    rank's shards are views of them, ``place(..., copy=False)``)."""
    import contextlib

    import torch

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.models import transformer as T
    from repro_torch.optim import global_norm
    from repro_torch.parallel import sharding as S
    from repro_torch.train.steps import as_placed_like, greedy_sample

    device = torch.device("cuda", torch.cuda.current_device())
    kernels = model_kernel_modules()
    cases = [c for c in PLACED_CASES if c[0] in names]
    meshes = {shape: S.make_compat_mesh(shape, PLACED_AXES, device_type="cuda") for shape in {c[7] for c in cases}}
    torch.cuda.reset_peak_memory_stats()
    out = {"cases": {}, "loss": {}}
    for name, arch, layers, prompt, slots, steps, rules, shape, changes, _ in cases:
        cfg = placed_cfg(arch, layers, changes)
        mesh = meshes[shape]
        whole = params[(arch, layers)]
        with S.use_compat_mesh(mesh), S.axis_rules({**S.DEFAULT_RULES, **rules}):
            placed = S.place(whole, mesh, S.shard_params(mesh, T.param_axes(cfg), abstract_tree=whole), copy=False)
            batch = model_batch(cfg, device, batch=PLACED_BATCH, prompt=prompt)
            torch.cuda.synchronize()
            reset_launches()
            with contextlib.ExitStack() as stack:
                recorded = {k: stack.enter_context(FirstOfEach(mod, k)) for k, (mod, _, _) in kernels.items()}
                t0 = time.perf_counter()
                logits, cache = T.prefill(cfg, placed, batch, slots)  # the main path
                torch.cuda.synchronize()
                t1 = time.perf_counter()
            launches = read_launches()
            got = {"logits": [logits.full_tensor().float().cpu()], "launches": launches, "prefill_s": t1 - t0}
            own = [greedy_sample(logits).cpu()]
            for tok in tokens[name][:steps]:
                logits, cache = T.decode_step(cfg, placed, tok.to(device), cache)  # the main path
                got["logits"].append(logits.full_tensor().float().cpu())
                own.append(greedy_sample(logits).cpu())
            torch.cuda.synchronize()
            if read_launches() != launches:  # decode is plain, as in the JAX package
                raise AssertionError(f"placed {name}: decode launched kernels: {read_launches()} after {launches}")
            got["decode_ms"] = 1e3 * (time.perf_counter() - t1) / steps
            got["tokens"] = own
            got["kernel_vs_plain"] = {k: hold_local_calls(k, r.calls) for k, r in recorded.items() if r.calls}
            del recorded
            first = cache["layers"][0]
            first = first.get("self", first)
            got["cache_placements"] = {k: str(tuple(v.placements)) for k, v in first.items() if S.is_placed(v)}
            out["cases"][name] = got
            del placed, cache, logits, batch
            torch.cuda.empty_cache()
    for arch, seq in PLACED_LOSS if with_loss else ():
        cfg = placed_cfg(arch, None, {})
        mesh = meshes[PLACED_SHAPE]
        whole = params[(arch, None)]
        with S.use_compat_mesh(mesh):
            placed = S.place(whole, mesh, S.shard_params(mesh, T.param_axes(cfg), abstract_tree=whole), copy=False)
            batch = model_batch(cfg, device, seed=5, batch=PLACED_BATCH, prompt=seq)
            batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
            leaves, treedef = tree_lib.flatten(placed)
            wrt = [x.detach().requires_grad_(True) for x in leaves]
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            loss, _ = T.loss_fn(cfg, treedef.unflatten(wrt), T.place_batch(mesh, batch))  # the main path
            grads = [as_placed_like(g, x) for x, g in zip(wrt, torch.autograd.grad(loss, wrt))]
            torch.cuda.synchronize()
            out["loss"][arch] = {"loss": float(loss.detach().to_local()), "grad_norm": float(global_norm(grads)),
                                 "s": time.perf_counter() - t0, "launches": read_launches()}
            del placed, wrt, grads, loss, leaves, batch
            torch.cuda.empty_cache()
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def placed_dryrun_start(tmp) -> list:
    """(e): ``python -m repro_torch.launch.dryrun`` for PLACED_DRYRUN's cells, started on
    this machine's host (no card) while the single process runs on the card."""
    import os

    env = {**os.environ, "PYTHONPATH": str(SRC)}
    return [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", cell[0], "--shape", cell[1], "--mesh", cell[2],
         "--variant", cell[3], "--out", str(tmp)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for cell in PLACED_DRYRUN]


def placed_dryrun_finish(started, tmp) -> dict:
    """Waits for the dry runs; every record must end ``ok``."""
    out = {}
    for (arch, shape, mesh, variant), proc in started:
        log, _ = proc.communicate(timeout=600)
        name = f"{arch}__{shape}__{'pod2x16x16' if mesh == 'multi' else 'pod16x16'}"
        path = Path(tmp) / (name + ("" if variant == "baseline" else f"__{variant}") + ".json")
        rec = json.loads(path.read_text()) if path.exists() else {"status": "missing", "error": log[-2000:]}
        if proc.returncode or rec["status"] != "ok":
            raise AssertionError(f"dry run {name} {variant}: exit {proc.returncode}, {rec['status']}: "
                                 f"{rec.get('error')}")
        out[f"{name}__{variant}"] = {"run_s": rec["lower_s"] + rec["compile_s"], "chips": rec["chips"],
                                     "argument_gb": rec["memory"]["argument_bytes"] / 1e9,
                                     "temp_gb": rec["memory"]["temp_bytes"] / 1e9,
                                     "flops_per_device": rec["flops_per_device"],
                                     "collectives": {k: v["count"] for k, v in rec["collectives"].items()}}
        print(f"dry run {arch} {shape} {mesh} {variant}: ok, {out[f'{name}__{variant}']}", flush=True)
    return out


def placed_serving_phase(device, card) -> dict:
    """Phase 18: prefill and decode on placed parameters and caches, four ranks of the one
    card; then the dry run on the host.  (The MoE's parameters reach the ranks by CUDA
    IPC, which this machine's kernel refuses for memory of the expandable-segments
    allocator: the parent's allocator keeps its default.)"""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.parallel.ranks import run_ranks

    _build.load_library()
    gc.collect()
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    # (e) on the host while the single process runs on the card.  Then in two groups, the
    # cases on 2 x 2 with (d)'s loss and the MoE's on 1 x 4: one process first, on the
    # parameters the ranks then take by CUDA IPC (the parent holds one group's at a time),
    # its logits and tokens kept on the host; then one spawn of four ranks
    dryrun_dir = tempfile.TemporaryDirectory(dir=ROOT / "build", prefix="chip_smoke_dryrun_")
    dryruns = placed_dryrun_start(dryrun_dir.name)
    singles, loss_singles, tokens, ranks, parent_gb, spawn_s = {}, {}, {}, None, [], []
    for group, with_loss in (([c for c in PLACED_CASES if c[7] == PLACED_SHAPE], True),
                             ([c for c in PLACED_CASES if c[7] != PLACED_SHAPE], False)):
        params = placed_params(group, with_loss, device)
        for case in group:  # moe_impl="ep" off a mesh is apply_moe: one single-process run serves both
            singles[case[0]] = (singles.get(case[0].removesuffix("_ep"))
                                or placed_single(case, params[case[1:3]], device))
            tokens[case[0]] = singles[case[0]]["tokens"]
        for arch, seq in PLACED_LOSS if with_loss else ():
            loss_singles[arch] = placed_loss_single(arch, seq, params[(arch, None)], device)
        if dryruns:
            with dryrun_dir:
                dryrun = placed_dryrun_finish(dryruns, dryrun_dir.name)
            dryruns = None
        parent_gb.append(torch.cuda.memory_allocated() / 1e9)
        print(f"placed: the parent holds {parent_gb[-1]:.2f} GB of the card: the parameters of "
              f"{[c[0] for c in group]}", flush=True)
        t0 = time.perf_counter()
        got = run_ranks(placed_rank, math.prod(PLACED_SHAPE), tokens, params, [c[0] for c in group], with_loss)
        spawn_s.append(time.perf_counter() - t0)
        del params
        gc.collect()
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()
        if ranks is None:
            ranks = got
            continue
        for r, out in zip(ranks, got):
            r["cases"].update(out["cases"])
            r["peak_memory_gb"] = max(r["peak_memory_gb"], out["peak_memory_gb"])
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    launches, cases, vs_plain = {}, {}, {}
    for name, arch, layers, prompt, slots, steps, rules, shape, changes, want in PLACED_CASES:
        one = singles[name]
        errs, held_here = [], {}
        for r, out in enumerate(ranks):
            got = out["cases"][name]
            if {k: v for k, v in got["launches"].items() if v} != want:
                raise AssertionError(f"placed {name} rank {r}: prefill launches {got['launches']}, expected {want}")
            if set(got["kernel_vs_plain"]) != set(want):
                raise AssertionError(f"placed {name} rank {r}: held {sorted(got['kernel_vs_plain'])} against their "
                                     f"plain versions, launched {sorted(want)}")
            for k, h in got["kernel_vs_plain"].items():
                held_here[k] = max(held_here.get(k, 0.0), h["max_abs_err"])
                agg = vs_plain.setdefault(k, {"max_abs_err": 0.0, "calls_held": 0, "shapes": []})
                agg["max_abs_err"] = max(agg["max_abs_err"], h["max_abs_err"])
                agg["calls_held"] += len(h["shapes"])
                agg["shapes"] += [sh for sh in h["shapes"] if sh not in agg["shapes"]]
            for i, (g, w) in enumerate(zip(got["logits"], one["logits"], strict=True)):
                err, scale = logits_err(g, w)
                if err > LOGITS_TOL * (1 + scale):
                    raise AssertionError(f"placed {name} rank {r} step {i}: logits {err} from one process "
                                         f"(scale {scale})")
                errs.append(err)
            for k, v in got["launches"].items():
                launches[k] = launches.get(k, 0) + v
        agree = [bool(torch.equal(a, b)) for a, b in zip(ranks[0]["cases"][name]["tokens"], one["tokens"])]
        got = [o["cases"][name] for o in ranks]
        cases[name] = {"logits_max_abs_err": max(errs), "greedy_tokens_agree": sum(agree), "of_tokens": len(agree),
                       "prefill_s": max(g["prefill_s"] for g in got), "decode_ms": max(g["decode_ms"] for g in got),
                       "single_process": {"prefill_s": one["prefill_s"], "decode_ms": one["decode_ms"]},
                       "launches_per_rank": want, "kernel_vs_plain_max_abs_err": held_here,
                       "cache_placements": got[0]["cache_placements"]}
        c = cases[name]
        print(f"placed {name} ({shape} mesh, {PLACED_BATCH} x {prompt} into {slots} slots, {steps} steps): logits "
              f"within {c['logits_max_abs_err']:.4g} of one process, greedy tokens agree {c['greedy_tokens_agree']}"
              f"/{c['of_tokens']}; prefill {c['prefill_s']:.2f} s, decode {c['decode_ms']:.0f} ms a step against "
              f"{one['prefill_s']:.3f} s / {one['decode_ms']:.1f} ms in one process; launches {want} a rank a "
              f"prefill, on the ranks' shards within {held_here} of the plain versions; cache "
              f"{c['cache_placements']}", flush=True)
    loss = {}
    for arch, seq in PLACED_LOSS:
        one, family = loss_singles[arch], placed_cfg(arch, None, {}).family
        for r, out in enumerate(ranks):
            got = out["loss"][arch]
            if not (held(got["loss"], one["loss"], TRAIN_LOSS_TOL[family])
                    and held(got["grad_norm"], one["grad_norm"], TRAIN_LOSS_TOL[family])):
                raise AssertionError(f"placed loss {arch} rank {r}: {got['loss']} / {got['grad_norm']} vs one "
                                     f"process {one['loss']} / {one['grad_norm']}")
            for k, v in got["launches"].items():
                launches[k] = launches.get(k, 0) + v
        got = ranks[0]["loss"][arch]
        loss[arch] = {"loss": got["loss"], "grad_norm": got["grad_norm"], "single_process": one,
                      "s": max(o["loss"][arch]["s"] for o in ranks), "batch": PLACED_BATCH, "seq": seq}
        print(f"placed loss {arch} ({PLACED_BATCH} x {seq}): loss {got['loss']:.4f} / grad norm "
              f"{got['grad_norm']:.4f} vs one process {one['loss']:.4f} / {one['grad_norm']:.4f}", flush=True)
    out = {"card": card, "ranks": math.prod(PLACED_SHAPE), "backend": "gloo", "cases": cases, "loss": loss,
           "dryrun": dryrun, "launches": launches, "kernel_vs_plain": vs_plain,
           "rank_peak_memory_gb": max(o["peak_memory_gb"] for o in ranks),
           "parent_gb": parent_gb, "phase_s": {"total": time.perf_counter() - t_phase, "spawns": spawn_s},
           "cuts": placed_cuts(), "tolerances": placed_tolerances()}
    assert tuple(out) == PLACED_LINE_KEYS
    print(json.dumps({"placed_serving": out}), flush=True)
    return out


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
    phase_walls, t_lap = {}, [time.perf_counter()]

    def lap(phase: str) -> None:
        """Records and prints the wall seconds of the phase that just ended."""
        now = time.perf_counter()
        phase_walls[phase] = now - t_lap[0]
        t_lap[0] = now
        print(f"phase {phase}: {phase_walls[phase]:.1f} s", flush=True)

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
    lap("2")

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
    lap("3")

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
    lap("4")

    # -- 5. ACC beside the other five schemes -----------------------------------
    six_launches = acc_phase(device)
    sweep_entry["launches_by_path"] = {"five_schemes": sweep_entry["launches"], "six_schemes": six_launches}
    sweep_entry["launches"] += six_launches
    lap("5")

    # -- 6. contended markets: capacity studies through the sweep kernel --------
    capacity_launches = capacity_phase(device, open_kills, open_completed)
    sweep_entry["launches_by_path"]["capacity"] = capacity_launches
    sweep_entry["launches"] += sum(capacity_launches.values())
    lap("6")

    # -- 7. the fleet: placement and attempt waves on the card ----------------
    fleet_phase(device)
    lap("7")

    # -- 8. serving under spot auto-scaling: the batch engine's waves on the card
    autoscale_phase(device)
    lap("8")

    # -- 9. the suite control plane: a serving suite through the run store -----
    suite_phase(device)
    lap("9")

    # -- 10. the model kernels vs their plain versions at small shapes --------
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    small_errs = small_kernel_checks(device)
    lap("10")

    # -- 11. serving at full width -------------------------------------------
    init_stream_check(device)
    found = serve_models(device)
    lap("11")

    # -- 12. the codec kernel vs its plain version at small sizes ---------------
    small_codec_checks(device)
    lap("12")

    # -- 13. training through the kernels at small sizes -----------------------
    small_train = small_training_checks(device)
    lap("13")

    # -- 14. training at full width --------------------------------------------
    training, codec_measured = train_full_width(device)
    lap("14")

    # -- 15. the spot campaign at full width ----------------------------------
    campaign = spot_campaign(device)
    print(json.dumps({"training": {"card": card, **training, "campaign": campaign, "small": small_train}}), flush=True)
    lap("15")

    # -- 16. four ranks on the card: compression, SP decode, EP MoE ------------
    parallel = parallel_phase(device, card)
    lap("16")

    # -- 17. four ranks on the card: placed training, the elastic restore -----
    mesh = mesh_phase(device, card)
    lap("17")

    # -- 18. four ranks on the card: placed serving; the dry run on the host ---
    placed = placed_serving_phase(device, card)
    lap("18")

    # -- 19. the kernels line -------------------------------------------------
    rows = model_kernel_rows(found, small_errs)
    for row in rows:
        extra = campaign["launches"].get(row["name"], 0) + (
            TRAIN_STEPS * training["flash_attention_launches_per_step"] if row["name"] == "flash_attention" else 0)
        sp = parallel["sp_decode"]["flash_launches"] if row["name"] == "flash_attention" else 0
        on_mesh = mesh["launches"].get(row["name"], 0)
        on_placed = placed["launches"].get(row["name"], 0)
        row["max_abs_err"] = max(row["max_abs_err"], placed["kernel_vs_plain"][row["name"]]["max_abs_err"])
        row["launches_by_path"] = {"serving": row["launches"], "training": extra}
        if sp:
            row["launches_by_path"]["sp_decode_prefill"] = sp
        row["launches_by_path"]["mesh"] = on_mesh
        row["launches_by_path"]["placed_serving"] = on_placed
        row["launches"] += extra + sp + on_mesh + on_placed
    codec = codec_row(codec_measured, campaign["launches"]["ckpt_codec"] + mesh["launches"]["ckpt_codec"])
    codec["launches_by_path"] = {"campaign": campaign["launches"]["ckpt_codec"], "mesh": mesh["launches"]["ckpt_codec"]}
    print(json.dumps({"phase_s": phase_walls}), flush=True)
    print(json.dumps({"kernels": [sweep_entry, *rows, codec]}), flush=True)

    # -- 20. the result line ------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
