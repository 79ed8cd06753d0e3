"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test needs a CUDA device and ``nvcc`` and skips
without them (so on a CPU-only machine).  On the card the kernels are built
from ``src/repro_torch/kernels/*/csrc/*.cu``.  Each output of the spot-sweep
kernel must equal the plain version's bit for bit (NaN pads included): both do
the same IEEE float64 + − × ÷ and compares, and the kernel is built with
``--fmad=false``.  The model kernels (flash attention, SSM and RG-LRU scans)
are held to their plain versions within the JAX tests' tolerances, and the
smoke-size models to their plain path.  The checkpoint codec must equal its
plain version bit for bit (q and scales; NaN scales where the plain version's
are NaN), and gradients through the model kernels' autograd Functions must
equal the plain path's where their backward recomputes the plain version
(float32); the attention's backward kernel (bf16) is held to
``ref.attention_backward`` within ``BACKWARD_TOL`` and to its own bits.  The
AdamW update kernel must equal the plain ``upd_block`` bit for bit for every
pairing of parameter and moment dtypes, and its sum of squares lie within
1e-6 of ``torch.sum``'s (another order of the same float32 additions) and
repeat its own bits; ``adamw_update`` on the card launches one update and one
sum a leaf and never waits on the device.  The Mamba scan's inputs (dtA, dBx)
must equal the plain formation bit for bit (NaN where it is NaN), alone and
in both Mamba families' ``ssm_inputs``, and launch once a Mamba layer in a
prefill and in a decode step.  Run
them on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import PORTED_ARCHS
from repro_torch.core import HOUR, SimParams, catalog, get_instance, step_trace, synthetic_trace
from repro_torch.core.schemes import Scheme
from repro_torch.engine import ALL_SCHEMES, BID_LIMITED_SCHEMES, COMPARED, Scenario, TorchEngine
from repro_torch.engine.batch import grid_and_tables
from repro_torch.kernels import _build
from repro_torch.kernels.adamw import kernel as adamw_kernel
from repro_torch.kernels.adamw import ref as adamw_ref
from repro_torch.kernels.flash_attention import kernel as flash
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.mamba_inputs import kernel as inputs
from repro_torch.kernels.mamba_inputs import ref as inputs_ref
from repro_torch.kernels.rglru_scan import kernel as rglru
from repro_torch.kernels.rglru_scan import ref as rglru_ref
from repro_torch.kernels.spot_sweep import kernel, ops, ref
from repro_torch.kernels.ssm_scan import kernel as ssm
from repro_torch.kernels.ssm_scan import ref as ssm_ref

pytestmark = pytest.mark.cuda

FIELDS = ("completed", "completion_time", "cost", "n_checkpoints", "n_kills", "work_lost_s")
DAY = 24 * HOUR


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        _build.nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernel")
    return torch.device("cuda")


def scenarios():
    it = get_instance("m1.xlarge")
    return {
        "synthetic": Scenario.from_trace(
            synthetic_trace(it, 12, seed=3), 20 * HOUR, bids=[0.40, 0.41, 0.42, 0.45, 5.0],
            schemes=BID_LIMITED_SCHEMES,
        ),
        "resume": Scenario(
            work_s=30 * HOUR, bids=(0.01, 0.30, 0.345, 0.36, 5.0), traces=(synthetic_trace(it, 20, seed=7),),
            initial_saved_work=10 * HOUR, params=SimParams(t_c=450.0, t_r=900.0),
        ),
        "step_trace": Scenario.from_trace(
            step_trace(
                [(0.0, 0.30), (0.4 * DAY, 0.50), (0.45 * DAY, 0.31), (1.3 * DAY, 0.52),
                 (1.35 * DAY, 0.29), (2.0 * DAY, 0.55)],
                horizon_s=3 * DAY,
            ),
            10 * HOUR, bids=[0.295, 0.32, 0.51], schemes=BID_LIMITED_SCHEMES,
        ),
        "grid": Scenario.grid(
            work_s=24 * HOUR, bids=[0.5, 0.53, 0.56, 0.6], instances=catalog()[::13],
            horizon_days=15.0, seeds=(0, 1), bid_fractions=True,
        ),
    }


def assert_bitwise(got, want, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if got.dtype == torch.float64:
        got, want = got.view(torch.int64), want.view(torch.int64)
    assert torch.equal(got, want), name


@pytest.mark.parametrize("name", ["synthetic", "resume", "step_trace", "grid"])
def test_kernel_matches_plain_version_bitwise(cuda, name):
    sc = scenarios()[name]
    grid, tables = grid_and_tables(sc, sc.materialize(), True)
    arrs = ops.device_arrays(grid, cuda, True, True, sc.params.t_r, tables)
    args = (
        sc.schemes, arrs["A"], arrs["B"], arrs["valid"], arrs["horizon"],
        ops.sweep_consts(sc, tables), arrs["ptr0"], arrs["edges"], arrs["tables"],
    )
    got = kernel.spot_sweep(*args)
    want = ref.sweep_plain(*args)
    torch.cuda.synchronize()
    names = ("done", "comp_time", "n_ckpt", "work_lost", "n_kills", "rec_exists", "rec_end", "rec_user")
    for n, g, w in zip(names, got, want):
        assert_bitwise(g, w, n)


def test_engine_on_card_equals_engine_on_cpu(cuda):
    sc = scenarios()["grid"]
    before = kernel.launches
    with obs.retrace_guard(_build.BUILD_SCOPE, allow=1):
        on_card = TorchEngine(device=cuda).run(sc)
    assert kernel.launches == before + 1
    assert on_card.timings.impl == "cuda"
    on_cpu = TorchEngine(device="cpu").run(sc)
    for field in FIELDS:
        np.testing.assert_array_equal(getattr(on_card, field), getattr(on_cpu, field), err_msg=field)
    with obs.retrace_guard(_build.BUILD_SCOPE):  # the built library is reused
        TorchEngine(device=cuda).run(sc)


@pytest.mark.parametrize("name", ["synthetic", "resume", "step_trace", "grid"])
def test_six_schemes_on_card_equal_the_cpu(cuda, name):
    """ACC's lockstep walk runs in torch ops on the card beside the one sweep
    launch of the other five schemes; every field equals the CPU engine's."""
    sc = dataclasses.replace(scenarios()[name], schemes=ALL_SCHEMES)
    before = kernel.launches
    on_card = TorchEngine(device=cuda).run(sc)
    assert kernel.launches == before + 1
    on_cpu = TorchEngine(device="cpu").run(sc)
    for field in COMPARED:
        np.testing.assert_array_equal(getattr(on_card, field), getattr(on_cpu, field), err_msg=field)
    acc_only = dataclasses.replace(sc, schemes=(Scheme.ACC,))
    alone = TorchEngine(device=cuda).run(acc_only)
    assert kernel.launches == before + 1  # ACC alone launches no kernel
    a = ALL_SCHEMES.index(Scheme.ACC)
    for field in COMPARED:
        np.testing.assert_array_equal(getattr(alone, field)[:, :, 0], getattr(on_cpu, field)[:, :, a], err_msg=field)


@pytest.mark.parametrize("name", ["synthetic", "step_trace", "grid"])
def test_contended_studies_on_card_equal_the_cpu(cuda, name):
    """A contended market clears each trace on the host and runs the same
    sweep: one kernel launch, every field equal to the CPU engine's."""
    sc = dataclasses.replace(scenarios()[name], schemes=ALL_SCHEMES, capacity=3, demand=2)
    before = kernel.launches
    on_card = TorchEngine(device=cuda).run(sc)
    assert kernel.launches == before + 1
    on_cpu = TorchEngine(device="cpu").run(sc)
    for field in COMPARED:
        np.testing.assert_array_equal(getattr(on_card, field), getattr(on_cpu, field), err_msg=field)


@pytest.mark.parametrize("scheme", list(Scheme))
def test_fleet_batch_engine_on_card_equals_the_cpu(cuda, scheme):
    """The fleet's EET and attempt waves as torch ops on the card: every
    record equal to the same waves on the CPU."""
    from repro_torch.engine import FleetScenario, run_fleet
    from repro_torch.fleet.batch import _Memo
    from repro_torch.engine.fleetgrid import fleet_inputs

    fs = FleetScenario(n_jobs=12, mean_interarrival_s=1800.0, mean_work_h=3.0, horizon_days=4.0, n_types=8,
                       seeds=(0, 1), scheme=scheme)
    inp = fleet_inputs(fs)
    inp.memo = _Memo(inp.traces_by_seed, inp.hist_by_seed)
    with obs.Telemetry() as tel:
        on_card = run_fleet(fs, device=cuda).results
    assert tel.counter("fleet_batch.attempt_waves") > 0
    on_cpu = run_fleet(fs, device="cpu").results
    assert list(on_card) == list(on_cpu)
    for key, res in on_cpu.items():
        assert on_card[key].records == res.records


def test_wrapper_rejects_bad_inputs(cuda):
    sc = scenarios()["step_trace"]
    grid, tables = grid_and_tables(sc, sc.materialize(), True)
    arrs = ops.device_arrays(grid, cuda, True, True, sc.params.t_r, tables)
    consts = ops.sweep_consts(sc, tables)
    base = dict(ptr0=arrs["ptr0"], edges=arrs["edges"], tables=arrs["tables"])
    A, B, V, H = arrs["A"], arrs["B"], arrs["valid"], arrs["horizon"]
    with pytest.raises(TypeError, match="dtype"):
        kernel.spot_sweep(sc.schemes, A.float(), B, V, H, consts, **base)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.spot_sweep(sc.schemes, A.t().contiguous().t(), B, V, H, consts, **base)
    with pytest.raises(ValueError, match="EDGE needs"):
        kernel.spot_sweep(sc.schemes, A, B, V, H, consts, tables=arrs["tables"])
    flat, off, top = arrs["tables"]
    with pytest.raises(ValueError, match="out of range"):
        kernel.spot_sweep(sc.schemes, A, B, V, H, consts, ptr0=arrs["ptr0"], edges=arrs["edges"],
                          tables=(flat[:1], off, top))


SWEEP_OUTPUTS = ("done", "comp_time", "n_ckpt", "work_lost", "n_kills", "rec_exists", "rec_end", "rec_user")


def sweep_inputs(sc, device):
    """The sweep's arguments for ``sc`` as a dict (``schemes``, the grid arrays,
    ``consts``, ``ptr0``, ``edges``, ``tables``)."""
    grid, tables = grid_and_tables(sc, sc.materialize(), True)
    arrs = ops.device_arrays(grid, device, True, True, sc.params.t_r, tables)
    return dict(schemes=sc.schemes, A=arrs["A"], B=arrs["B"], valid=arrs["valid"], horizon=arrs["horizon"],
                consts=ops.sweep_consts(sc, tables), ptr0=arrs["ptr0"], edges=arrs["edges"], tables=arrs["tables"])


def cut_sweep_inputs(x, cells=None, periods=None):
    """The last ``cells`` cells and the first ``periods`` periods of the sweep's inputs."""
    c, p = slice(-cells if cells else None, None), slice(periods)
    flat, base, n = x["edges"]
    tab, off, top = x["tables"]
    return dict(x, A=x["A"][c, p].contiguous(), B=x["B"][c, p].contiguous(), valid=x["valid"][c, p].contiguous(),
                horizon=x["horizon"][c].contiguous(), ptr0=x["ptr0"][c, p].contiguous(),
                edges=(flat, base[c].contiguous(), n[c].contiguous()), tables=(tab, off[c].contiguous(),
                                                                                top[c].contiguous()))


def sweep_case(name, device):
    """Inputs that reach the corners of the kernel's design: one block a scheme
    (subsets and orders of the schemes; C off 32 and 128, so blocks end in the
    per-scheme padding), the record pass (P = 1, odd and even P; a non-prefix
    ``valid`` mask; cells that complete in their first period) and ADAPT's
    table clamp (tops at ``n_bins``)."""
    base = Scenario.grid(  # 22 types x 2 seeds x 3 bids = 132 cells: one block and 4 cells
        work_s=24 * HOUR, bids=[0.5, 0.55, 0.6], instances=catalog()[::3], horizon_days=10.0, seeds=(0, 1),
        bid_fractions=True,
    )
    x = sweep_inputs(base, device)
    S = BID_LIMITED_SCHEMES
    if name == "adapt_only":
        return dict(x, schemes=(Scheme.ADAPT,))
    if name == "edge_none":
        return dict(x, schemes=(Scheme.EDGE, Scheme.NONE))
    if name == "all_reversed":
        return dict(x, schemes=tuple(reversed(S)))
    if name.startswith("cells_"):
        return cut_sweep_inputs(x, cells=int(name.split("_")[1]))
    if name.startswith("periods_"):
        return cut_sweep_inputs(x, periods=int(name.split("_")[1]))
    rng = np.random.default_rng(5)
    if name == "holes":  # valid periods with invalid ones between them
        holes = torch.from_numpy(rng.random(tuple(x["valid"].shape)) < 0.3).to(device)
        return dict(x, valid=x["valid"] & ~holes)
    if name == "first_period":  # 15 minutes of work: done in the first period long enough to start
        return dict(x, consts=dict(x["consts"], work_s=900.0))
    if name == "top_at_n_bins":  # 40 bins of 60 s, most tables topping out at n_bins
        C, n_bins = x["A"].shape[0], 40
        surv = -np.sort(-rng.random((C, n_bins + 2)), axis=1)
        surv[:, -3:] = 0.0  # the last bins: survival 0 (hazard 1)
        top = np.full(C, n_bins)
        top[::7] = rng.integers(0, n_bins + 1, size=top[::7].shape)
        tables = (torch.from_numpy(surv.reshape(-1).copy()).to(device),
                  torch.arange(C, device=device) * (n_bins + 2), torch.from_numpy(top).to(device))
        return dict(x, consts=dict(x["consts"], n_bins=n_bins), tables=tables)
    raise KeyError(name)


SWEEP_CASES = ("adapt_only", "edge_none", "all_reversed", "cells_77", "cells_33", "cells_1", "periods_1", "periods_9",
               "periods_16", "holes", "first_period", "top_at_n_bins")


@pytest.mark.parametrize("name", SWEEP_CASES)
def test_kernel_matches_plain_version_bitwise_on_every_shape(cuda, name):
    x = sweep_case(name, cuda)
    args = (x["schemes"], x["A"], x["B"], x["valid"], x["horizon"], x["consts"], x["ptr0"], x["edges"], x["tables"])
    before = kernel.launches
    got = kernel.spot_sweep(*args)
    want = ref.sweep_plain(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    for n, g, w in zip(SWEEP_OUTPUTS, got, want):
        assert_bitwise(g, w, n)
    if name == "first_period":  # the case reaches what it names
        p_first = torch.argmax((x["valid"] & (x["A"] + x["consts"]["t_r"] < x["B"])).to(torch.int8), dim=1)
        done_first = got[7][:, torch.arange(x["A"].shape[0], device=cuda), p_first]
        assert bool(done_first.any())


def close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


ATTN_TOL = {torch.float32: 2e-6, torch.bfloat16: 2e-2}  # tests/kernels/test_flash_attention.py


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "case",
    [
        # (B, Sq, Sk, KV, G, D, causal, window, q_offset)
        (2, 200, 200, 2, 4, 64, True, 0, 0),
        (2, 256, 256, 4, 1, 64, False, 0, 0),
        (1, 300, 300, 1, 16, 128, True, 100, 0),
        (1, 256, 256, 2, 4, 64, True, 64, 0),
        (1, 64, 320, 1, 16, 256, True, 96, 256),
        (2, 77, 77, 2, 2, 16, True, 0, 0),
        (1, 33, 33, 2, 2, 32, False, 8, 0),
        (1, 333, 333, 2, 3, 128, True, 0, 0),  # G = 3 divides no tile of 128 rows
        (2, 257, 257, 2, 4, 128, True, 0, 0),
        (1, 200, 455, 1, 2, 64, True, 100, 255),  # Sk > Sq with q_offset, window off the kv tile
        (2, 130, 130, 2, 1, 256, True, 300, 0),  # window > Sk
        (1, 129, 300, 1, 4, 256, True, 70, 171),
        (1, 190, 190, 1, 16, 128, False, 77, 0),
    ],
)
def test_flash_attention_matches_plain_version(cuda, case, dtype):
    B, Sq, Sk, KV, G, D, causal, window, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((B, Sq, KV * G, D), generator=gen, device=cuda).to(dtype)
    k, v = torch.randn((2, B, Sk, KV, D), generator=gen, device=cuda).to(dtype)
    before = flash.launches
    got = flash.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset)
    want = flash_ref.block_attention(q, k, v, causal=causal, window=window, q_offset=q_offset, q_block=64, kv_block=64)
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    close(got, want, ATTN_TOL[dtype])


#: Backward kernel vs the plain version (``ref.attention_backward`` in float32 from the plain
#: forward's float32 O and LSE): max |diff| <= BACKWARD_TOL * max |plain| for each of dq, dk
#: and dv.  bf16's 2e-2 (ATTN_TOL's), taken relative to the gradient's scale: the kernel rounds
#: P and dS to bf16 as tensor-core operands (the forward's P V makes the same rounding), starts
#: from the forward's bf16 O, and rounds its gradients to bf16.  The forward's LSE: 1e-4
#: absolute (ex2.approx and sums in another order, on values of order 10).
BACKWARD_TOL, LSE_TOL = 2e-2, 1e-4


@pytest.mark.parametrize(
    "case",
    [
        # (B, Sq, Sk, KV, G, D, causal, window, q_offset)
        (2, 4096, 4096, 2, 16, 128, True, 0, 0),  # glm4-9b's train shape
        (1, 2048, 2048, 8, 6, 128, True, 0, 0),  # internlm2-20b: G 6
        (2, 1024, 1024, 2, 7, 64, True, 0, 0),  # internvl2-1b: D 64, G 7
        (1, 1500, 1500, 20, 1, 64, False, 0, 0),  # whisper's bidirectional encoder
        (1, 1024, 1024, 8, 8, 112, True, 0, 0),  # kimi-k2: D 112
        (1, 200, 455, 2, 8, 128, True, 100, 255),  # a window with q_offset, Sk > Sq
        (1, 1000, 1000, 2, 6, 128, True, 0, 0),  # ragged Sq = 1000
        (1, 1000, 1200, 1, 4, 64, False, 300, 150),  # bidirectional window with q_offset, ragged
    ],
)
def test_flash_attention_backward_matches_plain_version(cuda, case):
    B, Sq, Sk, KV, G, D, causal, window, q_offset = case
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((B, Sq, KV * G, D), generator=gen, device=cuda).bfloat16()
    k, v = torch.randn((2, B, Sk, KV, D), generator=gen, device=cuda).bfloat16()
    do = torch.randn((B, Sq, KV * G, D), generator=gen, device=cuda).bfloat16()
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    job = flash.prepare(q, k, v, lse=True, **kw)
    o = flash.launch(job)
    before = flash.backward_launches
    got = flash.backward_launch(flash.backward_prepare(q, k, v, o, job.outs[1], do, **kw))
    again = flash.backward_launch(flash.backward_prepare(q, k, v, o, job.outs[1], do, **kw))
    o_ref, lse_ref = flash_ref.block_attention(q.float(), k.float(), v.float(), return_lse=True, **kw)
    want = flash_ref.attention_backward(q.float(), k.float(), v.float(), o_ref, lse_ref, do.float(), **kw)
    torch.cuda.synchronize()
    assert flash.backward_launches == before + 2
    torch.testing.assert_close(job.outs[1], lse_ref, atol=LSE_TOL, rtol=0)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        err, scale = float((g.float() - w).abs().max()), float(w.abs().max())
        assert err <= BACKWARD_TOL * scale, (err, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: the same bits every run


def test_flash_attention_function_dispatches_its_backward(cuda):
    """bf16 at a served head dim takes the backward kernel through the autograd Function
    (the same bits as a direct launch); float32 and D = 256 recompute the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    for dtype, d, kernel_backward in ((torch.bfloat16, 128, True), (torch.float32, 128, False),
                                      (torch.bfloat16, 256, False)):
        q = torch.randn((1, 300, 8, d), generator=gen, device=cuda).to(dtype)
        k, v = torch.randn((2, 1, 300, 2, d), generator=gen, device=cuda).to(dtype)
        w = torch.randn((1, 300, 8, d), generator=gen, device=cuda).to(dtype)
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = flash.backward_launches
        out = flash.flash_attention(*xs, causal=True)
        grads = torch.autograd.grad(out, xs, w)
        torch.cuda.synchronize()
        assert flash.backward_launches == before + kernel_backward
        if kernel_backward:
            job = flash.prepare(q, k, v, lse=True, causal=True)
            o = flash.launch(job)
            direct = flash.backward_launch(flash.backward_prepare(q, k, v, o, job.outs[1], w, causal=True))
            assert all(torch.equal(a, b) for a, b in zip(grads, direct))


def test_flash_attention_runs_from_a_fresh_thread(cuda):
    """Forward and backward launched from a thread that has made no CUDA call yet (as
    autograd's threads may be): the launches make the context current before the
    CUDA driver encodes their tensor maps, and give the main thread's bits."""
    import threading

    gen = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((1, 300, 8, 128), generator=gen, device=cuda).bfloat16()
    k, v = torch.randn((2, 1, 300, 2, 128), generator=gen, device=cuda).bfloat16()
    do = torch.randn((1, 300, 8, 128), generator=gen, device=cuda).bfloat16()

    def both():
        job = flash.prepare(q, k, v, lse=True, causal=True)
        o = flash.launch(job)
        return (o, *flash.backward_launch(flash.backward_prepare(q, k, v, o, job.outs[1], do, causal=True)))

    got = []
    thread = threading.Thread(target=lambda: got.append(both()))
    thread.start()
    thread.join()
    want = both()
    torch.cuda.synchronize()
    assert len(got) == 1 and all(torch.equal(a, b) for a, b in zip(got[0], want))


@pytest.mark.parametrize("shape", [(2, 77, 40, 16), (1, 301, 24, 4), (2, 5, 8, 2), (1, 63, 16, 32)])
@pytest.mark.parametrize("c_dtype", [torch.float32, torch.bfloat16], ids=["c_f32", "c_bf16"])
def test_ssm_scan_matches_plain_version(cuda, shape, c_dtype):
    B, S, D, N = shape
    gen = torch.Generator(device=cuda).manual_seed(1)
    dtA = -torch.nn.functional.softplus(torch.randn(shape, generator=gen, device=cuda))
    dBx = torch.randn(shape, generator=gen, device=cuda)
    C = torch.randn((B, S, N), generator=gen, device=cuda).to(c_dtype)
    got, want = ssm.ssm_scan(dtA, dBx, C), ssm_ref.ssm_scan(dtA, dBx, C)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        close(g, w, 1e-4)  # tests/kernels/test_scans.py


@pytest.mark.parametrize("shape", [(2, 77, 96), (1, 1001, 130), (3, 9, 5), (2, 333, 100), (1, 4100, 36)])
def test_rglru_scan_matches_plain_version(cuda, shape):
    """Bit for bit: both bodies (TMA chunks for widths that are multiples of 4, a
    thread a channel for 130 and 5) round every operation as the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    log_a = -torch.nn.functional.softplus(torch.randn(shape, generator=gen, device=cuda))
    gx = torch.randn(shape, generator=gen, device=cuda)
    got, want = rglru.rglru_scan(log_a, gx), rglru_ref.rglru_scan(log_a, gx)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def mamba_inputs_args(shape, dtype, device, seed=0, extremes=False):
    """dt_pre, the bias, A_log, x and B (a strided view of the projection it is
    cut from, as the model's) for ``shape`` = (B, S, D, N).  ``extremes`` puts
    values in dt_pre that reach softplus's large-argument branch (v itself past
    ~1e8, 0 below ~-104), its infinities and NaN."""
    B, S, D, N = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda *s, scale=1.0: torch.randn(s, generator=gen, device=device) * scale  # noqa: E731
    dt_pre = r(B, S, D, scale=3.0)
    if extremes:
        flat = dt_pre.view(-1)
        flat[:12] = torch.tensor([float("inf"), float("-inf"), float("nan"), 3e38, -3e38, 1e9, -1e9, 88.0, -104.0,
                                  20.0, -20.0, 0.0], device=device)
    proj = r(B, S, 3 + 2 * N)
    a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=device)).repeat(D, 1) + r(D, N, scale=0.1)
    return (dt_pre.to(dtype), r(D).to(dtype), a_log, r(B, S, D, scale=2.0).to(dtype), proj.to(dtype)[..., 3:3 + N])


def assert_same_bits(got, want, what):
    """Bit for bit, NaN where the plain version is NaN (its payload aside)."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan), what
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)), what


@pytest.mark.parametrize("shape", [(2, 37, 40, 1), (1, 33, 24, 2), (2, 29, 64, 4), (1, 65, 80, 8), (2, 77, 300, 16),
                                   (1, 31, 33, 32), (3, 1, 520, 16), (1, 70, 8192, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mamba_inputs_match_the_plain_formation_bitwise(cuda, shape, dtype):
    """Every state size the scan takes, channels that fill no block's tile (40,
    300, 33, 520), row counts that fill no 64-row chunk (74, 154, 3), one
    position a row (decode), and B a strided view."""
    args = mamba_inputs_args(shape, dtype, cuda, seed=shape[2])
    before = inputs.launches
    got, want = inputs.mamba_inputs(*args), inputs_ref.mamba_inputs(*args)
    torch.cuda.synchronize()
    assert inputs.launches == before + 1
    for g, w, what in zip(got, want, ("dtA", "dBx")):
        assert_same_bits(g, w, what)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mamba_inputs_at_softplus_extremes_match_bitwise(cuda, dtype):
    args = mamba_inputs_args((2, 9, 40, 16), dtype, cuda, seed=3, extremes=True)
    got, want = inputs.mamba_inputs(*args), inputs_ref.mamba_inputs(*args)
    torch.cuda.synchronize()
    assert bool(torch.isinf(want[0]).any()) and bool(torch.isnan(want[0]).any())
    for g, w, what in zip(got, want, ("dtA", "dBx")):
        assert_same_bits(g, w, what)


@pytest.mark.parametrize("state", [4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba2-mini"])
def test_ssm_inputs_of_both_mamba_families_match_the_plain_path_bitwise(cuda, arch, dtype, state):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import ssm as mamba
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, ssm_state=state)
    params = T.init_params(cfg, seed=0, device=cuda)
    layer = params["layers"][0]
    gen = torch.Generator(device=cuda).manual_seed(4)
    layer["mixer.dt_bias"].copy_(torch.randn(layer["mixer.dt_bias"].shape, generator=gen, device=cuda))
    x_act = torch.nn.functional.silu(torch.randn((2, 45, cfg.d_inner), generator=gen, device=cuda)).to(
        layer["mixer.dt_bias"].dtype)
    before = inputs.launches
    got = mamba.ssm_inputs(cfg, layer, "mixer", x_act)
    want = mamba.ssm_inputs(cfg, layer, "mixer", x_act, impl="plain")
    torch.cuda.synchronize()
    assert inputs.launches == before + 1
    for g, w, what in zip(got, want, ("dtA", "dBx", "C")):
        assert torch.equal(g, w), what


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba2-mini"])
def test_mamba_inputs_launch_once_a_mamba_layer_in_prefill_and_decode(cuda, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T

    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, seed=0, device=cuda)
    mamba = sum(kind.startswith("mamba") for kind in T.layer_kinds(cfg))
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator(device=cuda).manual_seed(3),
                           device=cuda)
    counts = (inputs.launches, ssm.launches)
    logits, cache = T.prefill(cfg, params, {"tokens": tokens}, 32, q_block=8, kv_block=8)
    assert (inputs.launches - counts[0], ssm.launches - counts[1]) == (mamba, mamba)
    counts = (inputs.launches, ssm.launches)
    tok = logits[:, -1].argmax(-1, keepdim=True)
    step, _ = T.decode_step(cfg, params, tok, cache)
    torch.cuda.synchronize()
    assert (inputs.launches - counts[0], ssm.launches - counts[1]) == (mamba, 0)  # the decode scan is plain
    assert torch.isfinite(step.float()).all()
    counts = (inputs.launches, ssm.launches)
    plain_step, _ = T.decode_step(cfg, params, tok, cache, impl="plain")  # the same slot, the same values
    torch.cuda.synchronize()
    assert (inputs.launches, ssm.launches) == counts
    assert torch.equal(step, plain_step)


def test_mamba_inputs_wrapper_rejects_bad_inputs(cuda):
    dt_pre, bias, a_log, x, b = mamba_inputs_args((1, 8, 16, 4), torch.bfloat16, cuda)
    with pytest.raises(TypeError, match="dtype"):
        inputs.prepare(dt_pre, bias.float(), a_log, x, b)
    with pytest.raises(TypeError, match="dtype"):
        inputs.prepare(dt_pre, bias, a_log.bfloat16(), x, b)
    with pytest.raises(TypeError, match="dtype"):
        inputs.prepare(*(t.half() for t in (dt_pre, bias)), a_log, *(t.half() for t in (x, b)))
    with pytest.raises(ValueError, match="expected"):
        inputs.prepare(dt_pre, bias, a_log, x, b.float())
    with pytest.raises(ValueError, match="state size 12"):
        inputs.prepare(dt_pre, bias, torch.zeros((16, 12), device=cuda), x,
                       torch.zeros((1, 8, 12), device=cuda).bfloat16())
    with pytest.raises(ValueError, match="unit stride"):
        inputs.prepare(dt_pre, bias, a_log, x, torch.zeros((1, 8, 8), device=cuda).bfloat16()[..., ::2])
    with pytest.raises(ValueError, match="contiguous"):
        inputs.prepare(dt_pre, bias, a_log, x.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(ValueError, match="is on cpu"):
        inputs.prepare(dt_pre, bias, a_log, x.cpu(), b)
    with pytest.raises(ValueError, match="empty"):
        inputs.prepare(dt_pre[:, :0], bias, a_log, x[:, :0], b[:, :0])


def test_model_wrappers_reject_bad_inputs(cuda):
    q = torch.randn((1, 16, 4, 64), device=cuda)
    k = torch.randn((1, 16, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        flash.flash_attention(q, k.double(), k)
    with pytest.raises(TypeError, match="dtype"):
        flash.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="contiguous"):
        flash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError, match="head dim 48"):
        flash.flash_attention(torch.randn((1, 16, 4, 48), device=cuda), *[torch.randn((1, 16, 2, 48), device=cuda)] * 2)
    with pytest.raises(ValueError, match="kv heads"):
        flash.flash_attention(torch.randn((1, 16, 3, 64), device=cuda), k, k)
    lse = torch.zeros((1, 4, 16), device=cuda)
    with pytest.raises(ValueError, match="backward kernel takes"):  # float32: the plain recompute's
        flash.backward_prepare(q, k, k, q, lse, q)
    with pytest.raises(ValueError, match="backward kernel takes"):  # a window past the keys: a row sees none
        flash.backward_prepare(*(x.bfloat16() for x in (q, k, k, q)), lse, q.bfloat16(), window=4, q_offset=16)
    dtA = torch.randn((1, 8, 4, 16), device=cuda)
    C = torch.randn((1, 8, 16), device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        ssm.ssm_scan(dtA.bfloat16(), dtA, C)
    with pytest.raises(ValueError, match="state size 12"):
        ssm.ssm_scan(dtA[..., :12].contiguous(), dtA[..., :12].contiguous(), C[..., :12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rglru.rglru_scan(C.transpose(1, 2), C.transpose(1, 2))


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_smoke_models_on_the_card_match_their_plain_path(cuda, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T

    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, seed=0)
    gen = torch.Generator(device=cuda).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24), generator=gen, device=cuda)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((2, cfg.encoder_positions, cfg.d_model), generator=gen, device=cuda)
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.randn((2, cfg.vision_tokens, cfg.d_model), generator=gen, device=cuda)
        batch["vision_mask"] = (torch.arange(24, device=cuda) < cfg.vision_tokens).expand(2, 24)
    counts = {m: m.launches for m in (flash, rglru, ssm)}
    logits, cache = T.prefill(cfg, params, batch, 32, q_block=8, kv_block=8)
    kinds = T.layer_kinds(cfg)
    attention = sum(kinds.count(k) for k in ("dense", "attn", "moe", "decoder")) + cfg.encoder_layers
    assert flash.launches - counts[flash] == attention
    assert rglru.launches - counts[rglru] == kinds.count("rec")
    assert ssm.launches - counts[ssm] == kinds.count("mamba")
    plain, _ = T.prefill(cfg, params, batch, 32, q_block=8, kv_block=8, impl="plain")
    close(logits, plain, 2e-2)
    step, _ = T.decode_step(cfg, params, logits[:, -1].argmax(-1, keepdim=True), cache)
    assert torch.isfinite(step.float()).all()


# ---------------------------------------------------------------------------
# The checkpoint codec, and training through the kernels
# ---------------------------------------------------------------------------


def codec_equal(got, want):
    (q, s, shape), (q2, s2, shape2) = got, want
    assert shape == shape2 and q.shape == q2.shape and q.dtype == q2.dtype == torch.int8
    nan = torch.isnan(s2)
    assert torch.equal(torch.isnan(s), nan)
    assert torch.equal(s[~nan].view(torch.int32), s2[~nan].view(torch.int32))
    assert torch.equal(q[~nan], q2[~nan])  # q of a NaN block is undefined in both


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 4096, (1 << 20) + 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=["f32", "bf16", "f16"])
def test_ckpt_codec_matches_plain_version_bitwise(cuda, n, dtype):
    from repro_torch.kernels.ckpt_codec import kernel as codec, ref as codec_ref

    gen = torch.Generator(device=cuda).manual_seed(n)
    x = (torch.randn(n, generator=gen, device=cuda) * 3).to(dtype)
    if n > 600:
        x[256:512] = 0  # an all-zero block
        x[512] = float("nan")  # a NaN block
    before = codec.launches
    got = codec.quantize(x)
    torch.cuda.synchronize()
    assert codec.launches == before + 1
    codec_equal(got, codec_ref.quantize(x))


def test_ckpt_codec_rejects_bad_inputs(cuda):
    from repro_torch.kernels.ckpt_codec import kernel as codec

    with pytest.raises(TypeError):
        codec.prepare(torch.zeros(512, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        codec.prepare(torch.zeros((64, 64), device=cuda).t())
    with pytest.raises(ValueError, match="16-byte"):
        codec.prepare(torch.zeros(1024, device=cuda)[1:])
    with pytest.raises(ValueError, match="empty"):
        codec.prepare(torch.zeros(0, device=cuda))


# AdamW's hyperparameters as adamw_update hands them to the kernel: (b1, b2, 1 - b1, 1 - b2, eps, wd)
ADAMW_CONSTS = (0.9, 0.95, 1 - 0.9, 1 - 0.95, 1e-8, 0.1)
ADAMW_PAIRS = [(torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
               (torch.float32, torch.bfloat16)]
ADAMW_PAIR_IDS = ["bf16_f32", "bf16_bf16", "f32_f32", "f32_bf16"]


def adamw_leaf(n, pdt, mdt, device, seed, offset=0):
    """p, g, mu, nu of one leaf of n elements (views ``offset`` elements into their storage), with
    moments of a few steps' size, and the step's [clip, b1c, b2c, lr] for grad_clip 1.0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    r = lambda scale, dt: (torch.randn(n + offset, generator=gen, device=device) * scale).to(dt)[offset:]  # noqa: E731
    p, g, mu = r(1.0, pdt), r(3.0, pdt), r(0.01, mdt)
    nu = (torch.rand(n + offset, generator=gen, device=device) * 1e-4).to(mdt)[offset:]
    one = torch.ones((), device=device)
    norm = torch.maximum(adamw_ref.sum_of_squares(g).sqrt(), torch.full((), 1e-9, device=device))
    clip = torch.minimum(one, one / norm)
    stepf = torch.full((), 3.0, device=device)
    b1c, b2c = 1.0 - torch.pow(torch.full((), 0.9, device=device), stepf), 1.0 - torch.pow(
        torch.full((), 0.95, device=device), stepf)
    return (p, g, mu, nu), torch.stack([clip, b1c, b2c, torch.full((), 1e-3, device=device)])


def assert_adamw_bitwise(leaf, step):
    before = [x.clone() for x in leaf]
    launched = adamw_kernel.launches
    got = adamw_kernel.update(*leaf, step, ADAMW_CONSTS)
    want = adamw_ref.upd_block(*leaf, step, ADAMW_CONSTS)
    torch.cuda.synchronize()
    assert adamw_kernel.launches == launched + 1
    for x, y, kept in zip(got, want, (leaf[0], leaf[2], leaf[3])):
        assert x.dtype == y.dtype == kept.dtype and x.shape == y.shape == kept.shape
        assert torch.equal(x, y)
    assert all(torch.equal(x, b) for x, b in zip(leaf, before))  # the inputs are left as they are


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
@pytest.mark.parametrize("n", [1, 7, 4097, (1 << 20) + 3])
@pytest.mark.parametrize("pair", ADAMW_PAIRS, ids=ADAMW_PAIR_IDS)
def test_adamw_update_matches_plain_version_bitwise(cuda, pair, n, grad_clip):
    leaf, step = adamw_leaf(n, *pair, cuda, seed=n)
    if not grad_clip:
        step[0] = 1.0
    assert_adamw_bitwise(leaf, step)


@pytest.mark.parametrize("offset", [1, 3])
@pytest.mark.parametrize("pair", ADAMW_PAIRS, ids=ADAMW_PAIR_IDS)
def test_adamw_update_of_a_view_at_an_odd_offset(cuda, pair, offset):
    leaf, step = adamw_leaf(4097, *pair, cuda, seed=offset, offset=offset)
    assert all(x.storage_offset() == offset for x in leaf)
    assert_adamw_bitwise(leaf, step)


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("n", [1, 7, 4097, (1 << 20) + 3, (1 << 26) + 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_adamw_sum_of_squares_matches_torch_sum(cuda, dtype, n, offset):
    gen = torch.Generator(device=cuda).manual_seed(n + offset)
    x = (torch.randn(n + offset, generator=gen, device=cuda) * 3).to(dtype)[offset:]
    launched = adamw_kernel.sumsq_launches
    got = adamw_kernel.sum_of_squares(x)
    again = adamw_kernel.sum_of_squares(x)
    want = torch.sum(torch.square(x.float()))
    torch.cuda.synchronize()
    assert adamw_kernel.sumsq_launches == launched + 2
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_adamw_wrappers_reject_bad_inputs(cuda):
    (p, g, mu, nu), step = adamw_leaf(64, torch.bfloat16, torch.float32, cuda, seed=1)
    with pytest.raises(TypeError, match="parameter's"):
        adamw_kernel.prepare(p, g.float(), mu, nu, step, ADAMW_CONSTS)
    with pytest.raises(TypeError, match="mu's"):
        adamw_kernel.prepare(p, g, mu, nu.bfloat16(), step, ADAMW_CONSTS)
    with pytest.raises(TypeError, match="dtype"):
        adamw_kernel.prepare(p.half(), g.half(), mu, nu, step, ADAMW_CONSTS)
    with pytest.raises(ValueError, match="contiguous"):
        adamw_kernel.prepare(*(x.view(8, 8).t() for x in (p, g, mu, nu)), step, ADAMW_CONSTS)
    with pytest.raises(ValueError, match="is on cpu"):
        adamw_kernel.prepare(p, g.cpu(), mu, nu, step, ADAMW_CONSTS)
    with pytest.raises(ValueError, match="runs on cuda"):
        adamw_kernel.prepare(p.cpu(), g, mu, nu, step, ADAMW_CONSTS)
    with pytest.raises(ValueError, match="elements"):
        adamw_kernel.prepare(p, g, mu[:32], nu, step, ADAMW_CONSTS)
    with pytest.raises(ValueError, match="step"):
        adamw_kernel.prepare(p, g, mu, nu, step[:3], ADAMW_CONSTS)
    with pytest.raises(ValueError, match="empty"):
        adamw_kernel.prepare(p[:0], g[:0], mu[:0], nu[:0], step, ADAMW_CONSTS)
    with pytest.raises(TypeError, match="dtype"):
        adamw_kernel.sum_of_squares(g.half())
    with pytest.raises(ValueError, match="contiguous"):
        adamw_kernel.sum_of_squares(g.view(8, 8).t())
    with pytest.raises(ValueError, match="runs on cuda"):
        adamw_kernel.sum_of_squares(g.cpu())
    with pytest.raises(ValueError, match="empty"):
        adamw_kernel.sum_of_squares(g[:0])


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_on_the_card_launches_a_kernel_a_leaf_and_never_syncs(cuda, moment_dtype):
    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

    gen = torch.Generator(device=cuda).manual_seed(2)
    params = {"w": torch.randn((300, 70), generator=gen, device=cuda).bfloat16(),
              "b": torch.randn(5000, generator=gen, device=cuda), "s": torch.randn((), generator=gen, device=cuda)}
    cfg = AdamWConfig(lr=1e-2, moment_dtype=moment_dtype)
    state = adamw_init(params, cfg)
    leaves, treedef = tree_lib.flatten((params, state))
    cpu_params, cpu_state = treedef.unflatten([x.cpu() for x in leaves])
    for i in range(3):
        grads = {k: (torch.randn(v.shape, generator=gen, device=cuda) * 3).to(v.dtype) for k, v in params.items()}
        launched, summed = adamw_kernel.launches, adamw_kernel.sumsq_launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            params, state, metrics = adamw_update(params, grads, state, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert adamw_kernel.launches == launched + 3 and adamw_kernel.sumsq_launches == summed + 3
        cpu_grads = {k: v.cpu() for k, v in grads.items()}
        cpu_params, cpu_state, cpu_metrics = adamw_update(cpu_params, cpu_grads, cpu_state, cfg)
        torch.testing.assert_close(metrics["grad_norm"].cpu(), cpu_metrics["grad_norm"], rtol=1e-6, atol=0)
    for x, y in zip(tree_lib.leaves((params, state)), tree_lib.leaves((cpu_params, cpu_state))):
        torch.testing.assert_close(x.cpu(), y)  # the norm's last bits may move the clip, and a rounding


def test_checkpoint_int8_quantizes_on_the_card(cuda, tmp_path):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.kernels.ckpt_codec import kernel as codec

    gen = torch.Generator(device=cuda).manual_seed(5)
    tree = {"w": torch.randn((300, 70), generator=gen, device=cuda).to(torch.bfloat16),
            "m": torch.randn(5000, generator=gen, device=cuda), "small": torch.randn(10, device=cuda)}
    before = codec.launches
    mgr = CheckpointManager(str(tmp_path / "card"), codec_name="int8")
    mgr.save(1, tree)
    assert codec.launches == before + 2
    cpu = CheckpointManager(str(tmp_path / "cpu"), codec_name="int8")
    cpu.save(1, {k: v.cpu() for k, v in tree.items()})
    restored, _ = mgr.restore(tree)
    restored_cpu, _ = cpu.restore({k: v.cpu() for k, v in tree.items()})
    for k in tree:
        assert restored[k].device.type == "cuda" and restored[k].dtype == tree[k].dtype
        assert torch.equal(restored[k].cpu(), restored_cpu[k])


def test_prepare_refuses_grad_inputs_outside_the_function(cuda):
    q = torch.randn((1, 64, 4, 16), device=cuda, requires_grad=True)
    k = torch.randn((1, 64, 2, 16), device=cuda)
    with pytest.raises(RuntimeError, match="outside its autograd Function"):
        flash.prepare(q, k, k)
    with pytest.raises(RuntimeError, match="outside its autograd Function"):
        ssm.prepare(torch.zeros((1, 4, 2, 2), device=cuda, requires_grad=True), torch.zeros((1, 4, 2, 2), device=cuda),
                    torch.zeros((1, 4, 2), device=cuda))
    with pytest.raises(RuntimeError, match="outside its autograd Function"):
        dt_pre, *rest = mamba_inputs_args((1, 4, 8, 4), torch.float32, cuda)
        inputs.prepare(dt_pre.requires_grad_(True), *rest)
    with pytest.raises(RuntimeError, match="outside its autograd Function"):
        rglru.prepare(torch.zeros((1, 4, 2), device=cuda, requires_grad=True), torch.zeros((1, 4, 2), device=cuda))
    with torch.no_grad():
        flash.launch(flash.prepare(q, k, k))


def _grads(fn, inputs, weights):
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward([o for o, w in zip(outs, weights) if w is not None], [w for w in weights if w is not None])
    return [x.grad for x in xs]


def test_gradients_through_the_functions_equal_the_plain_versions(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda)  # noqa: E731
    q, k, v, w = r(2, 100, 8, 64), r(2, 100, 2, 64), r(2, 100, 2, 64), r(2, 100, 8, 64)
    for window in (0, 30):
        kw = dict(causal=True, window=window, q_block=32, kv_block=32)
        before = flash.launches
        got = _grads(lambda *a: flash.flash_attention(*a, **kw), (q, k, v), (w,))
        assert flash.launches == before + 1
        want = _grads(lambda *a: flash_ref.block_attention(*a, **kw), (q, k, v), (w,))
        for g, ww in zip(got, want):
            torch.testing.assert_close(g, ww, rtol=1e-6, atol=1e-6)
    log_a, gx = -torch.nn.functional.softplus(r(2, 33, 40)), r(2, 33, 40)
    weights = (r(2, 33, 40), r(2, 40))
    got = _grads(rglru.rglru_scan, (log_a, gx), weights)
    want = _grads(rglru_ref.rglru_scan, (log_a, gx), weights)
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, rtol=1e-6, atol=1e-6)
    dtA, dBx, C = -torch.nn.functional.softplus(r(2, 21, 8, 4)), r(2, 21, 8, 4), r(2, 21, 4)
    weights = (r(2, 21, 8), None)
    got = _grads(ssm.ssm_scan, (dtA, dBx, C), weights)
    want = _grads(ssm_ref.ssm_scan, (dtA, dBx, C), weights)
    for g, ww in zip(got, want):
        torch.testing.assert_close(g, ww, rtol=1e-6, atol=1e-6)
    args = mamba_inputs_args((2, 21, 40, 16), torch.float32, cuda, seed=9)
    weights = (r(2, 21, 40, 16), r(2, 21, 40, 16))
    before = inputs.launches
    got = _grads(inputs.mamba_inputs, args, weights)
    assert inputs.launches == before + 1
    want = _grads(inputs_ref.mamba_inputs, args, weights)
    for g, ww in zip(got, want):
        assert g is not None and torch.equal(g, ww)


@pytest.mark.parametrize("arch", ["glm4-9b", "recurrentgemma-9b", "falcon-mamba-7b"])
def test_smoke_model_gradients_through_the_kernels(cuda, arch):
    import dataclasses

    from repro_torch.checkpoint import tree as tree_lib
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = T.init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33), generator=gen, device=cuda)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    out = {}
    for impl in (None, "plain"):
        leaves, treedef = tree_lib.flatten(params)
        wrt = [x.detach().requires_grad_(True) for x in leaves]
        loss, _ = T.loss_fn(cfg, treedef.unflatten(wrt), batch, q_block=16, kv_block=16, impl=impl)
        loss.backward()
        out[impl] = (float(loss), [x.grad for x in wrt])
    assert out[None][0] == pytest.approx(out["plain"][0], rel=1e-5)
    for g, gp in zip(out[None][1], out["plain"][1]):
        assert g is not None and bool((g != 0).any())
        scale = float(gp.abs().max())
        assert float((g - gp).abs().max()) <= 1e-4 * scale


# ---------------------------------------------------------------------------
# serving under spot auto-scaling and the suite, on the card
# ---------------------------------------------------------------------------

SERVING_QUICK = dict(base_rps=1200.0, flash_crowds=1, horizon_days=0.25, seeds=(0, 1), bid_margins=(0.5, 1.1),
                     max_spot=8)


@pytest.mark.parametrize("capacity", [None, 12, 4], ids=["uncontended", "capacity_12", "capacity_4"])
def test_serving_batch_engine_on_card_equals_the_cpu_and_reference(cuda, capacity):
    from repro_torch.serving import ServingScenario, run_serving

    sc = ServingScenario(**SERVING_QUICK, capacity=capacity)
    card = run_serving(sc, device=cuda)
    for want in (run_serving(sc, device="cpu"), run_serving(sc, engine="reference")):
        for f in dataclasses.fields(card):
            if f.name not in ("engine", "wall_s"):
                a, b = getattr(card, f.name), getattr(want, f.name)
                assert np.array_equal(a, b, equal_nan=True) if isinstance(a, np.ndarray) else a == b, f.name


def test_serving_under_chaos_on_card_equals_the_cpu(cuda):
    from repro_torch import faults
    from repro_torch.serving import ServingScenario, run_serving

    sc = ServingScenario(**SERVING_QUICK, capacity=6)
    rules = [faults.FaultRule("serving.replica_boot", p=0.3, max_fires=2),
             faults.FaultRule("serving.scale_decision", p=0.2, max_fires=2)]
    with faults.FaultPlan(rules, seed=7) as a:
        card = run_serving(sc, device=cuda)
    with faults.FaultPlan(rules, seed=7) as b:
        cpu = run_serving(sc, device="cpu")
    assert [x.describe() for x in a.log] == [x.describe() for x in b.log] and card.n_boot_lost.sum() > 0
    assert np.array_equal(card.capacity_rps, cpu.capacity_rps) and np.array_equal(card.cost, cpu.cost)


def test_clear_periods_torch_on_card_equals_numpy(cuda):
    from repro_torch.market import MarketParams, clear_periods, clear_periods_torch, marginal_price

    rng = np.random.default_rng(0)
    n, P, cap = 16, 200, 12
    base = np.round(rng.uniform(0.05, 0.6, P), 3)
    free = rng.integers(0, cap + 1, P).astype(np.int64)
    bids = np.round(rng.uniform(0.04, 0.9, n), 3)
    active = rng.random((n, P)) < 0.6
    ladder = marginal_price(base[None, :], free[None, :], np.arange(1, n + 1)[:, None], cap, MarketParams())
    want = clear_periods(bids, active, base, free, cap, MarketParams())
    got = clear_periods_torch(*(torch.from_numpy(x).to(cuda) for x in (bids, active, base, ladder)))
    assert np.array_equal(got[0].cpu().numpy(), want[0]) and np.array_equal(got[1].cpu().numpy(), want[1])


def test_serving_suite_on_card_is_cached_and_verifies(cuda, tmp_path):
    from pathlib import Path

    from repro_torch.suite import RunStore, load_suite, run_suite

    suite = load_suite(Path(__file__).resolve().parents[1] / "examples/suites/serving_diurnal.toml")
    store = RunStore(tmp_path / "store")
    first = run_suite(suite, store, device=cuda)
    with obs.Telemetry() as tel:
        second = run_suite(suite, store, device=cuda)
    assert first.n_misses == second.n_hits == 2 and not tel.find_spans("serving.run")
    assert store.verify(deep=True).ok
