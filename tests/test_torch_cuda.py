"""The CUDA spot-sweep kernel against its plain PyTorch version, on the card.

Marked ``cuda``: every test needs a CUDA device and ``nvcc`` and skips
without them (so on a CPU-only machine).  On the card the kernel is
built from ``src/repro_torch/kernels/spot_sweep/csrc/spot_sweep.cu`` and each
of its outputs must equal the plain version's bit for bit (NaN pads
included): both do the same IEEE float64 + − × ÷ and compares, and the
kernel is built with ``--fmad=false``.  Run them on the card with
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import HOUR, SimParams, catalog, get_instance, step_trace, synthetic_trace
from repro_torch.engine import BID_LIMITED_SCHEMES, Scenario, TorchEngine
from repro_torch.engine.batch import grid_and_tables
from repro_torch.kernels import _build
from repro_torch.kernels.spot_sweep import kernel, ops, ref

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
