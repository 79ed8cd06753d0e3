"""The port's spot sweep on the CPU against ``repro``'s.

``repro_torch.kernels.spot_sweep.ops.spot_sweep_grid`` on the CPU runs the
plain PyTorch version of the sweep.  It is held against
``repro.kernels.spot_sweep.ops.spot_sweep_grid`` with ``impl="ref"`` (the
NumPy lockstep evaluation) and ``impl="interpret"`` (the Pallas kernel in interpret
mode, as ``tests/kernels/test_spot_sweep.py`` runs it) on that file's
scenarios, on all six output fields; and its raw ``(finals, records)`` are
held against the traced sweep of ``repro`` (``impl="scan"``).  Every
comparison is exact (``assert_array_equal``): the arithmetic is IEEE
float64 + − × ÷ and compares in the same order, and billing is the same
host fold.
"""

import numpy as np
import pytest
import torch

from repro.core import SimParams as RefSimParams
from repro.core import get_instance, step_trace, synthetic_trace
from repro.engine import BID_LIMITED_SCHEMES as REF_SCHEMES
from repro.engine import Scenario as RefScenario
from repro.engine.batch import grid_and_tables as ref_grid_and_tables
from repro.kernels.spot_sweep import ops as ref_ops

from repro_torch.engine import Scenario
from repro_torch.engine.batch import grid_and_tables
from repro_torch.kernels.spot_sweep import ops, ref

FIELDS = ("completed", "completion_time", "cost", "n_checkpoints", "n_kills", "work_lost_s")
IT = get_instance("m1.xlarge")
DAY = 24 * 3600.0


def small_scenario():
    tr = synthetic_trace(IT, 5, seed=3)
    return RefScenario.from_trace(tr, 6 * 3600.0, bids=[0.34, 0.355, 0.36, 0.37], schemes=REF_SCHEMES)


def resume_extreme_bids():
    """Never-available, always-available and mid-job-resume cells."""
    tr = synthetic_trace(IT, 20, seed=7)
    return RefScenario.from_trace(
        tr,
        30 * 3600.0,
        bids=[0.01, 0.30, 0.345, 0.36, 5.0],
        schemes=REF_SCHEMES,
        initial_saved_work=10 * 3600.0,
        params=RefSimParams(t_c=450.0, t_r=900.0),
    )


def step_trace_edge_cases():
    """Degenerate periods: shorts, censored tails, EDGE cursors."""
    tr = step_trace(
        [(0.0, 0.30), (0.4 * DAY, 0.50), (0.45 * DAY, 0.31), (1.3 * DAY, 0.52),
         (1.35 * DAY, 0.29), (2.0 * DAY, 0.55)],
        horizon_s=3 * DAY,
    )
    return RefScenario.from_trace(tr, 10 * 3600.0, bids=[0.295, 0.32, 0.51], schemes=REF_SCHEMES)


def generated_grid():
    """Two catalog types × three bid fractions × two seeds over ten days."""
    from repro.core import catalog

    return RefScenario.grid(
        work_s=24 * 3600.0, bids=[0.5, 0.55, 0.6], instances=catalog()[:2],
        horizon_days=10.0, seeds=(0, 1), bid_fractions=True,
    )


SCENARIOS = {
    "small": small_scenario,
    "resume_extreme_bids": resume_extreme_bids,
    "step_trace_edges": step_trace_edge_cases,
    "generated_grid": generated_grid,
}


def port_scenario(rsc):
    traces = None if rsc.traces is None else [(t.times, t.prices) for t in rsc.traces]
    return Scenario.from_reference(rsc.canonical(), traces)


def port_grid(rsc):
    sc = port_scenario(rsc)
    grid, tables = grid_and_tables(sc, sc.materialize(), True)
    return sc, grid, tables


@pytest.mark.parametrize(
    "name, impl",
    [(name, "ref") for name in SCENARIOS]
    # the Pallas interpreter steps through every (cell block, period): small grids only
    + [(name, "interpret") for name in ("small", "resume_extreme_bids", "step_trace_edges")],
)
def test_spot_sweep_grid_matches_reference(name, impl):
    rsc = SCENARIOS[name]()
    rgrid, rtables = ref_grid_and_tables(rsc, rsc.materialize(), True)
    want, _ = ref_ops.spot_sweep_grid(rsc.schemes, rgrid, rsc, rtables, impl=impl, block_c=2)
    sc, grid, tables = port_grid(rsc)
    got, info = ops.spot_sweep_grid(sc.schemes, grid, sc, tables, device="cpu")
    assert info["impl"] == "plain"
    assert [s.value for s in got] == [s.value for s in want]
    for (rs, rout), (s, out) in zip(want.items(), got.items()):
        for field in FIELDS:
            np.testing.assert_array_equal(out[field], rout[field], err_msg=f"{s.value}.{field}")


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_plain_sweep_states_and_records_match_traced_sweep(name):
    """The plain sweep's final states and per-period run records equal those
    of ``repro``'s traced sweep, lane for lane (NaN pads included)."""
    rsc = SCENARIOS[name]()
    rgrid, rtables = ref_grid_and_tables(rsc, rsc.materialize(), True)
    schemes = tuple(rsc.schemes)
    jax_mod, jnp, _ = __import__("repro.engine.jax_backend", fromlist=["_"])._require_jax()
    finals, recs = ref_ops._run_device(
        "scan", schemes, rgrid, rsc, rtables, jax_mod, jnp, True, True,
        float(rsc.params.billing_period_s), len(schemes), 256,
    )
    sc, grid, tables = port_grid(rsc)
    arrs = ops.device_arrays(grid, torch.device("cpu"), True, True, sc.params.t_r, tables)
    out = ref.sweep_plain(
        sc.schemes, arrs["A"], arrs["B"], arrs["valid"], arrs["horizon"],
        ops.sweep_consts(sc, tables), arrs["ptr0"], arrs["edges"], arrs["tables"],
    )
    done, comp, ckpt, lost, kills, rex, rend, ruser = (x.numpy() for x in out)
    for si, s in enumerate(schemes):
        for name_, got, want in zip(
            ("done", "comp_time", "n_ckpt", "work_lost", "n_kills"),
            (done[si], comp[si], ckpt[si], lost[si], kills[si]),
            finals[si],
        ):
            np.testing.assert_array_equal(got, want, err_msg=f"{s.value}.{name_}")
        for name_, got, want in zip(
            ("rec_exists", "rec_end", "rec_user"), (rex[si], rend[si], ruser[si]), recs[si]
        ):
            np.testing.assert_array_equal(got, want.T, err_msg=f"{s.value}.{name_}")


def test_kernel_wrapper_runs_plain_version_on_cpu_tensors():
    """``kernel.spot_sweep`` on CPU tensors is the plain version (no kernel
    runs on the CPU), and does not count as a launch."""
    from repro_torch.kernels.spot_sweep import kernel

    sc, grid, tables = port_grid(small_scenario())
    arrs = ops.device_arrays(grid, torch.device("cpu"), True, True, sc.params.t_r, tables)
    args = (
        sc.schemes, arrs["A"], arrs["B"], arrs["valid"], arrs["horizon"],
        ops.sweep_consts(sc, tables), arrs["ptr0"], arrs["edges"], arrs["tables"],
    )
    before = kernel.launches
    got = kernel.spot_sweep(*args)
    want = ref.sweep_plain(*args)
    assert kernel.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w) or torch.allclose(g, w, rtol=0, atol=0, equal_nan=True)


def test_kernel_prepare_refuses_cpu_tensors():
    """Only ``spot_sweep`` runs the plain version on the CPU: preparing a
    kernel launch on CPU tensors raises and counts no launch."""
    from repro_torch.kernels.spot_sweep import kernel

    sc, grid, tables = port_grid(small_scenario())
    arrs = ops.device_arrays(grid, torch.device("cpu"), True, True, sc.params.t_r, tables)
    before = kernel.launches
    with pytest.raises(ValueError, match="runs on cuda"):
        kernel.prepare(
            sc.schemes, arrs["A"], arrs["B"], arrs["valid"], arrs["horizon"],
            ops.sweep_consts(sc, tables), arrs["ptr0"], arrs["edges"], arrs["tables"],
        )
    assert kernel.launches == before


def test_unknown_impl_and_missing_gpu_raise(monkeypatch):
    sc, grid, tables = port_grid(small_scenario())
    with pytest.raises(ValueError, match="impl"):
        ops.spot_sweep_grid(sc.schemes, grid, sc, tables, device="cpu", impl="ref")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.spot_sweep_grid(sc.schemes, grid, sc, tables)
