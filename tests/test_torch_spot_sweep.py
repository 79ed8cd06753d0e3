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
    """On CPU tensors the op runs the plain version (no kernel runs on the
    CPU) and counts no launch; the kernel wrapper itself refuses them."""
    from repro_torch.kernels.spot_sweep import kernel

    sc, grid, tables = port_grid(small_scenario())
    arrs = ops.device_arrays(grid, torch.device("cpu"), True, True, sc.params.t_r, tables)
    args = (
        sc.schemes, arrs["A"], arrs["B"], arrs["valid"], arrs["horizon"],
        ops.sweep_consts(sc, tables), arrs["ptr0"], arrs["edges"], arrs["tables"],
    )
    before = kernel.launches
    got, info = ops.spot_sweep_grid(sc.schemes, grid, sc, tables, device="cpu")
    done, comp, ckpt, lost, kills = (x.numpy() for x in ref.sweep_plain(*args)[:5])
    assert kernel.launches == before and info["impl"] == "plain"
    for si, s in enumerate(sc.schemes):
        np.testing.assert_array_equal(got[s]["completed"], done[si] & np.isfinite(comp[si]))
        for field, want in (("completion_time", comp), ("n_checkpoints", ckpt), ("n_kills", kills),
                            ("work_lost_s", lost)):
            np.testing.assert_array_equal(got[s][field], want[si], err_msg=f"{s.value}.{field}")
    with pytest.raises(ValueError, match="runs on cuda"):
        kernel.spot_sweep(*args)
    assert kernel.launches == before


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


def test_plain_sweep_walks_a_non_prefix_mask_as_the_tpu_kernel_does():
    """With valid periods after invalid ones, every scheme (ADAPT's
    cell-decoupled walk too) skips the invalid periods, as the Pallas
    kernel's masked period steps do (run in interpret mode)."""
    from repro.core.schemes import Scheme as RefScheme
    from repro.kernels.spot_sweep import kernel as ref_kernel

    __import__("repro.engine.jax_backend", fromlist=["_"])._require_jax()  # float64 in JAX
    rsc = RefScenario.from_trace(
        synthetic_trace(IT, 6, seed=3), 8 * 3600.0, bids=[0.40, 0.41, 0.42, 0.45, 5.0], schemes=REF_SCHEMES
    )
    sc, grid, tables = port_grid(rsc)
    arrs = ops.device_arrays(grid, torch.device("cpu"), True, True, sc.params.t_r, tables)
    holes = torch.from_numpy(np.random.default_rng(0).random(tuple(arrs["valid"].shape)) < 0.3)
    valid = arrs["valid"] & ~holes
    assert bool((valid.int().diff(dim=1) > 0).any())  # a valid period after an invalid one
    consts = ops.sweep_consts(sc, tables)
    want = ref_kernel.sweep_pallas(
        tuple(RefScheme(s.value) for s in sc.schemes), arrs["A"].numpy(), arrs["B"].numpy(), valid.numpy(),
        arrs["horizon"].numpy(), consts, ptr0=arrs["ptr0"].numpy(), edges=tuple(x.numpy() for x in arrs["edges"]),
        tables=tuple(x.numpy() for x in arrs["tables"]), block_c=8, interpret=True,
    )
    got = ref.sweep_plain(sc.schemes, arrs["A"], arrs["B"], valid, arrs["horizon"], consts, arrs["ptr0"],
                          arrs["edges"], arrs["tables"])
    names = ("done", "comp_time", "n_ckpt", "work_lost", "n_kills", "rec_exists", "rec_end", "rec_user")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def sweep_ranges():
    """Edge and table inputs that are in range: 3 cells over 10 edges and 12
    table entries."""
    edges = (torch.zeros(10, dtype=torch.float64), torch.tensor([0, 4, 4]), torch.tensor([4, 6, 6]))
    ptr0 = torch.tensor([[0, 1], [2, 6], [0, 0]])
    tables = (torch.zeros(12, dtype=torch.float64), torch.tensor([0, 3, 7]), torch.tensor([1, 2, 3]))
    return ptr0, edges, tables


def test_range_checks_accept_good_inputs():
    from repro_torch.kernels.spot_sweep import kernel

    ptr0, edges, tables = sweep_ranges()
    assert kernel.out_of_range(ptr0, edges, tables) == []
    assert kernel.out_of_range(ptr0, edges, None) == kernel.out_of_range(None, None, tables) == []
    assert kernel.out_of_range() == []
    empty = (torch.zeros(0, 2, dtype=torch.int64), (edges[0], edges[1][:0], edges[2][:0]),
             (tables[0], tables[1][:0], tables[2][:0]))
    assert kernel.out_of_range(*empty) == []  # no cells: nothing is read


@pytest.mark.parametrize(
    "bad, what",
    [
        (lambda p, e, t: (p - 1, e, t), "edge"),  # a cursor below 0
        (lambda p, e, t: (p, (e[0], e[1] - 1, e[2]), t), "edge"),  # a base below 0
        (lambda p, e, t: (p, (e[0], e[1], e[2] + 1), t), "edge"),  # edges past edges_flat
        (lambda p, e, t: (p, e, (t[0], t[1] - 1, t[2])), "table"),  # an offset below 0
        (lambda p, e, t: (p, e, (t[0], t[1], t[2] - 2)), "table"),  # a top below 0
        (lambda p, e, t: (p, e, (t[0], t[1], t[2] + 1)), "table"),  # entry top + 1 past tab_flat
        (lambda p, e, t: (p - 1, e, (t[0][:11], t[1], t[2])), "both"),
    ],
)
def test_range_checks_reject_bad_cursors_and_offsets(bad, what):
    from repro_torch.kernels.spot_sweep import kernel

    msgs = kernel.out_of_range(*bad(*sweep_ranges()))
    edge = "edge cursors out of range of edges_flat"
    table = "survival-table offsets out of range of tab_flat"
    assert msgs == {"edge": [edge], "table": [table], "both": [edge, table]}[what]
