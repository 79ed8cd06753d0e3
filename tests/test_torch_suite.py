"""The port's suite control plane, on the CPU, against ``repro.suite``.

  * hashing: ``canonical_json`` / ``scenario_hash`` / ``run_key`` of the
    port's scenarios ``==`` ``repro``'s for every cell of
    ``examples/suites/*.toml`` (and of a small fleet suite);
  * layers and specs: the same merges, provenance and expansions; the two
    committed suite files load unchanged;
  * the store in ``repro``'s format: round trips bit for bit, sha256
    integrity, ``verify(repair=, deep=)``, ``gc``, ``parity``, and the fault
    sites ``store.payload_write`` / ``store.index_append``;
  * the runner: resume, all hits, ``max_cells``, retries and the
    ``suite.worker`` site, honest engine ids, the device resolved before
    any simulation (no quiet fallback to the CPU);
  * trend and the CLI (``python -m repro_torch.suite``);
  * the cross-package check: ``serving_diurnal.toml``, a small fleet suite
    and a cut of ``paper_fig7.toml`` through both packages into two stores;
    ``verify --parity`` finds no mismatch on the shared keys (every serving
    and fleet cell is shared), and the sweep cells — keyed ``"batch"`` by
    ``repro`` and ``"torch"`` by the port — paired by scenario hash have
    equal payload arrays and equal headers but the engine id and the wall
    fields.
"""

import io
import json
import pathlib
import textwrap

import numpy as np
import pytest
import torch

from repro import faults as ref_faults
from repro.suite import RunStore as RefRunStore
from repro.suite import load_suite as ref_load_suite
from repro.suite import layers as ref_layers
from repro.suite import run_key as ref_run_key
from repro.suite import run_suite as ref_run_suite
from repro.suite import scenario_hash as ref_scenario_hash
from repro.suite.hashing import SCHEMA_VERSION as REF_SCHEMA_VERSION
from repro.suite.hashing import canonical_json as ref_canonical_json

from repro_torch import faults, obs
from repro_torch.core import get_instance
from repro_torch.engine import FleetScenario, Scenario, run
from repro_torch.serving import ServingScenario, run_serving
from repro_torch.suite import (
    SCHEMA_VERSION,
    Layer,
    RetryPolicy,
    RunStore,
    StoreCorruptionError,
    build_scenario,
    canonical_json,
    compute_trends,
    load_suite,
    merge_layers,
    parse_override,
    render_trends,
    run_fleet_stored,
    run_key,
    run_serving_stored,
    run_stored,
    run_suite,
    scenario_hash,
)
from repro_torch.suite import layers
from repro_torch.suite.__main__ import main as suite_main
from repro_torch.suite.runner import _engine_id
from repro_torch.suite.store import _comparable_header

ROOT = pathlib.Path(__file__).resolve().parents[1]
SUITES = sorted((ROOT / "examples/suites").glob("*.toml"))

TINY = """
    [suite]
    name = "tiny"
    kind = "scenario"
    engine = "auto"

    [base]
    work_s = 1800.0
    instances = ["m1.xlarge/eu-west-1"]
    bids = [0.4, 0.45]
    horizon_days = 2.0

    [axes]
    schemes = ["opt", "hour"]
    seeds = [0, 1]
"""

FLEET = """
    [suite]
    name = "fleet_small"
    kind = "fleet"

    [base]
    n_jobs = 6
    mean_interarrival_s = 1800.0
    mean_work_h = 3.0
    horizon_days = 3.0
    n_types = 4
    seeds = [0]
    bid_margins = [0.56]
    policies = ["algorithm1", "cost_greedy"]

    [axes]
    scheme = ["hour", "acc"]
    capacity = ["none", 3]
"""

SERVING = """
    [suite]
    name = "serving_small"
    kind = "serving"

    [base]
    base_rps = 1200.0
    flash_crowds = 1
    horizon_days = 0.25
    seeds = [0, 1]
    bid_margins = [0.5, 1.1]
    max_spot = 8

    [axes]
    capacity = ["none", 6]
"""


def write(tmp_path, text, name) -> pathlib.Path:
    p = tmp_path / name
    p.write_text(textwrap.dedent(text))
    return p


@pytest.fixture
def tiny(tmp_path):
    return load_suite(write(tmp_path, TINY, "tiny.toml"))


@pytest.fixture
def serving_suite(tmp_path):
    return load_suite(write(tmp_path, SERVING, "serving.toml"))


def tiny_scenario(seed=0) -> Scenario:
    return Scenario(work_s=1800.0, bids=(0.4,), instances=(get_instance("m1.xlarge", "eu-west-1"),),
                    horizon_days=2.0, seeds=(seed,))


# ---------------------------------------------------------------------------
# hashing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", SUITES + ["fleet"], ids=lambda p: getattr(p, "name", p))
def test_every_cell_hashes_as_the_reference(tmp_path, path):
    if path == "fleet":
        path = write(tmp_path, FLEET, "fleet.toml")
    ours, theirs = load_suite(path).expand(), ref_load_suite(path).expand()
    assert len(ours) == len(theirs) > 1
    for a, b in zip(ours, theirs):
        assert (a.label, a.kind, a.engine) == (b.label, b.kind, b.engine)
        assert a.scenario.canonical() == b.scenario.canonical()
        assert canonical_json(a.scenario.canonical()) == ref_canonical_json(b.scenario.canonical())
        assert scenario_hash(a.scenario) == ref_scenario_hash(b.scenario)
        for eng in ("batch", "fleet", "torch"):
            assert run_key(a.scenario, eng) == ref_run_key(b.scenario, eng)
    assert SCHEMA_VERSION == REF_SCHEMA_VERSION


def test_hash_invariants():
    a = Scenario(work_s=1800.0, bids=(0.4,), instances=(get_instance("m1.xlarge"),), horizon_days=2.0)
    assert scenario_hash(a) == scenario_hash(a.canonical()) == scenario_hash(tiny_scenario())
    assert scenario_hash(tiny_scenario(1)) != scenario_hash(tiny_scenario(0))
    assert run_key(a, "torch") != run_key(a, "batch") != run_key(a, "batch", schema_version=2)
    assert canonical_json({"b": 1, "a": [1.5, None]}) == canonical_json({"a": [1.5, None], "b": 1})
    s = ServingScenario()
    assert scenario_hash(s) != scenario_hash(ServingScenario(max_spot=63))
    assert scenario_hash(FleetScenario()) != scenario_hash(FleetScenario(n_jobs=11))


# ---------------------------------------------------------------------------
# layers and specs
# ---------------------------------------------------------------------------

LAYER_CASES = [
    [Layer("base", {"a": 1, "t": {"x": 1, "y": 2}}), Layer("cell", {"t": {"y": 3}}), Layer("cli", {"a": 4})],
    [Layer("base", {"l": [1, 2], "t": {"x": 1}}), Layer("suite", {"l": [3]})],
    [Layer("base", {"t": {"x": 1, "y": 2}}), Layer("cell", {"t": 5})],
    [Layer("base", {"t": 5}), Layer("cell", {"t": {"x": 1}})],
]


@pytest.mark.parametrize("case", range(len(LAYER_CASES)))
def test_merge_layers_equals_the_reference(case):
    stack = LAYER_CASES[case]
    got = merge_layers(stack)
    want = ref_layers.merge_layers([ref_layers.Layer(lay.name, lay.values) for lay in stack])
    assert got.values == want.values and got.provenance == want.provenance
    assert got.origin("nope") == "default"


def test_overrides_and_dotted_keys():
    for item in ("scheme=hour", "params.t_c=120", "bids=[0.4, 0.5]", "capacity=none"):
        assert parse_override(item) == ref_layers.parse_override(item)
    assert layers.nest_dotted({"params.t_c": 120, "a": 1}) == {"params": {"t_c": 120}, "a": 1}
    with pytest.raises(ValueError):
        layers.nest_dotted({"a": 1, "a.b": 2})
    with pytest.raises(ValueError):
        parse_override("no-equals")


def test_specs_expand_build_and_reject(tmp_path):
    suite = load_suite(ROOT / "examples/suites/serving_diurnal.toml")
    cells = suite.expand({"max_spot": 8})
    assert [c.label for c in cells] == ["capacity=none", "capacity=12"]
    assert all(isinstance(c.scenario, ServingScenario) and c.scenario.max_spot == 8 for c in cells)
    assert cells[0].resolved.origin("max_spot") == "cli" and cells[1].resolved.origin("capacity") == "cell"
    assert "max_spot = 8  <- cli" in cells[0].describe()
    fig7 = load_suite(ROOT / "examples/suites/paper_fig7.toml")
    assert fig7.n_cells == 6 and all(isinstance(c.scenario, Scenario) for c in fig7.expand())
    with pytest.raises(ValueError, match="unknown serving keys"):
        build_scenario("serving", {"warp": 1})
    with pytest.raises(ValueError, match="unknown suite kind"):
        build_scenario("batch", {})
    with pytest.raises(ValueError, match="needs"):
        build_scenario("scenario", {"work_s": 1.0})
    p = write(tmp_path, '[suite]\nname = "c"\nextends = "c.toml"\n', "c.toml")
    with pytest.raises(ValueError, match="cycle"):
        load_suite(p)
    j = tmp_path / "s.json"
    j.write_text(json.dumps({"suite": {"kind": "fleet"}, "base": {"n_jobs": 3}}))
    assert isinstance(load_suite(j).expand()[0].scenario, FleetScenario)


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def test_engine_round_trip_bit_for_bit(tmp_path):
    sc = tiny_scenario()
    res = run(sc, device="cpu")
    store = RunStore(tmp_path / "store")
    rec = store.put_engine_result(sc, res)
    assert rec.engine == "torch" and rec.kind == "scenario" and rec.sha256 is not None
    back = RunStore(tmp_path / "store").load(rec.run_key, scenario=sc)
    for name in ("completed", "completion_time", "cost", "n_checkpoints", "n_kills", "n_self_terminations",
                 "work_lost_s"):
        assert np.array_equal(getattr(back, name), getattr(res, name))
    assert back.timings == res.timings and back.bids == res.bids and back.schemes == res.schemes
    row = json.loads((tmp_path / "store/index.jsonl").read_text().splitlines()[0])
    assert row["run_key"] == rec.run_key and row["scenario_hash"] == scenario_hash(sc)


def test_serving_round_trip_and_reference_payload_load(tmp_path, serving_suite):
    sc = serving_suite.expand()[1].scenario
    res = run_serving(sc, device="cpu")
    store = RunStore(tmp_path / "store")
    rec = store.put_serving_result(sc, res, suite="s", cell="c")
    back = store.load(rec.run_key)
    for name in ("availability", "cost_per_mreq", "capacity_rps", "spot_price", "rates", "n_preempted"):
        assert np.array_equal(getattr(back, name), getattr(res, name), equal_nan=True)
    assert (back.engine, back.policies, back.seeds) == ("batch", res.policies, res.seeds)
    # the port reads a store the JAX package wrote
    ref_store_dir = tmp_path / "ref"
    ref_run_suite(ref_load_suite(serving_suite.path), RefRunStore(ref_store_dir))
    ref_store = RunStore(ref_store_dir)
    theirs = ref_store.load(rec.run_key)
    assert np.array_equal(theirs.spot_price, res.spot_price) and theirs.engine == "batch"


def test_fleet_round_trip_preserves_records(tmp_path):
    sc = load_suite(write(tmp_path, FLEET, "fleet.toml")).expand()[0].scenario
    grid, hit = run_fleet_stored(sc, RunStore(tmp_path / "store"))
    assert not hit
    back, hit = run_fleet_stored(sc, RunStore(tmp_path / "store"))
    assert hit and list(back.results) == list(grid.results)
    for key, res in grid.results.items():
        got = back.results[key]
        assert [dataclass_tuple(r) for r in got.records] == [dataclass_tuple(r) for r in res.records]
        for j, o in res.outcomes.items():
            assert all(a is b for a, b in zip(got.outcomes[j].attempts,
                                              [got.records[res.records.index(r)] for r in o.attempts]))


def dataclass_tuple(r):
    import dataclasses

    return tuple(getattr(r, f.name) for f in dataclasses.fields(r))


def populate(store_dir, seeds=(0, 1)):
    store = RunStore(store_dir)
    recs = [store.put_engine_result(tiny_scenario(s), run(tiny_scenario(s), device="cpu")) for s in seeds]
    return store, recs


def test_integrity_typed_errors_and_self_heal(tmp_path):
    store, (rec, rec2) = populate(tmp_path / "store")
    path = tmp_path / "store" / rec.payload
    path.write_bytes(path.read_bytes()[:100])
    with pytest.raises(StoreCorruptionError) as e:
        store.load(rec.run_key)
    assert e.value.run_key == rec.run_key and "checksum" in e.value.reason
    with obs.Telemetry() as tel:
        res, hit = run_stored(tiny_scenario(0), store, device="cpu")
    assert not hit and tel.counter("store.corrupt_hits") == 1
    assert RunStore(tmp_path / "store").load(rec.run_key).cost.shape == res.cost.shape
    (tmp_path / "store" / rec2.payload).unlink()
    assert not store.has(rec2.run_key)
    with pytest.raises(StoreCorruptionError, match="unreadable"):
        store.load(rec2.run_key)


def test_verify_repair_quarantines_and_gc_reclaims(tmp_path):
    store, (rec, rec2) = populate(tmp_path / "store")
    assert store.verify().ok and store.verify(deep=True).n_ok == 2
    path = tmp_path / "store" / rec.payload
    path.write_bytes(path.read_bytes()[:-7])
    stats = store.verify()
    assert not stats.ok and [k for k, _ in stats.corrupt] == [rec.run_key]
    with obs.Telemetry() as tel:
        fixed = store.verify(repair=True)
    assert fixed.quarantined == [f"quarantine/{rec.run_key}.npz"] and tel.counter("store.quarantined") == 1
    assert store.verify().ok and len(RunStore(tmp_path / "store")) == 1
    store.put_engine_result(tiny_scenario(1), run(tiny_scenario(1), device="cpu"))  # supersedes rec2's line
    (tmp_path / "store/runs/stale.tmp.npz").write_bytes(b"x" * 10)
    dry = store.gc(dry_run=True)
    assert dry.index_lines_before == 2 and dry.index_lines_after == 1  # repair rewrote the index to one line
    stats = store.gc()
    assert stats.payloads_deleted == ["runs/stale.tmp.npz"] and stats.bytes_reclaimed > 0
    assert len((tmp_path / "store/index.jsonl").read_text().splitlines()) == 1


def test_store_fault_sites(tmp_path):
    assert {"store.payload_write", "store.index_append", "suite.worker"} <= set(faults.SITES)
    for site in ("store.payload_write", "store.index_append", "suite.worker"):
        assert faults.SITES[site] == ref_faults.SITES[site]
    sc = tiny_scenario()
    res = run(sc, device="cpu")
    store = RunStore(tmp_path / "store")
    with faults.FaultPlan([faults.FaultRule("store.payload_write", kind="raise")], seed=0):
        with pytest.raises(faults.InjectedFault):
            store.put_engine_result(sc, res)
    assert len(store) == 0 and list((tmp_path / "store/runs").glob("*.tmp.npz"))
    with faults.FaultPlan([faults.FaultRule("store.payload_write", kind="torn")], seed=0):
        rec = store.put_engine_result(sc, res)  # silent: only the checksum tells
    assert not store.verify().ok
    store.verify(repair=True)
    with faults.FaultPlan([faults.FaultRule("store.index_append")], seed=0):
        with pytest.raises(faults.InjectedFault):
            store.put_engine_result(sc, res)
    assert not store.has(rec.run_key) and (tmp_path / "store" / rec.payload).exists()
    assert store.gc().payloads_deleted  # the orphaned payload and the stale tmp


def test_parity_finds_divergence(tmp_path):
    a, (rec,) = populate(tmp_path / "a", seeds=(0,))
    b, _ = populate(tmp_path / "b", seeds=(0,))
    assert a.parity(b) == {}
    z = dict(np.load(io.BytesIO((tmp_path / "b" / rec.payload).read_bytes())))
    z["cost"] = z["cost"] + 1.0
    buf = io.BytesIO()
    np.savez_compressed(buf, **z)
    (tmp_path / "b" / rec.payload).write_bytes(buf.getvalue())
    b.reload()
    assert "checksum" in a.parity(b)[rec.run_key]
    row = json.loads((tmp_path / "b/index.jsonl").read_text())
    row["sha256"] = None
    (tmp_path / "b/index.jsonl").write_text(json.dumps(row) + "\n")
    b.reload()
    assert a.parity(b) == {rec.run_key: "array 'cost' differs"}


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def test_second_pass_is_all_hits_and_resume_runs_only_missing(tmp_path, tiny):
    store = RunStore(tmp_path / "store")
    with obs.Telemetry() as tel:
        first = run_suite(tiny, store, max_cells=3, device="cpu")
    assert (first.n_misses, first.n_skipped) == (3, 1) and len(tel.find_spans("engine.run")) == 3
    assert {o.record.engine for o in first.outcomes} == {"torch"}
    with obs.Telemetry() as tel:
        second = run_suite(tiny, store, device="cpu")
    assert (second.n_hits, second.n_misses) == (3, 1)
    with obs.Telemetry() as tel:
        third = run_suite(tiny, store)  # nothing to simulate: no device needed
    assert third.n_hits == 4 and tel.counter("suite.cache_hit") == 4 and not tel.find_spans("engine.run")
    assert "4 cache hits, 0 simulated" in third.summary()


@pytest.mark.parametrize("jobs", [1, 3])
def test_crashing_cell_does_not_abort_the_pass(tmp_path, tiny, jobs):
    store = RunStore(tmp_path / "store")
    target = tiny.expand()[1]
    key = run_key(target.scenario, "torch")
    plan = faults.FaultPlan([faults.FaultRule("suite.worker", key=key, max_fires=5)], seed=0)
    with plan, obs.Telemetry() as tel:
        rep = run_suite(tiny, store, jobs=jobs, retry=RetryPolicy(max_attempts=2, backoff_base_s=0.0),
                        device="cpu")
    assert rep.n_failed == 1 and rep.failures[0].cell.label == target.label and rep.failures[0].attempts == 2
    assert rep.n_misses == 3 and tel.counter("retry.attempts") == 1 and not rep.ok
    healed = run_suite(tiny, store, device="cpu")
    assert (healed.n_hits, healed.n_misses) == (3, 1)
    assert RetryPolicy().backoff_s(key, 3) == RetryPolicy().backoff_s(key, 3) <= RetryPolicy().backoff_cap_s


def test_transient_faults_recover_and_store_writes_retry(tmp_path, tiny):
    store = RunStore(tmp_path / "store")
    rules = [faults.FaultRule("suite.worker", p=1.0, max_fires=1),
             faults.FaultRule("store.payload_write", kind="raise", p=1.0, max_fires=1)]
    with faults.FaultPlan(rules, seed=3):
        rep = run_suite(tiny, store, retry=RetryPolicy(backoff_base_s=0.0), device="cpu")
    assert rep.ok and rep.n_misses == 4 and all(o.attempts == 2 for o in rep.outcomes)
    assert store.verify().ok


def test_device_is_resolved_before_simulating(tmp_path, tiny, serving_suite, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_suite(tiny, RunStore(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_suite(serving_suite, RunStore(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_stored(tiny_scenario(), RunStore(tmp_path / "c"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_serving_stored(serving_suite.expand()[0].scenario, RunStore(tmp_path / "d"))
    # host engines take no device: the scalar reference, the fleet controller
    rep = run_suite(serving_suite, RunStore(tmp_path / "e"), engine="reference")
    assert rep.ok and {o.record.engine for o in rep.outcomes} == {"reference"}
    res, hit = run_stored(tiny_scenario(), RunStore(tmp_path / "f"), engine="reference")
    assert not hit and res.engine == "reference"


def test_engine_ids_are_honest():
    assert _engine_id("scenario", "auto") == "torch" and _engine_id("scenario", "reference") == "reference"
    assert _engine_id("serving", "auto") == "batch" and _engine_id("serving", "reference") == "reference"
    assert _engine_id("fleet", "auto") == "fleet"


def test_serving_stored_and_the_reference_engine_share_nothing(tmp_path, serving_suite):
    sc = serving_suite.expand()[0].scenario
    store = RunStore(tmp_path / "store")
    a, hit_a = run_serving_stored(sc, store, device="cpu")
    b, hit_b = run_serving_stored(sc, store, device="cpu")
    c, hit_c = run_serving_stored(sc, store, engine="reference")
    assert (hit_a, hit_b, hit_c) == (False, True, False) and len(store) == 2
    assert np.array_equal(a.capacity_rps, c.capacity_rps) and b.engine == "batch" and c.engine == "reference"


# ---------------------------------------------------------------------------
# trend and the CLI
# ---------------------------------------------------------------------------


def test_trend_groups_runs_and_reports_drift(tmp_path):
    store, _ = populate(tmp_path / "store", seeds=(0,))
    store.put_engine_result(tiny_scenario(0), run(tiny_scenario(0), device="cpu"), sha="f" * 40)
    hist = tmp_path / "hist.jsonl"
    hist.write_text(json.dumps({"sha": "f" * 40, "backends": {"batch": {"speedup": 12.5}}}) + "\nnot json\n")
    groups = compute_trends(RunStore(tmp_path / "store").records())
    assert len(groups) == 1 and len(groups[0].runs) == 1  # the same key: last line wins
    store2, _ = populate(tmp_path / "s2", seeds=(0,))
    run_stored(tiny_scenario(0), store2, engine="reference")
    groups = compute_trends(store2.records())
    assert sorted(g.engine for g in groups) == ["reference", "torch"]
    text = render_trends(groups)
    assert text.startswith("# trend: 2 scenario identities") and "single run" in text
    assert suite_main(["trend", "--store", str(tmp_path / "store"), "--history", str(hist), "--json"]) == 0


def test_cli_run_verify_gc_list_and_parity(tmp_path, capsys):
    path = str(ROOT / "examples/suites/serving_diurnal.toml")
    store = str(tmp_path / "store")
    assert suite_main(["run", path, "--dry-run"]) == 0
    assert "2 cells (dry run" in capsys.readouterr().out
    assert suite_main(["run", path, "--store", store, "--device", "cpu", "--set", "max_spot=8",
                       "--expect-all-hits"]) == 1
    assert suite_main(["run", path, "--store", store, "--device", "cpu", "--set", "max_spot=8",
                       "--expect-all-hits"]) == 0
    assert "2 cache hits, 0 simulated" in capsys.readouterr().out
    assert suite_main(["verify", "--store", store, "--deep"]) == 0
    assert suite_main(["list", "--store", store]) == 0
    assert suite_main(["gc", "--store", store, "--dry-run"]) == 0
    ref_dir = tmp_path / "ref"
    ref_run_suite(ref_load_suite(path), RefRunStore(ref_dir), cli={"max_spot": 8})
    capsys.readouterr()
    assert suite_main(["verify", "--store", store, "--parity", str(ref_dir)]) == 0
    assert "2 shared runs bit-identical" in capsys.readouterr().out
    rec = RunStore(store).records()[0]
    p = pathlib.Path(store) / rec.payload
    p.write_bytes(p.read_bytes()[:50])
    assert suite_main(["verify", "--store", store]) == 1
    assert suite_main(["verify", "--store", store, "--repair"]) == 0
    assert suite_main(["run", path, "--store", store, "--device", "cpu", "--set", "max_spot=8"]) == 0
    assert "1 cache hits, 1 simulated" in capsys.readouterr().out


def test_cli_run_exits_nonzero_on_failed_cells(tmp_path, capsys, monkeypatch):
    schedule = tmp_path / "chaos.json"
    schedule.write_text(json.dumps({"seed": 1, "rules": [{"site": "suite.worker", "p": 1.0, "max_fires": 9}]}))
    monkeypatch.setenv(faults.ENV_VAR, str(schedule))
    path = write(tmp_path, SERVING, "serving.toml")
    assert suite_main(["run", str(path), "--store", str(tmp_path / "s"), "--device", "cpu", "--retries", "1"]) == 1
    assert "2 FAILED" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the cross-package check
# ---------------------------------------------------------------------------


def test_cross_package_stores_agree(tmp_path):
    mine, theirs = RunStore(tmp_path / "port"), RefRunStore(tmp_path / "ref")
    suites = [ROOT / "examples/suites/serving_diurnal.toml", write(tmp_path, FLEET, "fleet.toml"),
              ROOT / "examples/suites/paper_fig7.toml"]
    for path in suites:
        cut = 3 if path.name == "paper_fig7.toml" else None
        assert run_suite(load_suite(path), mine, max_cells=cut, device="cpu").ok
        assert ref_run_suite(ref_load_suite(path), theirs, max_cells=cut).ok
    mine.reload()
    ours, refs = mine.records(), RunStore(tmp_path / "ref").records()
    shared = {r.run_key for r in ours} & {r.run_key for r in refs}
    kinds = {r.kind for r in ours if r.run_key in shared}
    assert kinds == {"serving", "fleet"} and len(shared) == 2 + 4
    assert all(r.run_key in shared for r in ours if r.kind in ("serving", "fleet"))
    assert mine.parity(RunStore(tmp_path / "ref")) == {}
    assert RunStore(tmp_path / "ref").verify(deep=True).n_ok == len(refs)  # the port decodes repro's payloads
    # the sweep cells: "torch" here, "batch" there; paired by scenario hash
    by_hash = {r.scenario_hash: r for r in refs if r.kind == "scenario"}
    pairs = [(r, by_hash[r.scenario_hash]) for r in ours if r.kind == "scenario"]
    assert len(pairs) == 3 and all((a.engine, b.engine) == ("torch", "batch") for a, b in pairs)
    for a, b in pairs:
        za = dict(np.load(io.BytesIO((tmp_path / "port" / a.payload).read_bytes())))
        zb = dict(np.load(io.BytesIO((tmp_path / "ref" / b.payload).read_bytes())))
        assert set(za) == set(zb)
        for name in za:
            if name == "header":
                ha, hb = _comparable_header(za[name]), _comparable_header(zb[name])
                assert (ha.pop("engine"), hb.pop("engine")) == ("torch", "batch")
                assert ha == hb
            else:
                assert za[name].dtype == zb[name].dtype and np.array_equal(za[name], zb[name]), name
        assert a.metrics == b.metrics and a.n_cells == b.n_cells
