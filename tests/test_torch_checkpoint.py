"""The port's checkpoint manager: the JAX manager's tests, and checkpoints
that move between the packages.

The first part mirrors ``tests/checkpoint/test_manager.py`` and
``test_corruption.py`` on torch trees (atomicity, async errors on ``wait``,
GC, int8, bf16, torn and missing leaves, bad hashes, mangled manifests,
quarantine, both fault sites).  The second part writes a smoke config's whole
training state ``(params, opt_state)`` with one package and restores it with
the other, raw and int8: raw restores equal the saved state bit for bit, and
int8 restores equal what the writing package restores itself (the same
``q * scale`` products).  Raw files are byte-identical across the packages
(same sha256); int8 ``.npz`` files hold the same arrays (zip headers carry a
time stamp, so their hashes differ).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import transformer as JT
from repro_torch import faults
from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointManager
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.configs import get_smoke_config
from repro_torch.faults import FaultPlan, FaultRule, InjectedFault
from repro_torch.kernels.ckpt_codec import kernel as codec_kernel
from repro_torch.models.params import state_from_jax


def _t(x: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dtype)


def _tree(key=0):
    rng = np.random.default_rng(key)
    return {
        "w": _t(rng.standard_normal((64, 32))),
        "b": _t(rng.standard_normal(32), torch.bfloat16),
        "nested": {"step": torch.tensor(7, dtype=torch.int32), "m": _t(rng.standard_normal((8, 8)))},
    }


def f32(x) -> np.ndarray:
    """A leaf of either package as numpy, float leaves widened to float32 (exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "f" or x.dtype.name == "bfloat16" else x


def assert_tree_equal(a, b):
    la, lb = tree_lib.leaves(a), tree_lib.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(f32(x), f32(y))


# ---------------------------------------------------------------------------
# The JAX manager's tests (tests/checkpoint/test_manager.py)
# ---------------------------------------------------------------------------


def test_roundtrip_raw_exact(tmp_path):
    mgr = CheckpointManager(str(tmp_path), codec_name="raw")
    tree = _tree()
    meta = mgr.save(10, tree, {"note": "hello"})
    assert meta.bytes_written > 0
    restored, extra = mgr.restore(tree)
    assert_tree_equal(tree, restored)
    assert extra == {"note": "hello"}
    assert restored["b"].dtype == torch.bfloat16 and restored["nested"]["step"].dtype == torch.int32


def test_roundtrip_int8_bounded_error(tmp_path):
    mgr = CheckpointManager(str(tmp_path), codec_name="int8")
    tree = {"w": _t(np.random.default_rng(0).standard_normal((512, 64)))}
    before = codec_kernel.launches
    mgr.save(1, tree)
    assert codec_kernel.launches == before  # the CPU runs the plain version
    restored, _ = mgr.restore(tree)
    err = (restored["w"] - tree["w"]).abs().max()
    assert err <= tree["w"].abs().max() / 127.0 * 1.01
    raw = CheckpointManager(str(tmp_path) + "_raw", codec_name="raw")
    m_raw = raw.save(1, tree)
    m_q = mgr.save(2, tree)
    assert m_q.bytes_written < 0.4 * m_raw.bytes_written


def test_int8_rule_small_and_integer_leaves_stay_raw(tmp_path):
    mgr = CheckpointManager(str(tmp_path), codec_name="int8")
    tree = {"big": _t(np.ones(1024)), "small": _t(np.ones(1023)), "i": torch.arange(2048, dtype=torch.int32),
            "f64": torch.ones(4096, dtype=torch.float64), "bf": _t(np.ones(1024), torch.bfloat16)}
    mgr.save(1, tree)
    files = json.load(open(os.path.join(str(tmp_path), "step_000000001", "manifest.json")))["files"]
    assert [f["file"][-4:] for f in files] == [".npz", ".npz", ".npy", ".npy", ".npy"]  # bf, big, f64, i, small
    assert [f["dtype"] for f in files] == ["bfloat16", "float32", "float64", "int32", "float32"]
    restored, _ = mgr.restore(tree)
    assert restored["bf"].dtype == torch.bfloat16
    assert_tree_equal(tree, restored)  # ones quantize exactly


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.steps() == [3, 4]


def test_restore_latest_and_specific(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    t1, t2 = _tree(1), _tree(2)
    mgr.save(1, t1)
    mgr.save(2, t2)
    r2, _ = mgr.restore(t1)
    assert_tree_equal(t2, r2)
    r1, _ = mgr.restore(t1, step=1)
    assert_tree_equal(t1, r1)


def test_async_save_is_visible_after_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_io=True)
    tree = _tree()
    mgr.save(5, tree, block=False)
    mgr.wait()
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore(tree)
    assert_tree_equal(tree, restored)


def test_async_snapshot_is_taken_at_save_time(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_io=True)
    tree = _tree()
    want = {k: v.clone() for k, v in tree.items() if k != "nested"}
    mgr.save(5, tree, block=False)
    tree["w"].add_(1.0)  # the caller moves on; the checkpoint keeps the old values
    restored, _ = mgr.restore(tree)
    np.testing.assert_array_equal(restored["w"].numpy(), want["w"].numpy())


def test_torn_checkpoint_is_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    torn = os.path.join(str(tmp_path), "step_000000002.tmp")
    os.makedirs(torn)
    np.save(os.path.join(torn, "leaf_00000"), np.zeros(4))
    assert mgr.steps() == [1]
    mgr2 = CheckpointManager(str(tmp_path))
    assert not os.path.exists(torn)
    restored, _ = mgr2.restore(tree)
    assert_tree_equal(tree, restored)


def test_integrity_check_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    d = os.path.join(str(tmp_path), "step_000000001")
    victim = sorted(f for f in os.listdir(d) if f.startswith("leaf_"))[1]
    with open(os.path.join(d, victim), "r+b") as f:
        f.seek(100)
        f.write(b"\xff\xff\xff")
    with pytest.raises(IOError, match="integrity|sha256"):
        mgr.restore(tree)


def test_restore_onto_a_meta_template_lands_on_the_cpu(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v) for k, v in tree.items()}
    restored, _ = mgr.restore(meta)
    assert restored["w"].device.type == "cpu"
    assert_tree_equal(tree, restored)


def test_structure_mismatch_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    with pytest.raises(ValueError):
        mgr.restore({"only": torch.zeros(2)})


def test_unknown_codec_raises(tmp_path):
    with pytest.raises(ValueError, match="codec"):
        CheckpointManager(str(tmp_path), codec_name="zstd")


# ---------------------------------------------------------------------------
# Corruption (tests/checkpoint/test_corruption.py)
# ---------------------------------------------------------------------------


def _ctree(scale=1.0):
    return {"w": (torch.arange(64, dtype=torch.float32) * scale).reshape(8, 8), "b": torch.arange(8, dtype=torch.float32)}


def _tmpl():
    return {"w": torch.zeros((8, 8)), "b": torch.zeros(8)}


@pytest.fixture
def mgr(tmp_path):
    return CheckpointManager(str(tmp_path / "ckpt"), keep=5)


def test_torn_leaf_raises_corruption_error(mgr):
    mgr.save(1, _ctree(), {"step": 1})
    leaf = os.path.join(mgr.root, "step_000000001", "leaf_00000.npy")
    data = open(leaf, "rb").read()
    open(leaf, "wb").write(data[: len(data) // 2])
    with pytest.raises(CheckpointCorruptionError) as err:
        mgr.restore(_tmpl(), step=1)
    assert err.value.step == 1
    assert "sha256 mismatch" in err.value.reason


def test_missing_leaf_raises_corruption_error(mgr):
    mgr.save(1, _ctree(), {"step": 1})
    os.unlink(os.path.join(mgr.root, "step_000000001", "leaf_00001.npy"))
    with pytest.raises(CheckpointCorruptionError, match="missing leaf"):
        mgr.restore(_tmpl(), step=1)


def test_mangled_manifest_raises_corruption_error(mgr):
    mgr.save(1, _ctree(), {"step": 1})
    m = os.path.join(mgr.root, "step_000000001", "manifest.json")
    open(m, "w").write("{definitely not json")
    with pytest.raises(CheckpointCorruptionError, match="unreadable manifest"):
        mgr.restore(_tmpl(), step=1)


def test_undecodable_leaf_with_a_matching_hash_raises_corruption_error(mgr):
    import hashlib

    mgr.save(1, _ctree(), {"step": 1})
    d = os.path.join(mgr.root, "step_000000001")
    open(os.path.join(d, "leaf_00000.npy"), "wb").write(b"not an npy file")
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    manifest["files"][0]["sha256"] = hashlib.sha256(b"not an npy file").hexdigest()
    json.dump(manifest, open(os.path.join(d, "manifest.json"), "w"))
    with pytest.raises(CheckpointCorruptionError, match="undecodable"):
        mgr.restore(_tmpl(), step=1)


def test_template_mismatch_stays_a_value_error(mgr):
    mgr.save(1, _ctree(), {"step": 1})
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"only": torch.zeros(3)}, step=1)


def test_quarantine_hides_step_and_keeps_evidence(mgr):
    mgr.save(1, _ctree(), {"step": 1})
    mgr.save(2, _ctree(2.0), {"step": 2})
    path = mgr.quarantine(2)
    assert path.endswith(".corrupt") and os.path.isdir(path)
    assert mgr.steps() == [1]
    assert mgr.latest_step() == 1
    _, extra = mgr.restore(_tmpl())
    assert extra["step"] == 1


def test_requarantine_after_resave_replaces_evidence(mgr):
    mgr.save(1, _ctree(), {"step": 1})
    mgr.quarantine(1)
    mgr.save(1, _ctree(2.0), {"step": 1})
    mgr.quarantine(1)
    assert mgr.steps() == []


def test_ckpt_save_raise_fault_surfaces_and_leaves_no_commit(mgr):
    plan = FaultPlan([FaultRule(site="ckpt.save", kind="raise")], seed=0)
    with plan:
        with pytest.raises(InjectedFault):
            mgr.save(1, _ctree(), {"step": 1})
    assert mgr.steps() == []
    mgr.save(1, _ctree(), {"step": 1})
    assert mgr.steps() == [1]


def test_ckpt_save_raise_fault_async_surfaces_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=5, async_io=True)
    plan = FaultPlan([FaultRule(site="ckpt.save", kind="raise")], seed=0)
    with plan:
        mgr.save(1, _ctree(), {"step": 1}, block=False)
        with pytest.raises(InjectedFault):
            mgr.wait()
    mgr.wait()  # the error is consumed, not re-raised forever
    assert mgr.steps() == []


def test_ckpt_save_torn_fault_commits_but_restore_detects(mgr):
    plan = FaultPlan([FaultRule(site="ckpt.save", kind="torn")], seed=0)
    with plan:
        mgr.save(1, _ctree(), {"step": 1})
    assert mgr.steps() == [1]
    with pytest.raises(CheckpointCorruptionError, match="sha256 mismatch"):
        mgr.restore(_tmpl(), step=1)


def test_ckpt_restore_fault_keyed_by_step(mgr):
    mgr.save(1, _ctree(), {"step": 1})
    mgr.save(2, _ctree(2.0), {"step": 2})
    plan = FaultPlan([FaultRule(site="ckpt.restore", key="2")], seed=0)
    with plan:
        with pytest.raises(CheckpointCorruptionError, match="injected"):
            mgr.restore(_tmpl(), step=2)
        tree, extra = mgr.restore(_tmpl(), step=1)
    assert extra["step"] == 1
    np.testing.assert_array_equal(tree["w"].numpy().ravel()[:3], [0, 1, 2])


def test_sync_save_error_does_not_poison_next_save(mgr):
    plan = FaultPlan([FaultRule(site="ckpt.save", kind="raise")], seed=0)
    with plan:
        with pytest.raises(InjectedFault):
            mgr.save(1, _ctree(), {"step": 1})
    assert mgr.save(2, _ctree(), {"step": 2}).step == 2
    mgr.wait()


def test_steps_skips_corrupt_and_tmp_dirs(mgr):
    mgr.save(1, _ctree(), {"step": 1})
    os.makedirs(os.path.join(mgr.root, "step_000000009.tmp"))
    os.makedirs(os.path.join(mgr.root, "step_000000008.corrupt"))
    json.dump({}, open(os.path.join(mgr.root, "step_000000008.corrupt", "manifest.json"), "w"))
    assert mgr.steps() == [1]
    assert faults.current() is faults.NULL


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def jax_state(arch="glm4-9b"):
    """A smoke config's training state in the JAX package's form (bf16
    params from its own init, float32 moments and an int32 step from a seed),
    and the same state carried into the port."""
    jcfg = jax_get_smoke_config(arch)
    params = jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    mu = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    nu = jax.tree.map(lambda p: np.abs(rng.standard_normal(p.shape)).astype(np.float32), params)
    opt = {"mu": mu, "nu": nu, "step": np.asarray(3, np.int32)}
    return (params, opt), state_from_jax(get_smoke_config(arch), params, opt, "cpu")


def manifest(root, step):
    return json.load(open(os.path.join(root, f"step_{step:09d}", "manifest.json")))


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, codec):
    jstate, tstate = jax_state()
    jmgr = JaxCheckpointManager(str(tmp_path), codec_name=codec)
    jmgr.save(4, jstate, {"step": 4, "data": {"step": 4, "seed": 11}})
    mgr = CheckpointManager(str(tmp_path), codec_name=codec)
    restored, extra = mgr.restore(tstate)
    assert extra == {"step": 4, "data": {"step": 4, "seed": 11}}
    jrestored, _ = jmgr.restore(jstate)
    for got, want, orig in zip(tree_lib.leaves(restored), jax.tree.leaves(jrestored), tree_lib.leaves(tstate)):
        assert got.dtype == orig.dtype and tuple(got.shape) == tuple(orig.shape)
        np.testing.assert_array_equal(f32(got), f32(want))
    if codec == "raw":
        assert_tree_equal(restored, tstate)


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_port_checkpoint_restores_in_jax(tmp_path, codec):
    jstate, tstate = jax_state()
    mgr = CheckpointManager(str(tmp_path / "port"), codec_name=codec)
    mgr.save(4, tstate, {"step": 4})
    jmgr = JaxCheckpointManager(str(tmp_path / "port"), codec_name=codec)
    jrestored, extra = jmgr.restore(jstate)
    assert extra == {"step": 4}
    jown = JaxCheckpointManager(str(tmp_path / "jax"), codec_name=codec)
    jown.save(4, jstate, {"step": 4})
    jref, _ = jown.restore(jstate)
    for got, want in zip(jax.tree.leaves(jrestored), jax.tree.leaves(jref)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(f32(got), f32(want))
    # the same manifest, and for raw leaves the same bytes
    mp, mj = manifest(str(tmp_path / "port"), 4), manifest(str(tmp_path / "jax"), 4)
    assert mp.keys() == mj.keys() and mp["treedef"] == mj["treedef"] and mp["codec"] == mj["codec"]
    assert [(f["file"], f["dtype"]) for f in mp["files"]] == [(f["file"], f["dtype"]) for f in mj["files"]]
    for fp, fj in zip(mp["files"], mj["files"]):
        if fp["file"].endswith(".npy"):
            assert fp["sha256"] == fj["sha256"]
        else:
            zp = np.load(os.path.join(str(tmp_path / "port"), "step_000000004", fp["file"]))
            zj = np.load(os.path.join(str(tmp_path / "jax"), "step_000000004", fj["file"]))
            for k in ("q", "scales", "shape"):
                np.testing.assert_array_equal(zp[k], zj[k])


def test_state_from_jax_checks_names_shapes_and_step():
    (params, opt), (tparams, topt) = jax_state()
    assert topt["step"].dtype == torch.int32 and int(topt["step"]) == 3
    assert topt["mu"]["embed.tokens"].dtype == torch.float32
    assert tparams["embed.tokens"].dtype == torch.bfloat16
    bad = dict(opt, step=np.asarray([3], np.int32))
    with pytest.raises(ValueError, match="step"):
        state_from_jax(get_smoke_config("glm4-9b"), params, bad, "cpu")
