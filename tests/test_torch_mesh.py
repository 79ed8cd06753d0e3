"""Mesh-placed execution on the CPU: ``loss_fn`` and its gradients on DTensor-placed
parameters and batches, against the single process and against JAX.

The smoke configs of glm4-9b, recurrentgemma-9b and falcon-mamba-7b in float32,
the JAX package's init carried across (``from_jax``), one batch from a seed,
on 8 gloo ranks at ``(2, 4)`` ``data x model`` and ``(2, 2, 2)`` ``pod x data
x model``, the parameters placed by ``shard_params`` and the batch by
``("batch", "seq")``.  Tolerances: the loss within 1e-5 relative, and each
leaf's gradient within 1e-4 of that leaf's largest reference gradient (the
placed run sums in other orders: split matmuls, the collectives).  At ``(2,
4)`` glm4-9b's 2 kv heads cannot split over 4 ranks while its 4 q heads do:
each rank's q head must meet its own kv head (the GQA trap).

Also: every gradient comes back with its parameter's placements; taken
without its redistribution (each rank's raw gradient read as its shard) the
data-parallel gradients miss the bound; ``shard`` leaves plain tensors
alone; the families not ported to placed tensors raise; the checkpoint
restores onto a ``(1,)`` mesh's placements; a failed write on rank 0 alone
raises on every rank; ``make_compat_mesh`` refuses a card that is not
there; and the all-gather built on gloo's ``all_reduce`` gives gloo's own
bits, while a group of another backend keeps its own all-gather.
"""

import dataclasses
import functools
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_mesh_ranks as mesh_ranks
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import transformer as JT
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax
from repro_torch.parallel import sharding as S
from repro_torch.parallel.ranks import run_ranks

ARCHS = ("glm4-9b", "recurrentgemma-9b", "falcon-mamba-7b")
MESHES = {"2x4": (2, 4), "2x2x2": (2, 2, 2)}
SEQ, BLOCK, BATCH = 16, 8, 4
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


@functools.cache
def case(arch):
    """(jax config, port config, the JAX package's float32 init as numpy, a batch)."""
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    with jax.enable_x64(False):  # the JAX package's default types, whatever another test set
        params = jax.tree.map(np.asarray, jax.jit(JT.init_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    labels = tokens[:, 1:].copy()
    labels[0, 3] = -100  # ignored by all
    return jcfg, cfg, params, {"tokens": tokens[:, :-1], "labels": labels}


@functools.cache
def references(arch):
    """The single-process port's and JAX's loss and gradients (flatten order)."""
    jcfg, cfg, jparams, batch = case(arch)
    with jax.enable_x64(False):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: JT.loss_fn(jcfg, p, b, q_block=BLOCK, kv_block=BLOCK)[0]))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    params = from_jax(cfg, jparams, "cpu")
    leaves, treedef = tree_lib.flatten(params)
    wrt = [x.detach().requires_grad_(True) for x in leaves]
    loss, _ = T.loss_fn(cfg, treedef.unflatten(wrt), {k: torch.as_tensor(v) for k, v in batch.items()},
                        q_block=BLOCK, kv_block=BLOCK, device="cpu")
    grads = torch.autograd.grad(loss, wrt)
    return {"port": (float(loss.detach()), [g.numpy() for g in grads]),
            "jax": (float(jloss), [np.asarray(g, np.float32) for g in jax.tree.leaves(jgrads)])}


@functools.cache
def placed(mesh):
    """Every arch's placed loss and gradients, from one spawn of 8 ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cases.pt"
        torch.save({arch: {"cfg": case(arch)[1], "params": case(arch)[2], "batch": case(arch)[3], "block": BLOCK}
                    for arch in ARCHS}, path)
        ranks = run_ranks(mesh_ranks.grads_rank, int(np.prod(MESHES[mesh])), str(path), MESHES[mesh])
    for r in ranks[1:]:  # every rank holds the same whole values
        for arch in ARCHS:
            assert r[arch]["loss"] == ranks[0][arch]["loss"]
    return ranks[0]


def rel_err(got, want) -> float:
    return float(np.abs(np.asarray(got, np.float32) - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_loss_and_gradients_match_the_single_process_and_jax(arch, mesh):
    got = placed(mesh)[arch]
    assert all(got["same_placements"]), "a gradient came back with other placements than its parameter's"
    for which, (loss, grads) in references(arch).items():
        assert abs(got["loss"] - loss) <= LOSS_RTOL * abs(loss), (which, got["loss"], loss)
        assert len(grads) == len(got["grads"])
        for name, g, want in zip(got["names"], got["grads"], grads):
            assert rel_err(g.numpy(), want) <= GRAD_TOL, (which, name, rel_err(g.numpy(), want))


@pytest.mark.parametrize("mesh", MESHES)
def test_gradients_without_the_redistribution_miss_the_bound(mesh):
    """Mutation check: each rank's raw gradient read as its shard of the
    parameter (the step without the data-parallel all-reduce)."""
    for arch in ARCHS:
        got = placed(mesh)[arch]
        _, want = references(arch)["port"]
        errs = {name: rel_err(g.numpy(), w) for name, g, w in zip(got["names"], got["raw_grads"], want)
                if g is not None}
        # the leaves whole on the data axes (the embeddings, the norms) miss the bound
        assert errs["embed.tokens"] > GRAD_TOL and errs["final_norm.scale"] > GRAD_TOL, (arch, errs)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        yield S.make_compat_mesh((1,), ("data",), device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_shard_leaves_plain_tensors_alone(one_rank):
    x = torch.randn(4, 6)
    with S.use_compat_mesh(one_rank):
        assert S.shard(x, "batch", "embed") is x
    assert S.shard(x, "batch", "embed") is x


def test_shard_places_a_dtensor_by_its_logical_axes(one_rank):
    from torch.distributed.tensor import Replicate, Shard

    with S.use_compat_mesh(one_rank):
        x = S.place(torch.randn(4, 6), one_rank, (Replicate(),))
        y = S.shard(x, "batch", "embed")  # batch -> data
        assert tuple(y.placements) == (Shard(0),) and torch.equal(S.gather(y), S.gather(x))


@pytest.mark.parametrize("arch", ["arctic-480b", "whisper-large-v3", "internvl2-1b"])
def test_families_not_ported_to_placed_tensors_raise(one_rank, arch):
    cfg = get_smoke_config(arch)
    params = T.init_params(cfg, 0, device="cpu")
    with S.use_compat_mesh(one_rank):
        pp = S.place(params, one_rank, S.shard_params(one_rank, T.param_axes(cfg), abstract_tree=params))
        tokens = S.place(torch.zeros((2, 8), dtype=torch.int64), one_rank,
                         S.logical_sharding(one_rank, ("batch", "seq")))
        with pytest.raises(NotImplementedError, match="ROADMAP.md queue A"):
            T.forward(cfg, pp, {"tokens": tokens, "labels": tokens}, device="cpu")


def test_prefill_and_decode_on_placed_parameters_raise(one_rank):
    cfg = get_smoke_config("glm4-9b")
    params = T.init_params(cfg, 0, device="cpu")
    with S.use_compat_mesh(one_rank):
        pp = S.place(params, one_rank, S.shard_params(one_rank, T.param_axes(cfg), abstract_tree=params))
        with pytest.raises(NotImplementedError, match="prefill"):
            T.prefill(cfg, pp, {"tokens": torch.zeros((1, 4), dtype=torch.int64)}, 8, device="cpu")


def test_restore_onto_a_mesh_replicated(one_rank, tmp_path):
    """``tests/checkpoint/test_manager.py::test_elastic_restore_to_shardings``
    on the port: a ``(1,)`` mesh, ``Replicate()`` placements, trees equal."""
    from torch.distributed.tensor import Replicate

    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4), "b": [torch.ones(5, dtype=torch.bfloat16)],
            "c": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, tree)
    shardings = {"a": (Replicate(),), "b": [(Replicate(),)], "c": (Replicate(),)}
    with S.use_compat_mesh(one_rank):
        restored, _ = mgr.restore(tree, shardings=shardings)
    for got, want in zip(tree_lib.leaves(restored), tree_lib.leaves(tree)):
        assert S.is_placed(got) and tuple(got.placements) == (Replicate(),)
        assert torch.equal(got.full_tensor(), want)
    with pytest.raises(ValueError, match="needs a mesh"):
        mgr.restore(tree, shardings=shardings)


def test_a_write_that_fails_on_rank_0_alone_raises_on_every_rank(tmp_path):
    ranks = run_ranks(mesh_ranks.write_failure_rank, 3, str(tmp_path))
    for mode in ("blocking", "async"):
        got = [r[mode] for r in ranks]
        assert [g["raised"]["type"] for g in got] == ["OSError", "CheckpointWriteError", "CheckpointWriteError"]
        assert all("No space left on device" in g["raised"]["message"] for g in got)
        assert all("rank 0 failed" in g["raised"]["message"] for g in got[1:])
        assert all(g["steps"] == [2] for g in got)  # the ranks agree: the failed step does not exist


def test_make_compat_mesh_defaults_to_the_card_and_raises_without_one(one_rank, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.make_compat_mesh((1,), ("data",))
    assert S.make_compat_mesh((1,), ("data",), device_type="cpu").device_type == "cpu"


def test_the_all_gather_on_all_reduce_gives_gloos_bits():
    for out in run_ranks(mesh_ranks.all_gather_rank, 2):
        assert all(out["same_bits"].values()), out["same_bits"]
        assert out["calls"] >= 5


def test_the_all_gather_leaves_a_group_of_another_backend_to_its_own():
    from repro_torch.launch.mesh import fake_world
    from repro_torch.parallel import gloo_cuda

    with fake_world(2, rank=1):  # torch's fake process group: its all-gather writes nothing
        calls = gloo_cuda.STATS.calls
        out = gloo_cuda.all_gather_into_tensor(torch.arange(6.0).reshape(3, 2), 2, dist.group.WORLD)
        assert out.shape == (6, 2) and gloo_cuda.STATS.calls == calls
