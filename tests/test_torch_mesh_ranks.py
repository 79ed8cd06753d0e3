"""Rank functions of the port's mesh-placed tests (``tests/test_torch_mesh.py``,
``tests/test_torch_mesh_train.py``), run by ``repro_torch.parallel.ranks.run_ranks``.

A module of its own that defines no tests and imports neither JAX nor the JAX
package: every spawned rank imports it.  Bulk inputs (the JAX package's
parameters as numpy, batches) reach the ranks through a file.
"""

import dataclasses
import os
import warnings

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointCorruptionError
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import gloo_cuda
from repro_torch.parallel import sharding as S
from repro_torch.train.steps import make_train_step, place_batch, state_shardings
from torch.distributed.tensor import DTensor

MESH_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def load(path):
    return torch.load(path, weights_only=False)


def cpu_mesh(shape):
    warnings.filterwarnings("ignore")  # DTensor's notes on sequential all-reduces over two mesh axes
    return S.make_compat_mesh(shape, MESH_AXES[len(shape)], device_type="cpu")


def flat_names(tree):
    """The ``"layers/0/attn.wq"`` names of a tree's leaves, in flatten order."""
    out = []

    def walk(x, prefix):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{prefix}{k}/")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{prefix}{i}/")
        else:
            out.append(prefix[:-1])

    walk(tree, "")
    return out


def grads_rank(rank, path, mesh_shape):
    """For each case of the file (``{"cfg", "params" (the JAX package's,
    numpy), "batch"}``): ``loss_fn`` and its gradient on the parameters and
    batch placed on the mesh.  Returns per case the loss, every gradient
    gathered whole after its redistribution to the parameter's placements,
    whether each came back with those placements, and the gradients read as
    if the redistribution were left out (each rank's raw local gradient taken
    for its shard, where it has the shard's shape: the mutation the
    data-parallel all-reduce repairs; None elsewhere)."""
    mesh = cpu_mesh(mesh_shape)
    out = {}
    for name, case in load(path).items():
        cfg = case["cfg"]
        params = from_jax(cfg, case["params"], "cpu")
        with S.use_compat_mesh(mesh):
            placed = S.place(params, mesh, S.shard_params(mesh, T.param_axes(cfg), abstract_tree=params))
            batch = place_batch(mesh, {k: torch.as_tensor(v) for k, v in case["batch"].items()})
            leaves, treedef = tree_lib.flatten(placed)
            wrt = [x.detach().requires_grad_(True) for x in leaves]
            loss, _ = T.loss_fn(cfg, treedef.unflatten(wrt), batch, q_block=case["block"], kv_block=case["block"],
                                device="cpu")
            grads = torch.autograd.grad(loss, wrt)
            whole, raw, same = [], [], []
            for x, g in zip(wrt, grads):
                fits = g.to_local().shape == x.to_local().shape  # a Partial where the parameter is whole
                raw.append(DTensor.from_local(g.to_local(), mesh, x.placements, run_check=False).full_tensor()
                           if fits else None)
                g = g.redistribute(mesh, x.placements)
                same.append(tuple(g.placements) == tuple(x.placements))
                whole.append(g.full_tensor())
        out[name] = {"loss": float(loss.to_local()), "grads": whole, "raw_grads": raw, "same_placements": same,
                     "names": flat_names(params)}
    return out


def train_rank(rank, path, mesh_shape, steps):
    """``steps`` placed train steps of the file's case (``{"cfg", "params",
    "batches", "block", "lr"}``) on the mesh: the losses, grad norms and the
    final parameters, gathered whole."""
    mesh = cpu_mesh(mesh_shape)
    case = load(path)
    cfg, opt_cfg = case["cfg"], AdamWConfig(lr=case["lr"], moment_dtype="float32")
    params = from_jax(cfg, case["params"], "cpu")
    step = make_train_step(cfg, opt_cfg, remat=case["remat"], q_block=case["block"], kv_block=case["block"])
    losses, norms = [], []
    with S.use_compat_mesh(mesh):
        state = (params, adamw_init(params, opt_cfg))
        params, opt_state = S.place(state, mesh, state_shardings(mesh, cfg, *state))
        for b in case["batches"]:
            params, opt_state, m = step(params, opt_state, place_batch(mesh, {k: torch.as_tensor(v)
                                                                              for k, v in b.items()}))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        placements = [str(tuple(x.placements)) for x in tree_lib.leaves(params)]
        params = S.gather(params)
    return {"losses": losses, "grad_norms": norms, "params": params, "placements": placements}


def trainer_rank(rank, path, mesh_shape):
    """The file's SpotTrainer campaign (``{"cfg", "trace", "tcfg", "data",
    "lr", "block"}``) with its state placed on the mesh and
    ``relaunch_shardings`` the state's placements; then a save whose leaf file
    rank 0 corrupts, and its restore, which must raise
    ``CheckpointCorruptionError`` on every rank."""
    from repro_torch.data import TokenStream
    from repro_torch.train.spot_trainer import SpotTrainer, SpotTrainerConfig

    mesh = cpu_mesh(mesh_shape)
    case = load(path)
    cfg, opt_cfg = case["cfg"], AdamWConfig(lr=case["lr"], moment_dtype="float32")
    with S.use_compat_mesh(mesh):
        def init():
            params = T.init_params(cfg, 0, device="cpu")
            state = (params, adamw_init(params, opt_cfg))
            return S.place(state, mesh, state_shardings(mesh, cfg, *state))

        meta = T.abstract_params(cfg)
        shardings = state_shardings(mesh, cfg, meta, adamw_init(meta, opt_cfg))
        trainer = SpotTrainer(SpotTrainerConfig(**case["tcfg"]), train_step=make_train_step(
            cfg, opt_cfg, remat=False, q_block=case["block"], kv_block=case["block"]), init_params=init,
            data=TokenStream(device="cpu", **case["data"]), trace=case["trace"], relaunch_shardings=shardings)
        report = dataclasses.asdict(trainer.run())
        state = init()
        restored, _ = trainer.mgr.restore(state, shardings=shardings)  # the campaign's last checkpoint
        restored_placements = [tuple(x.placements) == tuple(want.placements) for x, want in
                               zip(tree_lib.leaves(restored), tree_lib.leaves(state))]
        # a torn leaf: every rank must see the corruption
        mgr = trainer.mgr
        mgr.save(1000, state, {"step": 1000})
        if rank == 0:
            d = os.path.join(mgr.root, f"step_{1000:09d}")
            victim = sorted(f for f in os.listdir(d) if f.startswith("leaf"))[0]
            with open(os.path.join(d, victim), "r+b") as f:
                f.seek(64)
                f.write(b"\xff\xff\xff")
        dist.barrier()
        try:
            mgr.restore(state, step=1000, shardings=shardings)
        except CheckpointCorruptionError:
            corrupt = True
        else:
            corrupt = False
    return {"report": report, "corrupt_raised": corrupt, "restored_placements_match": restored_placements}


def all_gather_rank(rank):
    """gloo's all-gather against :mod:`repro_torch.parallel.gloo_cuda`'s form
    (installed for CPU tensors here), on float32 blocks holding -0.0, NaN
    payloads and infinities, on bfloat16 and int64 blocks, and through a
    DTensor redistribution."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate, Shard

    w = dist.get_world_size()
    blocks = {
        "float32": torch.tensor([-0.0, float("nan"), float("inf"), 1.5 + rank], dtype=torch.float32),
        "bfloat16": torch.arange(6, dtype=torch.float32).add(rank).bfloat16().reshape(2, 3),
        "int64": torch.tensor([2**40 + rank, -rank], dtype=torch.int64),
        "odd_bytes": torch.tensor([rank, 3, 250], dtype=torch.uint8),
    }
    blocks["float32"].view(torch.int32)[1] = 0x7FC00001 + rank  # a NaN with a payload
    native = {k: [torch.empty_like(v) for _ in range(w)] for k, v in blocks.items()}
    for k, v in blocks.items():
        dist.all_gather(native[k], v)
    gloo_cuda.install("cpu")
    calls0 = gloo_cuda.STATS.calls
    got = {k: funcol.all_gather_single(v, 0, dist.group.WORLD) for k, v in blocks.items()}
    got = {k: v.wait() if hasattr(v, "wait") else v for k, v in got.items()}
    width = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.int64: torch.int64, torch.uint8: torch.uint8}
    same = {k: bool(torch.equal(got[k].view(width[v.dtype]), torch.cat(native[k]).view(width[v.dtype])))
            for k, v in blocks.items()}
    mesh = S.make_compat_mesh((w,), ("data",), device_type="cpu")
    x = torch.arange(8 * w, dtype=torch.float32).reshape(2 * w, 4)
    d = S.place(x, mesh, (Shard(0),))
    same["dtensor"] = bool(torch.equal(d.redistribute(mesh, (Replicate(),)).to_local(), x))
    return {"same_bits": same, "calls": gloo_cuda.STATS.calls - calls0}


def write_failure_rank(rank, root):
    """Rank 0's write fails with an I/O error of its own (``np.save`` raising
    ENOSPC in rank 0 alone; the fault plan is not involved), in a blocking
    and in an async save; then each rank saves the next step.  Returns, for
    each mode, the error each rank raised and the steps each rank lists."""
    import contextlib
    import errno
    from unittest import mock

    from repro_torch.checkpoint import manager as M

    tree = {"w": torch.arange(6, dtype=torch.float32), "b": [torch.ones(3)]}
    out = {}
    for mode in ("blocking", "async"):
        mgr = M.CheckpointManager(os.path.join(root, mode), async_io=mode == "async")
        full = OSError(errno.ENOSPC, "No space left on device")
        fail = mock.patch.object(M.np, "save", side_effect=full) if rank == 0 else contextlib.nullcontext()
        raised = None
        with fail:
            try:
                mgr.save(1, tree, block=mode == "blocking")
                mgr.wait()
            except OSError as e:
                raised = {"type": type(e).__name__, "message": str(e)}
        mgr.save(2, tree, block=mode == "blocking")
        mgr.wait()
        out[mode] = {"raised": raised, "steps": mgr.steps()}
    return out
