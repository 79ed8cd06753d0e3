"""Elastic restore: train under one mesh, checkpoint, restore onto another and train on.

The port of ``examples/elastic_restart.py`` (the paper's future-work question
"should we migrate to another instance type?" answered at the mesh level),
with the example's defaults:

  1. launch 1: a process group of 2 ranks (:func:`repro_torch.parallel.ranks.run_ranks`)
     on a ``(2,)`` ``data`` mesh trains glm4-9b's smoke config, its state
     placed by :func:`repro_torch.parallel.shard_params`, on
     ``TokenStream(batch=4, seq_len=64, seed=0)`` for 3 steps, then saves
     ``(params, opt_state)`` with the stream's state;
  2. launch 2: a new process group of 8 ranks on a ``(4, 2)`` ``data x
     model`` mesh restores it with ``restore(..., shardings=)`` (the
     placements of the parameters and of the AdamW state on the new mesh),
     reloads the stream and trains 3 more steps.

Every rank runs on the card (several ranks share it when there is one:
gloo takes that) unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.elastic_restart --device cpu
    PYTHONPATH=src python -m repro_torch.launch.elastic_restart --mesh 2,2

The rank functions (:func:`first_launch`, :func:`second_launch`) take an
:class:`ElasticRun`, so the same two launches run at other widths, depths,
step counts and codecs.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import TokenStream
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.parallel import sharding as S
from repro_torch.parallel.ranks import run_ranks
from repro_torch.train.steps import make_train_step, state_shardings

#: Axis names of a mesh of one, two or three dimensions.
MESH_AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}
#: The example's model and launch 1's mesh.
ARCH, FIRST_MESH = "glm4-9b", (2,)


@dataclasses.dataclass(frozen=True)
class ElasticRun:
    """The two launches: :data:`ARCH` (``preset`` smoke or full, ``layers``
    and ``dtype`` cut or set when given), the data, the optimizer (AdamW, its
    moments in ``moment_dtype``), the codec, the checkpoint directory and
    launch 2's mesh (launch 1's is :data:`FIRST_MESH`)."""

    ckpt_dir: str
    preset: str = "smoke"
    layers: int | None = None
    dtype: str | None = None
    batch: int = 4
    seq: int = 64
    steps: int = 3
    lr: float = 1e-3
    moment_dtype: str = "float32"
    codec: str = "raw"
    block: int = 64  # q_block = kv_block of the example's train step
    second_mesh: tuple[int, ...] = (4, 2)
    device: str = "cuda"

    def config(self):
        cfg = get_config(ARCH) if self.preset == "full" else get_smoke_config(ARCH)
        over = {k: v for k, v in (("n_layers", self.layers), ("dtype", self.dtype)) if v is not None}
        return dataclasses.replace(cfg, **over)

    def opt_config(self) -> AdamWConfig:
        return AdamWConfig(lr=self.lr, moment_dtype=self.moment_dtype)

    def stream(self, device) -> TokenStream:
        return TokenStream(vocab_size=self.config().vocab_size, batch=self.batch, seq_len=self.seq, seed=0,
                           device=device)


def _mesh(shape: tuple[int, ...], device: str):
    mesh = S.make_compat_mesh(shape, MESH_AXES[len(shape)], device_type="cpu" if device == "cpu" else "cuda")
    local = torch.device("cpu") if device == "cpu" else torch.device("cuda", torch.cuda.current_device())
    return mesh, local


def _train(run: ElasticRun, mesh, params, opt_state, data, steps: int) -> tuple:
    """``steps`` placed train steps; returns the state, the metrics and the
    step times."""
    step = make_train_step(run.config(), run.opt_config(), remat=False, q_block=run.block, kv_block=run.block)
    losses, norms, times = [], [], []
    for _ in range(steps):
        batch = T.place_batch(mesh, next(data))
        _sync(mesh)
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch)
        _sync(mesh)
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return params, opt_state, {"losses": losses, "grad_norms": norms, "step_s": times}


def _sync(mesh) -> None:
    if mesh.device_type == "cuda":
        torch.cuda.synchronize()


def _peak_gb(mesh) -> float | None:
    return torch.cuda.max_memory_allocated() / 1e9 if mesh.device_type == "cuda" else None


def first_launch(rank: int, run: ElasticRun) -> dict:
    """One rank of launch 1: init (seed 0), place on the first mesh, train
    ``run.steps`` steps, save at step ``run.steps``."""
    mesh, device = _mesh(FIRST_MESH, run.device)
    cfg = run.config()
    with S.use_compat_mesh(mesh):
        params = T.init_params(cfg, 0, device=device)  # every rank the same whole init; each keeps its shards
        params = S.place(params, mesh, S.shard_params(mesh, T.param_axes(cfg), abstract_tree=params))
        opt_state = adamw_init(params, run.opt_config())  # the moments placed as their parameters
        data = run.stream(device)
        params, opt_state, out = _train(run, mesh, params, opt_state, data, run.steps)
        mgr = CheckpointManager(run.ckpt_dir, keep=1, codec_name=run.codec)
        _sync(mesh)
        t0 = time.perf_counter()
        meta = mgr.save(run.steps, (params, opt_state), {"data": data.state_dict(), "step": run.steps})
        _sync(mesh)
        out["save_s"] = time.perf_counter() - t0
        out["bytes_written"] = meta.bytes_written
    out["peak_memory_gb"] = _peak_gb(mesh)
    return out


def second_launch(rank: int, run: ElasticRun) -> dict:
    """One rank of launch 2: restore step ``run.steps`` onto the second mesh
    with ``shardings=``, reload the stream, train ``run.steps`` more steps.
    Returns the metrics, the first restored leaf's placements, and where each
    restored leaf's local shard lies with a checksum of its bits
    (:func:`shard_digests`)."""
    mesh, device = _mesh(run.second_mesh, run.device)
    cfg = run.config()
    template = abstract_state(run)
    with S.use_compat_mesh(mesh):
        mgr = CheckpointManager(run.ckpt_dir, keep=1, codec_name=run.codec)
        _sync(mesh)
        t0 = time.perf_counter()
        (params, opt_state), extra = mgr.restore(template, step=run.steps,
                                                 shardings=state_shardings(mesh, cfg, *template))
        _sync(mesh)
        restore_s = time.perf_counter() - t0
        first = tree_lib.leaves(params)[0]
        out = {"restore_s": restore_s, "restored_placements": str(tuple(first.placements)),
               "restored_local_shape": list(first.to_local().shape), "restored_shape": list(first.shape)}
        out["digests"] = shard_digests((params, opt_state))
        data = run.stream(device)
        data.load_state_dict(extra["data"])
        params, opt_state, metrics = _train(run, mesh, params, opt_state, data, run.steps)
        out.update(metrics)
        out["step"] = int(extra["step"])
    out["peak_memory_gb"] = _peak_gb(mesh)
    return out


def abstract_state(run: ElasticRun) -> tuple:
    """``(params, opt_state)`` as meta tensors: the restore's template."""
    params = T.abstract_params(run.config())
    return params, adamw_init(params, run.opt_config())


def bits_digest(x: torch.Tensor) -> int:
    """A checksum of ``x``'s bits: the sum, wrapping at 2**64, of each 16-bit
    word (sign-extended) times an odd weight of its position.  A change of any
    one word changes it (an odd weight is invertible modulo 2**64)."""
    words = x.detach().contiguous().reshape(-1).view(torch.int16).to(torch.int64)
    pos = torch.arange(words.numel(), dtype=torch.int64, device=words.device)
    weights = (pos * -7046029254386353131) | 1  # 0x9E3779B97F4A7C15 as int64, wrapping
    return int(torch.sum(words * weights))


def shard_digests(tree) -> list:
    """For each placed leaf of ``tree``: its global offset, its local shape and
    :func:`bits_digest` of its local shard."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    out = []
    for x in tree_lib.leaves(tree):
        shape, offset = compute_local_shape_and_global_offset(x.shape, x.device_mesh, x.placements)
        out.append({"offset": list(offset), "shape": list(shape), "digest": bits_digest(x.to_local())})
    return out


def slice_digest(x: torch.Tensor, offset, shape) -> int:
    """:func:`bits_digest` of the block ``[offset, offset + shape)`` of a whole tensor."""
    index = tuple(slice(o, o + n) for o, n in zip(offset, shape))
    return bits_digest(x[index])


def run_both(run: ElasticRun) -> tuple[list, list]:
    """Launch 1, then launch 2, each a new process group; returns each
    launch's per-rank results."""
    first = run_ranks(first_launch, math.prod(FIRST_MESH), run)
    second = run_ranks(second_launch, math.prod(run.second_mesh), run)
    return first, second


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="4,2", help="launch 2's data x model mesh (e.g. 2,2 for 4 ranks)")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_elastic_ckpt"))
    ap.add_argument("--device", default=None, help="'cpu' runs the ranks on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> tuple[list, list]:
    args = parse_args(argv)
    device = "cpu" if args.device == "cpu" else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run the ranks on the CPU")
    run = ElasticRun(ckpt_dir=args.ckpt_dir, device=device, second_mesh=tuple(int(v) for v in args.mesh.split(",")))
    first, second = run_both(run)
    one, two = first[0], second[0]
    mesh1 = dict(zip(MESH_AXES[len(FIRST_MESH)], FIRST_MESH))
    mesh2 = dict(zip(MESH_AXES[len(run.second_mesh)], run.second_mesh))
    print(f"phase 1 (mesh {mesh1}): loss {one['losses'][-1]:.3f}")
    print(f"phase 2 (mesh {mesh2}): loss {two['losses'][-1]:.3f} — resumed on a different mesh")
    print(f"losses: {one['losses'] + two['losses']}")
    print(f"restored param sharding: {two['restored_placements']} (embed.tokens {two['restored_shape']}, "
          f"{two['restored_local_shape']} a rank)")
    return first, second


if __name__ == "__main__":
    main()
