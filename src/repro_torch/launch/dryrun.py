"""Multi-pod dry run: every (architecture x input shape) cell's real step on the production meshes, on meta tensors.

The port of :mod:`repro.launch.dryrun`.  For every (arch x shape x mesh x
variant) cell it builds the step the JAX package compiles (the train step
with ``remat=True``, prefill at ``seq_len``, one decode step over a
``seq_len`` cache) against the 16 x 16 single-pod and 2 x 16 x 16 multi-pod
meshes, and runs it on DTensors whose local shards are meta tensors (shapes,
no storage), placed by ``shard_params`` over ``abstract_params`` /
``opt_state_axes`` / ``cache_axes``, on torch's fake process group
(:func:`repro_torch.launch.mesh.fake_mesh`): this process is rank 0 of 256 or
512, nothing is allocated and no card is needed.  It records, for rank 0:

  * ``memory``: ``argument_bytes`` / ``output_bytes``, the bytes of the local
    shards of the step's arguments / outputs; ``temp_bytes``, the peak of the
    bytes of the local tensors the step's operations create while they are
    alive (a storage counted from the operation that makes it until its last
    reference goes: the *live meta bytes*, ``TEMP_METHOD``), activation
    checkpointing's recompute included; ``code_bytes`` is null (nothing is
    compiled);
  * ``flops_per_device``: the FLOPs of rank 0's local operations by
    :mod:`torch.utils.flop_counter`'s formulas (the products: ``mm``,
    ``bmm``, ``addmm``, ...) and the model kernels' meta operators
    (:mod:`repro_torch.kernels.meta`: the FLOPs of their plain versions).  A
    FLOP counter pushed over DTensors would count each operation at the
    DTensor level, on the whole tensor; here every DTensor operation is left
    to DTensor, whose local operations come back to the counter, so the count
    is one rank's.  Element-wise work is not counted (XLA's
    ``cost_analysis`` counts it: the JAX package's numbers are higher);
  * ``largest_products``: the operations that count the most FLOPs, by
    operator and input shapes (calls, FLOPs): a product multiplied whole
    where its weight is split shows here;
  * ``bytes_per_device``: the bytes each local operation reads and writes
    (views not counted); ``transcendentals``: the elements out of the
    exponentials, logarithms, roots and the like;
  * ``collectives``: every collective rank 0 issues, DTensor's implicit ones
    (``_c10d_functional``) and the explicit ones of SP decode and EP MoE
    (``c10d``), by kind: count, bytes and ring-model ``wire_bytes`` as
    :func:`repro.launch.dryrun.parse_collectives` counts them.

Records land in ``<out>/<arch>__<shape>__<mesh>[__<variant>].json`` in the
JAX package's layout; ``lower_s`` is the time to build and place the cell's
arguments, ``compile_s`` the time of the meta run.  A cell that raises is
recorded with ``status: "error"``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b --shape decode_32k --mesh single
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import PORTED_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, applicable, batch_specs, cache_specs
from repro_torch.kernels import meta as _meta  # noqa: F401  (registers the kernels' meta operators)
from repro_torch.launch.mesh import fake_mesh, production_layout
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import opt_state_axes
from repro_torch.parallel import sharding as S
from repro_torch.train.steps import make_train_step

#: How ``temp_bytes`` is estimated (written into every record).
TEMP_METHOD = ("live meta bytes: the peak, over the step, of the bytes of the local tensors its operations "
               "created that are still referenced (arguments not counted)")
#: How ``flops_per_device`` is counted.
FLOPS_METHOD = ("rank 0's local operations: torch.utils.flop_counter formulas (products) and the kernels' "
                "meta operators (their plain versions' FLOPs); element-wise work not counted")

# blocks tuned per shape, as the JAX package's: one q-block for train, 4096-tiles for the 32k prefill
_BLOCKS = {"train_4k": (2048, 2048), "prefill_32k": (4096, 4096), "decode_32k": None, "long_500k": None}
VARIANTS = ("baseline", "ep_moe", "sp_kv")


def _opt_cfg(cfg) -> AdamWConfig:
    # bf16 moments for the >= 100B models
    return AdamWConfig(moment_dtype="bfloat16" if cfg.param_count() > 100e9 else "float32")


@dataclasses.dataclass
class Cell:
    """One cell's step: its kind, the model config, the rules it runs under,
    and its arguments as abstract (meta) trees with their placements, by
    name (``params``, ``opt_state``, ``batch``; decode: ``params``,
    ``tokens``, ``cache``)."""

    kind: str
    cfg: object
    rules: dict
    shape_name: str
    args: dict
    placements: dict


def build_cell(arch: str, shape_name: str, mesh, rules=None, variant: str = "baseline", *, cfg=None) -> Cell:
    """The cell's arguments and placements on ``mesh`` (a ``DeviceMesh`` or an
    :class:`~repro_torch.parallel.sharding.AbstractMesh`: specs need no
    process group), as :func:`repro.launch.dryrun.build_cell` shards them.

    Variants: ``ep_moe`` (``moe_impl="ep"``), ``sp_kv`` (``kv_seq`` on
    ``model``).  ``cfg``: the architecture's config unless given (a smoke
    config in the tests)."""
    cfg = cfg or get_config(arch)
    if variant == "ep_moe":
        cfg = dataclasses.replace(cfg, moe_impl="ep")
    rules = dict(rules or S.DEFAULT_RULES)
    if variant == "sp_kv":
        rules["kv_seq"] = "model"
    spec = SHAPES[shape_name]
    params_abs, axes = _model_trees(cfg)
    params_sh = S.shard_params(mesh, axes, rules, abstract_tree=params_abs)
    batch_abs = batch_specs(cfg, shape_name)

    def batch_sh(cell_rules):
        return {k: S.logical_sharding(mesh, T.BATCH_AXES[k], cell_rules, tuple(v.shape)) for k, v in batch_abs.items()}

    if spec.kind == "train":
        opt_abs = adamw_init(params_abs, _opt_cfg(cfg))
        opt_sh = S.shard_params(mesh, opt_state_axes(axes), rules, abstract_tree=opt_abs)
        opt_sh["step"] = S.logical_sharding(mesh, (), rules)
        return Cell("train", cfg, rules, shape_name, {"params": params_abs, "opt_state": opt_abs, "batch": batch_abs},
                    {"params": params_sh, "opt_state": opt_sh, "batch": batch_sh(rules)})
    if spec.kind == "prefill":
        return Cell("prefill", cfg, rules, shape_name, {"params": params_abs, "batch": batch_abs},
                    {"params": params_sh, "batch": batch_sh(rules)})
    # decode: one step over a seq_len cache
    bsz = spec.global_batch
    cache_abs = _cache_tree(cfg, shape_name)
    cache_rules = dict(rules)
    if bsz % _axis_size(mesh, rules.get("batch")):
        cache_rules["batch"] = None
    if shape_name == "long_500k":
        cache_rules["kv_seq"] = None  # window caches are small; the state is split over model
    cache_sh = S.shard_params(mesh, T.cache_axes(cfg), cache_rules, abstract_tree=cache_abs)
    tokens = batch_abs["tokens"]
    tok_sh = S.logical_sharding(mesh, ("batch", None), cache_rules, tuple(tokens.shape))
    return Cell("decode", cfg, cache_rules, shape_name, {"params": params_abs, "tokens": tokens, "cache": cache_abs},
                {"params": params_sh, "tokens": tok_sh, "cache": cache_sh})


@functools.lru_cache(maxsize=4)
def _model_trees(cfg):
    """``abstract_params`` and ``param_axes`` of a config (meta; a cell reads them only)."""
    return T.abstract_params(cfg), T.param_axes(cfg)


_cache_tree = functools.lru_cache(maxsize=8)(cache_specs)


def _axis_size(mesh, target) -> int:
    sizes = S._as_abstract(mesh).sizes
    if target is None:
        return 1
    return math.prod(sizes.get(t, 1) for t in ((target,) if isinstance(target, str) else target))


def local_shape(shape, placements, mesh) -> tuple[int, ...]:
    """The shape of rank 0's shard of a tensor of ``shape`` placed by
    ``placements`` on ``mesh`` (the rules' specs divide what they split)."""
    sizes = S._as_abstract(mesh).axis_sizes
    out = list(shape)
    for m, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // sizes[m])
    return tuple(out)


def leaf_bytes(cell: Cell, mesh) -> dict[str, int]:
    """Every tensor leaf of the cell's arguments, by ``"<arg>/<path>"``: the
    bytes of rank 0's shard."""
    return {f"{name}/{path}".rstrip("/"): math.prod(local_shape(x.shape, pl, mesh)) * x.element_size()
            for name, tree in cell.args.items()
            for path, x, pl in _paired(tree, cell.placements[name]) if isinstance(x, torch.Tensor)}


def _paired(tree, other, prefix=""):
    """``(path, leaf, other's leaf)`` of two trees of one nesting, dict keys sorted."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _paired(tree[k], other[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _paired(v, other[i], f"{prefix}{i}/")]
    return [(prefix[:-1], tree, other)]


def place_meta(cell: Cell, mesh) -> dict:
    """The cell's arguments as DTensors on ``mesh`` whose local shards are meta
    tensors (non-tensor leaves, a cache's ``len``, as they are)."""
    def one(x, pl):
        return S.zeros(x.shape, x.dtype, mesh, pl, "meta") if isinstance(x, torch.Tensor) else x

    return {name: S.tree_map_with(one, tree, cell.placements[name]) for name, tree in cell.args.items()}


def step_fn(cell: Cell):
    """The cell's step over its placed arguments."""
    cfg, spec = cell.cfg, SHAPES[cell.shape_name]
    if cell.kind == "train":
        qb, kb = _BLOCKS[cell.shape_name]
        step = make_train_step(cfg, _opt_cfg(cfg), remat=True, q_block=qb, kv_block=kb)
        return lambda a: step(a["params"], a["opt_state"], a["batch"])
    if cell.kind == "prefill":
        qb, kb = _BLOCKS[cell.shape_name]
        return lambda a: T.prefill(cfg, a["params"], a["batch"], spec.seq_len, q_block=qb, kv_block=kb,
                                   device="meta")
    return lambda a: T.decode_step(cfg, a["params"], a["tokens"], a["cache"], device="meta")


# ---------------------------------------------------------------------------
# The probe: FLOPs, bytes, collectives and live bytes on rank 0's local tensors
# ---------------------------------------------------------------------------

_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "tanh", "sigmoid", "sqrt", "rsqrt", "sin", "cos",
                   "erf", "erfinv", "pow", "logsumexp", "_softmax", "_log_softmax", "silu", "gelu", "softplus"}
_COLLECTIVE_KINDS = {"all_reduce": "all-reduce", "allreduce_": "all-reduce", "all_gather_into_tensor": "all-gather",
                     "reduce_scatter_tensor": "reduce-scatter", "all_to_all_single": "all-to-all"}


def wire_bytes(kind: str, size: float, n: int) -> float:
    """:func:`repro.launch.dryrun.parse_collectives`' ring model: all-reduce
    2(n-1)/n B; all-gather (n-1)/n B_out; reduce-scatter (n-1) B_out;
    all-to-all (n-1)/n B; anything else B.  ``n`` at least 2."""
    n = max(n, 2)
    if kind == "all-reduce":
        return 2 * (n - 1) / n * size
    if kind in ("all-gather", "all-to-all"):
        return (n - 1) / n * size
    if kind == "reduce-scatter":
        return (n - 1) * size
    return size


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _group_size(group) -> int:
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group

        return _resolve_process_group(group).size()
    return torch.distributed.ProcessGroup.unbox(group).size()  # a c10d op's ProcessGroup script object


#: DTensor's sharding propagation: it runs operations on fake and meta tensors of the
#: whole (global) shapes to learn their outputs' shapes, which no rank computes.
_PROPAGATION = os.path.join("distributed", "tensor", "_sharding_prop.py")


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


class Probe(TorchDispatchMode):
    """A dispatch mode over rank 0's local tensors.  An operation on DTensors
    is left to DTensor (``NotImplemented``), whose local operations come back
    here; what DTensor's sharding propagation runs (on fake tensors, or meta
    tensors of the whole shapes) is passed through uncounted.  Counts FLOPs
    (:data:`torch.utils.flop_counter.flop_registry`), bytes read and written,
    transcendental elements, collectives, and the live bytes of the storages
    the operations create (their peak)."""

    def __init__(self, keep_out=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.transcendentals = 0
        self.products: dict[tuple, list[int]] = {}  # (operator, input shapes) -> [calls, FLOPs]
        self.collectives: dict = {}
        self.live: dict[int, int] = {}
        self.live_bytes = self.peak_bytes = 0
        self.skip = {t.untyped_storage()._cdata for t in keep_out}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if any(issubclass(t, FakeTensor) for t in types) or _in_propagation():
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        name = func._opname if hasattr(func, "_opname") else str(func)
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d", "_c10d_functional_autograd"):
            self._collective(name, args, out)
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += flops
            shapes = tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))
            tally = self.products.setdefault((name, shapes), [0, 0])
            tally[0] += 1
            tally[1] += flops
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor))
            self.bytes += sum(_nbytes(t) for t in outs)
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            self._track(t)
        return out

    def _collective(self, name, args, out):
        kind = _COLLECTIVE_KINDS.get(name)
        if kind is None:  # wait_tensor, the autograd wrappers: no traffic of their own
            return
        if name == "all_gather_into_tensor":  # (input, group size, group): the gathered output
            size, n = _nbytes(out), args[1]
        elif name == "reduce_scatter_tensor":  # (input, op, group size, group): the scattered piece
            size, n = _nbytes(out), args[2]
        elif name == "allreduce_":  # c10d's, the explicit paths': (tensors, process group, ...)
            size, n = sum(_nbytes(t) for t in args[0]), _group_size(args[1])
        else:  # (input, ..., group)
            size, n = _nbytes(args[0]), _group_size(args[-1])
        agg = self.collectives.setdefault(kind, {"count": 0, "bytes": 0.0, "wire_bytes": 0.0})
        agg["count"] += 1
        agg["bytes"] += size
        agg["wire_bytes"] += wire_bytes(kind, size, n)

    def _track(self, t):
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live or key in self.skip:
            return
        self.live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live_bytes -= self.live.pop(key, 0)


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def run_on_mesh(cell: Cell, mesh) -> dict:
    """The cell's step on meta DTensors placed on ``mesh`` (the fake process
    group's), under its rules; returns the measured fields of the record."""
    placed = place_meta(cell, mesh)
    arg_locals = [x.to_local() if S.is_placed(x) else x for x in _tensors(placed)]
    probe = Probe(keep_out=arg_locals)
    t0 = time.perf_counter()
    with S.use_compat_mesh(mesh), S.axis_rules(cell.rules), probe:
        out = step_fn(cell)(placed)
    run_s = time.perf_counter() - t0
    out_locals = [x.to_local() if S.is_placed(x) else x for x in _tensors(out)]
    return {
        "run_s": run_s,
        "memory": {"argument_bytes": sum(_nbytes(x) for x in arg_locals),
                   "output_bytes": sum(_nbytes(x) for x in out_locals),
                   "temp_bytes": probe.peak_bytes, "alias_bytes": 0, "code_bytes": None},
        "flops_per_device": float(probe.flops),
        "bytes_per_device": float(probe.bytes),
        "transcendentals": float(probe.transcendentals),
        "collectives": probe.collectives,
        "largest_products": largest_products(probe),
    }


def largest_products(probe: Probe, n: int = 10) -> list[dict]:
    """The ``n`` operations of ``probe``'s count with the most FLOPs, each
    ``{"op", "shapes", "calls", "flops"}``."""
    top = sorted(probe.products.items(), key=lambda kv: -kv[1][1])[:n]
    return [{"op": op, "shapes": [list(s) for s in shapes], "calls": calls, "flops": float(flops)}
            for (op, shapes), (calls, flops) in top]


def mesh_name(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return "fake" + "x".join(map(str, mesh_shape))
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, variant: str = "baseline", *, cfg=None,
             mesh_shape=None) -> dict:
    """One cell's record, written to ``out_dir``.  ``cfg`` / ``mesh_shape``
    (with its axes ``("data", "model")`` or ``("pod", "data", "model")``)
    replace the architecture's config and the production mesh (small cells
    for tests)."""
    cfg = cfg or get_config(arch)
    ok, why = applicable(cfg, shape_name)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod, mesh_shape), "variant": variant,
              "status": "skipped" if not ok else "pending"}
    if not ok:
        record["skip_reason"] = why
        _write(out_dir, record)
        return record
    if mesh_shape is None:
        shape, axes = production_layout(multi_pod=multi_pod)
    else:
        shape, axes = tuple(mesh_shape), ("data", "model") if len(mesh_shape) == 2 else ("pod", "data", "model")
    try:
        with fake_mesh(shape, axes) as mesh:
            t0 = time.perf_counter()
            cell = build_cell(arch, shape_name, mesh, variant=variant, cfg=cfg)
            build_s = time.perf_counter() - t0
            got = run_on_mesh(cell, mesh)
        record.update(
            status="ok",
            chips=math.prod(shape),
            lower_s=round(build_s, 2),
            compile_s=round(got["run_s"], 2),
            memory=got["memory"],
            flops_per_device=got["flops_per_device"],
            bytes_per_device=got["bytes_per_device"],
            transcendentals=got["transcendentals"],
            collectives=got["collectives"],
            largest_products=got["largest_products"],
            model_params=cfg.param_count(),
            model_active_params=cfg.active_param_count(),
            temp_method=TEMP_METHOD,
            flops_method=FLOPS_METHOD,
        )
    except Exception as e:  # record the failure: a dry-run failure is a fault
        record.update(status="error", error=f"{type(e).__name__}: {e}", trace=traceback.format_exc()[-2000:])
    _write(out_dir, record)
    return record


def _write(out_dir: str, record: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if record.get("variant", "baseline") == "baseline" else f"__{record['variant']}"
    path = os.path.join(out_dir, f"{record['arch']}__{record['shape']}__{record['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    args = ap.parse_args(argv)
    archs = PORTED_ARCHS if args.arch == "all" else (args.arch,)
    shapes = tuple(SHAPES) if args.shape == "all" else (args.shape,)
    meshes = {"single": (False,), "multi": (True,), "both": (False, True)}[args.mesh]
    t00 = time.time()
    failed = 0
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                t0 = time.time()
                rec = run_cell(arch, shape, multi, args.out, variant=args.variant)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    gb = rec["memory"]["argument_bytes"] / 2**30
                    extra = f" args={gb:.2f}GiB/dev flops={rec['flops_per_device']:.3g}"
                elif status == "error":
                    failed += 1
                    extra = " " + rec["error"][:120]
                print(f"[{time.time() - t00:7.1f}s] {arch:18s} {shape:12s} {'multi' if multi else 'single':6s} -> "
                      f"{status}{extra} ({time.time() - t0:.1f}s)", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
