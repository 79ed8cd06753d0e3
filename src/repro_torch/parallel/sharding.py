"""Logical-axis sharding: rules mapping logical names to mesh axes (the port of :mod:`repro.parallel.sharding`).

Model code names each tensor dimension with a *logical* axis (``("batch",
"seq", "embed")``) and never a mesh axis.  A rule set maps logical -> mesh
axes; :func:`_spec_for` turns a tensor's logical axes into a
:class:`PartitionSpec` (one mesh axis, a tuple of them, or ``None`` per
dimension), exactly as the JAX package does, and :func:`logical_sharding` /
:func:`shard_params` turn specs into DTensor placements (``Shard(d)`` or
``Replicate()`` for each mesh dimension).

Parallelism styles expressed purely through rules:

  * DP/FSDP  — "batch" and the designated fsdp param axis -> ("pod", "data")
  * TP       — "heads" / "mlp" / "vocab" / "kv_heads" -> "model"
  * EP       — "experts" -> "model"
  * SP       — "kv_seq" -> "model" for long-context decode

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the running
process group (:func:`make_compat_mesh`), made ambient by
:func:`use_compat_mesh`.  The JAX package runs two kinds of distribution, and
the port has both:

  * GSPMD (whole arrays placed by the rules; the partitioner inserts the
    collectives): :func:`place` turns a tree of tensors into DTensors on the
    mesh by :func:`shard_params`' placements, :func:`shard` is
    ``with_sharding_constraint`` (a DTensor redistributed to the placements
    its logical axes give, and its cotangent to the same), and DTensor's
    sharding propagation inserts the collectives in between.  The models
    run on such tensors (:mod:`repro_torch.models.transformer`), their
    kernels on each rank's local shards (``local_map`` in the kernels'
    ``ops``), and :func:`gather` brings a placed tree back whole.
  * ``compat_shard_map`` (the code writes its collectives out itself): each
    process holds plain local shards, and the explicit paths
    (:mod:`repro_torch.parallel.sp_decode`, :mod:`repro_torch.models.moe_ep`)
    call collectives on the mesh's sub-group of an axis
    (:meth:`AbstractMesh.group`).  :func:`shard` leaves plain tensors as
    they are.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import threading

import torch
import torch.distributed as dist

# logical axis -> mesh axis (or tuple of mesh axes, or None)
Rules = dict[str, object]

# Baseline 2D (+pod) rules: FSDP over (pod, data) on the "fsdp" logical axis,
# tensor parallelism over "model".
DEFAULT_RULES: Rules = {
    # data axes
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,  # set to "model" for SP long-context decode
    # param/activation axes
    "embed": None,
    "fsdp": ("pod", "data"),  # ZeRO-3 axis: largest param dim not on "model"
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_group": ("pod", "data"),
    "vocab": "model",
    "layers": None,
    "conv": None,
    "state": None,
    "rnn": "model",
}

_local = threading.local()


def current_rules() -> Rules:
    return getattr(_local, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def axis_rules(rules: Rules):
    prev = getattr(_local, "rules", None)
    _local.rules = rules
    try:
        yield
    finally:
        if prev is None:
            del _local.rules
        else:
            _local.rules = prev


class PartitionSpec(tuple):
    """A tensor's placement on a mesh: for each dimension a mesh axis name, a
    tuple of them (the dimension split over their product, the first axis
    outermost), or ``None`` (replicated).  Equal to the JAX package's
    ``PartitionSpec`` of the same entries, taken as a tuple."""

    def __new__(cls, *partitions):
        return super().__new__(cls, partitions)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and sizes (``.empty`` when it has none), and the
    ``DeviceMesh`` it describes, if any: what :func:`active_abstract_mesh`
    returns, as the JAX package's does.  Without a ``DeviceMesh`` it is the
    JAX package's ``AbstractMesh`` (specs only; no collectives)."""

    axis_sizes: tuple[int, ...] = ()
    axis_names: tuple[str, ...] = ()
    device_mesh: object = None

    @classmethod
    def of(cls, device_mesh) -> "AbstractMesh":
        return cls(tuple(device_mesh.shape), tuple(device_mesh.mesh_dim_names), device_mesh)

    @property
    def empty(self) -> bool:
        return not self.axis_names

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def group(self, axis: str):
        """The process group of this rank's line of the mesh along ``axis``."""
        return self._device_mesh().get_group(axis)

    def local_rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self._device_mesh().get_local_rank(axis)

    def _device_mesh(self):
        if self.device_mesh is None:
            raise ValueError("an abstract mesh has no process groups")
        return self.device_mesh


_MESH: contextvars.ContextVar[AbstractMesh] = contextvars.ContextVar("repro_torch_mesh", default=AbstractMesh())


def active_abstract_mesh() -> AbstractMesh:
    """The mesh set by the innermost :func:`use_compat_mesh` (or an empty one)."""
    return _MESH.get()


def make_compat_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the running
    process group (whose world size must be the product of ``shape``), rank r
    at the row-major position r.  ``device_type``: where the ranks' tensors
    live, the card unless ``"cpu"`` is asked for (a gloo process group
    reduces tensors of either); raises on ``"cuda"`` without a card."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device for a "cuda" mesh; pass device_type="cpu" to run the ranks on the CPU')
    if device_type == "cuda":  # rank r on card r % cards: several ranks share a card when there are fewer
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
        if dist.get_backend() == "gloo":  # DTensor's all-gather of CUDA tensors, on gloo's all_reduce
            from repro_torch.parallel import gloo_cuda

            gloo_cuda.install("cuda")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def use_compat_mesh(mesh):
    """Makes ``mesh`` (a ``DeviceMesh`` or an :class:`AbstractMesh`) ambient
    for :func:`active_abstract_mesh`, in this context (thread / task) only."""
    token = _MESH.set(_as_abstract(mesh))
    try:
        yield
    finally:
        _MESH.reset(token)


def _as_abstract(mesh) -> AbstractMesh:
    """An :class:`AbstractMesh`, or a ``DeviceMesh`` described by one."""
    return mesh if isinstance(mesh, AbstractMesh) else AbstractMesh.of(mesh)


def _spec_for(
    logical_axes: tuple[str | None, ...],
    rules: Rules,
    mesh,
    shape: tuple[int, ...] | None = None,
) -> PartitionSpec:
    """Logical axes -> PartitionSpec.  Shape-aware: a mapping whose mesh-axis
    product does not divide the dimension is dropped (e.g. GQA kv_heads=2 on
    a 16-wide model axis stays replicated; FSDP on dim 0 still shards the
    tensor).  Mesh axes are never used twice in one spec."""
    sizes = _as_abstract(mesh).sizes
    out = []
    used: set[str] = set()
    for i, ax in enumerate(logical_axes):
        if ax is None:
            out.append(None)
            continue
        target = rules.get(ax)
        if target is None:
            out.append(None)
            continue
        if isinstance(target, str):
            target = (target,)
        picked = [t for t in target if t in sizes and t not in used]
        if shape is not None and picked:
            dim = shape[i]
            # greedily keep the prefix of mesh axes whose product divides dim
            kept = []
            prod = 1
            for t in picked:
                n = sizes[t]
                if dim % (prod * n) == 0:
                    kept.append(t)
                    prod *= n
            picked = kept
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(tuple(picked))
    return PartitionSpec(*out)


def is_placed(x) -> bool:
    """Is ``x`` a DTensor (a whole tensor placed on a mesh)?"""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x, *logical_axes: str | None):
    """Annotate ``x`` with logical axes (``with_sharding_constraint``).  A
    DTensor is redistributed to the placements the axes give on the ambient
    mesh (its own mesh when none is ambient), and so is its cotangent on the
    way back, as the constraint's transpose constrains it: a cotangent that
    arrives ``Partial`` is reduced here, where GSPMD reduces it, and the
    products behind the annotation stay split (:class:`_Constrain`).  A plain
    tensor is returned as it is, on a mesh or off one: off a mesh the
    annotation is a no-op, as in the JAX package, and the explicit paths'
    tensors are already each rank's local shards."""
    if not is_placed(x):
        return x
    mesh = active_abstract_mesh().device_mesh or x.device_mesh
    want = logical_sharding(mesh, logical_axes, current_rules(), tuple(x.shape))
    return _Constrain.apply(x, mesh, want)


def replicated_like(t: torch.Tensor, ref):
    """``t``, a tensor the model code makes itself (positions, RoPE tables,
    masks, a scan's fresh state), as ``ref`` holds its tensors: ``Replicate()``
    on ``ref``'s mesh when ``ref`` is a DTensor (every rank makes the same
    ``t``), else ``t`` itself."""
    if not is_placed(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def place(tree, mesh, placements_tree, *, copy: bool = True):
    """Each tensor leaf of ``tree`` as a DTensor on ``mesh`` with the
    placements of the matching leaf of ``placements_tree`` (what
    :func:`shard_params` gives; a DTensor leaf is redistributed to them).
    Every rank holds the same whole tensor, so each cuts its own shard and
    nothing is sent (``distribute_tensor(..., src_data_rank=None)``).
    Non-tensor leaves are kept as they are.

    ``copy=False`` makes each rank's shard a view of the whole leaf where it
    is contiguous there (a split of the leading dimension, or none), and a
    copy elsewhere: for leaves that nothing writes in place, such as the
    parameters a server reads, which then take no memory beyond the whole
    leaves (ranks sharing one card's parameters by CUDA IPC)."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = _as_abstract(mesh)._device_mesh()

    def one(x, placements):
        if is_placed(x):
            return x.redistribute(mesh, placements)
        if not isinstance(x, torch.Tensor):
            return x
        if copy:
            return distribute_tensor(x.detach(), mesh, placements, src_data_rank=None)
        shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, placements)
        local = x.detach()[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        return DTensor.from_local(local if local.is_contiguous() else local.contiguous(), mesh, placements,
                                  run_check=False, shape=x.shape, stride=x.stride())

    return tree_map_with(one, tree, placements_tree)


def gather(tree):
    """:func:`place`'s inverse: each DTensor leaf as its whole tensor
    (``full_tensor()``, a collective: every rank of the mesh calls it)."""
    return tree_map_with(lambda x, _: x.full_tensor() if is_placed(x) else x, tree, None)


def local_call(fn, inputs, out_placements, in_grad_placements=None):
    """``fn`` over each rank's local shards of the DTensors ``inputs`` (all on
    one mesh), its outputs placed by ``out_placements`` (``local_map``): the
    boundary where a kernel, which takes plain tensors, runs on placed ones.
    ``in_grad_placements``: the placements of each input's gradient when it
    is not the input's own (``Partial()`` on a mesh dimension where an input
    is replicated but the work is split, so each rank's gradient is a part of
    the sum).  An output placed ``Partial()`` (each rank's part of a sum) is
    reduced where it meets a :func:`shard` or a whole operand, and its
    cotangent comes back whole from there: every rank's part needs the whole
    cotangent of the sum."""
    from torch.distributed.tensor.experimental import local_map

    mesh = inputs[0].device_mesh
    one = _is_placements(out_placements)
    return local_map(fn, out_placements=list(out_placements) if one else out_placements,  # a tuple: one per output
                     in_placements=tuple(tuple(x.placements) for x in inputs),
                     in_grad_placements=in_grad_placements, device_mesh=mesh)(*inputs)


class _Constrain(torch.autograd.Function):
    """``with_sharding_constraint`` on a DTensor: the value redistributed to
    ``want`` (the identity where it is placed so already), and the cotangent
    redistributed to ``want`` too, not back to the input's placements."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x.view_as(x) if tuple(x.placements) == want else x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        return grad if tuple(grad.placements) == ctx.want else grad.redistribute(ctx.mesh, ctx.want), None, None


class _ContiguousGrad(torch.autograd.Function):
    """The identity whose backward makes the cotangent contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if not is_placed(grad):
            return grad.contiguous()
        from torch.distributed.tensor import DTensor

        local = grad.to_local()
        if local.is_contiguous():
            return grad
        # a DTensor whose global strides are contiguous reads as contiguous: its shard is made so here
        return DTensor.from_local(local.contiguous(), grad.device_mesh, grad.placements, run_check=False,
                                  shape=grad.shape, stride=grad.stride())


def contiguous_grad(x):
    """``x``, whose cotangent's local shard is made contiguous on its way back:
    a DTensor's ``view`` in the backward of a reshape needs one, and a
    cotangent that comes back through a dtype cast keeps the strides of a
    slice."""
    return _ContiguousGrad.apply(x)


def split_index(x, dim: int) -> tuple[int, int]:
    """Where this rank's local shard of the DTensor ``x`` lies along ``dim``:
    ``(index, count)`` of its block among the equal blocks ``dim`` is split
    into (over every mesh dimension on which ``x`` is ``Shard(dim)``, the
    first outermost)."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    index, count = 0, 1
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            index = index * mesh.size(m) + mesh.get_local_rank(m)
            count *= mesh.size(m)
    return index, count


def local_offset(x) -> tuple[int, ...]:
    """Where this rank's local shard of the DTensor ``x`` starts in the whole
    tensor, one offset per dimension."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return tuple(compute_local_shape_and_global_offset(x.shape, x.device_mesh, x.placements)[1])


def update_slice(dst, src, start: int, dim: int = 1) -> None:
    """``dst[..., start:start + n, ...] = src`` along ``dim`` on DTensors, in
    place (the placed form of ``dynamic_update_slice``): ``src`` is placed as
    ``dst`` is, whole along ``dim``, and each rank copies the part of it that
    falls in its own shard of ``dst``, cast to ``dst``'s dtype."""
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Replicate() if p == Shard(dim) else p for p in dst.placements)
    if tuple(src.placements) != want:
        src = src.redistribute(dst.device_mesh, want)
    d_loc, s_loc = dst.to_local(), src.to_local()
    off, n = local_offset(dst)[dim], src.shape[dim]
    lo, hi = max(start, off), min(start + n, off + d_loc.shape[dim])
    if hi > lo:
        d_loc.narrow(dim, lo - off, hi - lo).copy_(s_loc.narrow(dim, lo - start, hi - lo))


def zeros(shape, dtype, mesh, placements, device):
    """A DTensor of zeros of the whole ``shape`` placed by ``placements``: each
    rank allocates its own shard only (on ``device``: the meta device gives
    shapes without storage)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local_shape = compute_local_shape_and_global_offset(tuple(shape), mesh, placements)[0]
    local = torch.zeros(local_shape, dtype=dtype, device=device)
    stride = [math.prod(shape[d + 1:]) for d in range(len(shape))]  # the whole tensor's, contiguous
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=torch.Size(shape), stride=tuple(stride))


def keep_shards(x, dims: tuple[int, ...]):
    """The DTensor ``x`` redistributed so that it is split along ``dims`` only:
    every other ``Shard`` and every ``Partial`` becomes ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate() for p in x.placements)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def tree_map_with(fn, tree, other):
    """``fn(leaf, other's leaf)`` over ``tree``'s dicts, lists and tuples
    (``other``: a tree of the same nesting whose leaves are placements tuples
    or logical-axes tuples, or None)."""
    if isinstance(tree, dict):
        return {k: tree_map_with(fn, v, None if other is None else other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not (other is not None and (_is_placements(other) or is_axes_leaf(other))):
        subs = [None] * len(tree) if other is None else other
        if len(subs) != len(tree):
            raise ValueError(f"{len(tree)} entries against {len(subs)} placements")
        return type(tree)(tree_map_with(fn, v, o) for v, o in zip(tree, subs))
    return fn(tree, other)


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement

    return isinstance(x, tuple) and all(isinstance(p, Placement) for p in x)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """A spec as DTensor placements: for each mesh dimension ``Shard(d)`` of
    the tensor dimension d split over it, else ``Replicate()``.  A dimension
    split over several mesh axes (``("pod", "data")``) is ``Shard(d)`` on each,
    which DTensor splits in mesh order, as the spec does."""
    from torch.distributed.tensor import Replicate, Shard

    names = _as_abstract(mesh).axis_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"{spec}: dimension {d} is split over {axes}, not in the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return tuple(out)


def logical_sharding(mesh, logical_axes: tuple[str | None, ...], rules: Rules | None = None,
                     shape: tuple[int, ...] | None = None) -> tuple:
    """The DTensor placements of a tensor with these logical axes on ``mesh``."""
    return placements(_spec_for(tuple(logical_axes), rules or current_rules(), mesh, shape), mesh)


def is_axes_leaf(x) -> bool:
    """A logical-axes tuple (a leaf of an axes tree): names or ``None``."""
    return isinstance(x, tuple) and all(isinstance(v, (str, type(None))) for v in x)


def _map_axes(fn, axes_tree, abstract_tree):
    if is_axes_leaf(axes_tree):
        return fn(axes_tree, abstract_tree)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, None if abstract_tree is None else abstract_tree[k]) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        subs = [None] * len(axes_tree) if abstract_tree is None else abstract_tree
        if len(subs) != len(axes_tree):
            raise ValueError(f"{len(axes_tree)} axes entries against {len(subs)} tensors")
        return [_map_axes(fn, a, x) for a, x in zip(axes_tree, subs)]
    raise TypeError(f"not a logical-axes tree: {axes_tree!r}")


def shard_params(mesh, axes_tree, rules: Rules | None = None, abstract_tree=None):
    """A tree of logical-axes tuples -> the tree of DTensor placements.

    ``abstract_tree``: the matching tree of tensors (meta tensors will do),
    whose shapes enable the divisibility fallback."""
    rules = rules or current_rules()

    def one(axes, x):
        return logical_sharding(mesh, axes, rules, tuple(x.shape) if isinstance(x, torch.Tensor) else None)

    return _map_axes(one, axes_tree, abstract_tree)


def _sum_in_place(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor); a bf16 / fp16 sum is taken
    in float32 and rounded once, not at each add."""
    out = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.dtype)


class _SumOverRanks(torch.autograd.Function):
    """``all_reduce`` SUM whose backward passes the cotangent through."""

    @staticmethod
    def forward(ctx, x, group):
        return _sum_in_place(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SharedInput(torch.autograd.Function):
    """The identity whose backward sums the cotangent over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum_in_place(grad.contiguous(), ctx.group), None


def _axis_list(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def psum(x: torch.Tensor, mesh: AbstractMesh, axes) -> torch.Tensor:
    """``x`` summed over the mesh axes ``axes`` (a name or a tuple): the JAX
    package's ``psum`` in ``shard_map``.  The sum is one value that every rank
    of the axes holds and uses once, so the backward passes each rank's
    cotangent through to its own summand (``torch.distributed.nn.functional.
    all_reduce`` would sum the cotangents, counting that value once a rank)."""
    for a in _axis_list(axes):
        x = _SumOverRanks.apply(x, mesh.group(a))
    return x


def pvary(x: torch.Tensor, mesh: AbstractMesh, axes) -> torch.Tensor:
    """``x``, a value every rank of ``axes`` holds alike, as the input of work
    that differs by rank (each rank's experts): the identity, whose backward
    sums the ranks' cotangents, so every rank gets the whole gradient of
    ``x``.  ``shard_map`` inserts this (``pvary``) where a replicated value
    meets a sharded one, and transposes it to a ``psum``."""
    for a in _axis_list(axes):
        x = _SharedInput.apply(x, mesh.group(a))
    return x


def pmean_replicas(x: torch.Tensor, mesh: AbstractMesh, axes) -> torch.Tensor:
    """The mean over ``axes`` of ``x``, a value each rank adds to its own loss
    (a data-parallel replica's term): the backward sums the ranks' cotangents
    too, so averaging the gradients over ``axes`` gives the gradient of the
    mean loss (``torch.distributed.nn.functional.all_reduce``'s gradient)."""
    axes = _axis_list(axes)
    n = math.prod(mesh.sizes[a] for a in axes)
    return pvary(psum(x, mesh, axes), mesh, axes) / n
