"""Production mesh definitions (the port of :mod:`repro.launch.mesh`).

Functions, not module-level constants: importing this module starts no
process group.  The production meshes span 256 and 512 ranks; on a machine
with fewer devices they exist on torch's fake process group
(:func:`fake_world`), which runs every collective as a no-op in one process:
enough for specs, shapes and a dry run, not for values (:func:`fake_mesh`
builds a mesh on it for meta tensors).
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist

from repro_torch.parallel.sharding import make_compat_mesh


def production_layout(*, multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The production mesh's shape and axis names: 16 x 16 = 256 ranks a pod
    (``data``, ``model``); two pods, 512 ranks (``pod``, ``data``,
    ``model``), multi-pod."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh (:func:`production_layout`).  Needs a process group
    of its world size (``device_type`` as :func:`make_compat_mesh` takes it:
    the card unless ``"cpu"``)."""
    return make_compat_mesh(*production_layout(multi_pod=multi_pod), device_type=device_type)


def mesh_chip_count(mesh) -> int:
    return math.prod(mesh.shape)


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """This process as rank ``rank`` of a fake process group of
    ``world_size`` ranks (``backend="fake"``), for the length of the context."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over :func:`fake_world` (this process as
    rank 0 of ``prod(shape)`` ranks), for the length of the context: a mesh for
    DTensors whose local shards are meta tensors (a dry run).  Its collectives
    move nothing; on meta tensors they give their outputs' shapes.  Its device
    type is the CPU's: DTensor then moves a tensor from one split dimension to
    another by gathering it whole and cutting (gloo has no all-to-all), where
    a card's mesh sends an all-to-all."""
    with fake_world(math.prod(shape)):
        yield make_compat_mesh(shape, axes, device_type="cpu")
