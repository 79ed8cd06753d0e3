"""Production mesh definitions (the port of :mod:`repro.launch.mesh`).

Functions, not module-level constants: importing this module starts no
process group.  The production meshes span 256 and 512 ranks; on a machine
with fewer devices they exist on torch's fake process group
(:func:`fake_world`), which runs every collective as a no-op in one process:
enough for specs, shapes and a dry run, not for values.
"""

from __future__ import annotations

import contextlib
import math

import torch.distributed as dist

from repro_torch.parallel.sharding import make_compat_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16 x 16 = 256 ranks a pod (``data``, ``model``); two pods, 512 ranks
    (``pod``, ``data``, ``model``), multi-pod.  Needs a process group of that
    world size (``device_type`` as :func:`make_compat_mesh` takes it: the card
    unless ``"cpu"``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_compat_mesh(shape, axes, device_type=device_type)


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
