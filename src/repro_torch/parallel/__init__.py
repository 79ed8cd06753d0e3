"""Distribution substrate: mesh conventions, logical-axis sharding rules, the
placement of whole tensors by them (DTensor), and the explicit
sequence-parallel decode (the port of :mod:`repro.parallel`)."""

from repro_torch.parallel.sharding import (
    DEFAULT_RULES,
    AbstractMesh,
    PartitionSpec,
    active_abstract_mesh,
    axis_rules,
    current_rules,
    gather,
    is_placed,
    logical_sharding,
    make_compat_mesh,
    place,
    shard,
    shard_params,
    use_compat_mesh,
)

__all__ = [
    "DEFAULT_RULES",
    "AbstractMesh",
    "PartitionSpec",
    "active_abstract_mesh",
    "axis_rules",
    "current_rules",
    "gather",
    "is_placed",
    "logical_sharding",
    "make_compat_mesh",
    "place",
    "shard",
    "shard_params",
    "use_compat_mesh",
]
