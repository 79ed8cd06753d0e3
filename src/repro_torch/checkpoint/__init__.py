"""Fault-tolerance substrate: atomic, async, int8-quantized checkpointing with
typed corruption detection, in the JAX package's on-disk format."""

from repro_torch.checkpoint.manager import (
    CheckpointCorruptionError,
    CheckpointManager,
    CheckpointMeta,
)

__all__ = ["CheckpointCorruptionError", "CheckpointManager", "CheckpointMeta"]
