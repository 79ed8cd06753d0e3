"""DTensor's all-gather of CUDA tensors over gloo, built on gloo's ``all_reduce``.

DTensor redistributes through the functional collectives
(``torch.ops._c10d_functional``).  Over a gloo process group, the CUDA form
of ``all_gather_into_tensor`` crashes the process (a segmentation fault,
PyTorch 2.11 on the H100 machine), while its ``all_reduce``,
``reduce_scatter_tensor``, ``all_to_all_single`` and ``broadcast`` of CUDA
tensors give the right values (gloo stages them through the host).  NCCL,
which has them all, refuses two ranks on one card.  So, for the ranks of a
gloo group on CUDA tensors, :func:`install` replaces the CUDA kernel of
``all_gather_into_tensor`` with one built on ``dist.all_reduce``: each rank
writes its block into a zero buffer of the whole, and the ranks' buffers are
summed as 32-bit integers (bytes when the size is no multiple of 4): one
rank's bits and zeros elsewhere, so exact, -0.0 and NaN payloads included.  It moves ``group_size``
times the bytes of a ring all-gather.  The replacement is process-wide, so a
group of another backend (NCCL) goes on to its own all-gather
(``dist.all_gather_into_tensor``).

:data:`STATS` counts its calls and the bytes they sum, so a caller can name
them beside its own timings.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

@dataclasses.dataclass
class Stats:
    """``calls`` of the replaced all-gather in this process and the ``bytes``
    they summed through the all-reduce."""

    calls: int = 0
    bytes: int = 0


STATS = Stats()
_LIBS: dict[str, torch.library.Library] = {}


def install(device_type: str = "cuda") -> None:
    """Replace the ``all_gather_into_tensor`` kernel for ``device_type``'s
    tensors in this process (idempotent; ``"cpu"`` lets the CPU run the same
    form)."""
    key = {"cuda": "CUDA", "cpu": "CPU"}[device_type]
    if key not in _LIBS:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", all_gather_into_tensor, key)
        _LIBS[key] = lib


def all_gather_into_tensor(input: torch.Tensor, group_size: int, group_name) -> torch.Tensor:
    """The ranks' ``input`` blocks stacked along dimension 0, in rank order."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    group = group_name if isinstance(group_name, dist.ProcessGroup) else _resolve_process_group(group_name)
    x = input.contiguous()
    x = x.reshape(1) if x.dim() == 0 else x
    n = x.shape[0]
    if dist.get_backend(group) != "gloo":
        out = x.new_empty((group_size * n, *x.shape[1:]))
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor  # renamed in 2.13
        gather(out, x, group=group)
        return out
    out = x.new_zeros((group_size * n, *x.shape[1:]))
    out.narrow(0, dist.get_rank(group) * n, n).copy_(x)
    raw = out.reshape(-1).view(torch.uint8)  # gloo sums int32 and uint8 (not int16)
    bits = raw.view(torch.int32) if raw.numel() % 4 == 0 else raw
    dist.all_reduce(bits, op=dist.ReduceOp.SUM, group=group)
    STATS.calls += 1
    STATS.bytes += bits.numel() * bits.element_size()
    return out
