"""RG-LRU scan op of the recurrent blocks: CUDA tensors -> the kernel, tensors
on any other device or ``impl="plain"`` -> the plain PyTorch version; DTensors -> the
same on each rank's local rows and ``rnn`` columns (``local_map``: the
recurrence runs along the sequence, which stays whole); meta tensors ->
shapes and the plain version's FLOPs (:mod:`repro_torch.kernels.meta`).  The
decode step is plain."""

from __future__ import annotations

from repro_torch.kernels import check_impl, meta
from repro_torch.kernels.rglru_scan import kernel, ref
from repro_torch.parallel import sharding as S


def rglru_scan(log_a, gated_x, *, impl=None):
    check_impl(impl)
    fn = (meta.rglru_scan_shapes if meta.on_meta(log_a)
          else kernel.rglru_scan if impl is None and log_a.device.type == "cuda" else ref.rglru_scan)
    if not S.is_placed(log_a):
        return fn(log_a, gated_x)
    from torch.distributed.tensor import Shard

    log_a = S.keep_shards(log_a, (0, 2))
    gated_x = gated_x.redistribute(log_a.device_mesh, log_a.placements)
    last = tuple(Shard(1) if p == Shard(2) else p for p in log_a.placements)  # h_last (B, W)
    return S.local_call(lambda a, x: fn(a.contiguous(), x.contiguous()), (log_a, gated_x),
                        (tuple(log_a.placements), last))


rglru_step = ref.rglru_step
