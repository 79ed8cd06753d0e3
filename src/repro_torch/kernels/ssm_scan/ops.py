"""SSM scan op of the Mamba blocks: CUDA tensors -> the kernel, tensors on
any other device or ``impl="plain"`` -> the plain PyTorch version; DTensors -> the same on
each rank's local rows and channels (``local_map``; C, which has no channel
dimension, is whole on every rank, and its gradient is each rank's part of
the sum over channels); meta tensors -> shapes and the plain version's
FLOPs (:mod:`repro_torch.kernels.meta`).  The decode step is plain."""

from __future__ import annotations

from repro_torch.kernels import check_impl, meta
from repro_torch.kernels.ssm_scan import kernel, ref
from repro_torch.parallel import sharding as S


def ssm_scan(dtA, dBx, C, *, impl=None):
    check_impl(impl)
    fn = (meta.ssm_scan_shapes if meta.on_meta(dtA)
          else kernel.ssm_scan if impl is None and dtA.device.type == "cuda" else ref.ssm_scan)
    if not S.is_placed(dtA):
        return fn(dtA, dBx, C)
    from torch.distributed.tensor import Partial, Replicate, Shard

    dtA = S.keep_shards(dtA, (0, 2))  # (B, S, D, N): rows and channels
    mesh, pl = dtA.device_mesh, tuple(dtA.placements)
    dBx = dBx.redistribute(mesh, pl)
    c_pl = tuple(p if p == Shard(0) else Replicate() for p in pl)  # C (B, S, N)
    C = C.redistribute(mesh, c_pl)
    y_pl = pl  # y (B, S, D)
    h_pl = tuple(Shard(1) if p == Shard(2) else p for p in pl)  # h_last (B, D, N)
    c_grad = tuple(Partial() if p == Shard(2) else c for p, c in zip(pl, c_pl))  # each rank's channels' part
    return S.local_call(lambda a, x, c: fn(a.contiguous(), x.contiguous(), c.contiguous()), (dtA, dBx, C),
                        (y_pl, h_pl), (pl, pl, c_grad))


ssm_step = ref.ssm_step
