"""The Mamba-1 scan's inputs: CUDA tensors -> the kernel, tensors on any other
device or ``impl="plain"`` -> the plain PyTorch version; meta tensors (a dry
run), placed or not -> the plain version, whose element-wise work counts no
FLOPs; DTensors -> the same on each rank's local rows and channels
(``local_map``: the bias and ``A_log`` split with the channels, B whole along
them on every rank; the bias's and ``A_log``'s gradients each rank's part of
the sum over rows, B's each rank's part of the sum over channels).  Prefill
and the decode step run it alike."""

from __future__ import annotations

from repro_torch.kernels import check_impl, meta
from repro_torch.kernels.mamba_inputs import kernel, ref
from repro_torch.parallel import sharding as S


def mamba_inputs(dt_pre, dt_bias, A_log, x_act, bmat, *, impl=None):
    """``(dtA, dBx)`` of the scan (see :mod:`repro_torch.kernels.mamba_inputs.ref`)."""
    check_impl(impl)
    if meta.on_meta(dt_pre):
        return ref.mamba_inputs(dt_pre, dt_bias, A_log, x_act, bmat)
    fn = kernel.mamba_inputs if impl is None and dt_pre.device.type == "cuda" else ref.mamba_inputs
    if not S.is_placed(dt_pre):
        return fn(dt_pre, dt_bias, A_log, x_act, bmat)
    from torch.distributed.tensor import Partial, Replicate, Shard

    dt_pre = S.keep_shards(dt_pre, (0, 2))  # (B, S, D): rows and channels
    mesh, pl = dt_pre.device_mesh, tuple(dt_pre.placements)
    x_act = x_act.redistribute(mesh, pl)
    ch_pl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in pl)  # the bias (D,), A_log (D, N)
    b_pl = tuple(p if p == Shard(0) else Replicate() for p in pl)  # B (B, S, N)
    dt_bias, A_log = dt_bias.redistribute(mesh, ch_pl), A_log.redistribute(mesh, ch_pl)
    bmat = bmat.redistribute(mesh, b_pl)
    ch_grad = tuple(Partial() if p == Shard(0) else c for p, c in zip(pl, ch_pl))  # each rank's rows' part
    b_grad = tuple(Partial() if p == Shard(2) else b for p, b in zip(pl, b_pl))  # each rank's channels' part
    return S.local_call(lambda p, bias, a, x, b: fn(p.contiguous(), bias.contiguous(), a.contiguous(),
                                                     x.contiguous(), b.contiguous()),
                        (dt_pre, dt_bias, A_log, x_act, bmat), (pl, pl), (pl, ch_grad, ch_grad, pl, b_grad))
