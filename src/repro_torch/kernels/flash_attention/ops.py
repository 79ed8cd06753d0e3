"""Attention ops of the models: prefill through the kernel, decode plain.

``flash_attention`` runs

  * on CUDA tensors, the hand-written kernel
    (:func:`repro_torch.kernels.flash_attention.kernel.flash_attention`) --
    it launches or raises;
  * on tensors on any other device, the plain PyTorch version
    (:func:`ref.block_attention`);
  * with ``impl="plain"``, the plain version on whatever device the tensors
    are on (the yardstick the kernel is held to on the card);
  * on meta tensors (a dry run), shapes and the plain version's FLOPs
    (:mod:`repro_torch.kernels.meta`), whatever ``impl`` asks for.

On DTensors (placed by the logical-axes rules) it runs on each rank's local
shards (``local_map``): its rows of the batch and its query heads, each head
against its own kv head.  ``decode_attention`` (one token against the cache)
has no kernel in the JAX package either and is always the plain version
(:func:`on_local_heads` runs it, and the cross-attention's
``naive_attention``, on placed shards too).
"""

from __future__ import annotations

from repro_torch.kernels import check_impl, meta
from repro_torch.kernels.flash_attention import kernel, ref
from repro_torch.parallel import sharding as S


def flash_attention(q, k, v, *, causal=True, window=0, q_block=1024, kv_block=1024, q_offset=0, impl=None):
    check_impl(impl)
    fn = (meta.flash_attention if meta.on_meta(q)
          else kernel.flash_attention if impl is None and q.device.type == "cuda" else ref.block_attention)
    kw = dict(causal=causal, window=window, q_block=q_block, kv_block=kv_block, q_offset=q_offset)
    if S.is_placed(q):
        return on_local_heads(fn, q, k, v, **kw)
    return fn(q, k, v, **kw)


def on_local_heads(fn, q, k, v, **kw):
    """``fn`` on each rank's local q ``(B, S, H, D)`` and k / v ``(B, S, KV,
    D)`` shards, split over the batch and the heads only.  Where the kv heads
    are whole (GQA with fewer kv heads than ranks on the axis) but the q heads
    split, a rank's q heads ``[q0, q0 + h)`` meet the kv heads ``(q0 + i) //
    G`` of the global index: their run of k / v is cut out (or, when the
    heads do not group evenly, each q head gets its own copy), and the
    gradient of k / v is each rank's part of the sum (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    q = S.keep_shards(q, (0, 2))
    # k / v: split over the batch where q is, over the heads where q is and they divide, else whole
    kv_pl = tuple(qp if qp == Shard(0) or qp == Shard(2) and kp == qp else Replicate()
                  for qp, kp in zip(q.placements, k.placements))
    k, v = (x if tuple(x.placements) == kv_pl else x.redistribute(x.device_mesh, kv_pl) for x in (k, v))
    H, KV = q.shape[2], k.shape[2]
    G = H // KV
    q_index, q_count = S.split_index(q, 2)
    kv_index, kv_count = S.split_index(k, 2)
    h, kvl = H // q_count, KV // kv_count
    first = [(q_index * h + i) // G - kv_index * kvl for i in range(h)]
    lo, n = first[0], first[-1] - first[0] + 1
    grouped = h % n == 0 and first == [lo + i // (h // n) for i in range(h)]

    def local(ql, kl, vl):
        if grouped:
            kl, vl = kl[:, :, lo:lo + n], vl[:, :, lo:lo + n]
        else:
            kl, vl = kl[:, :, first], vl[:, :, first]
        return fn(ql.contiguous(), kl.contiguous(), vl.contiguous(), **kw)

    kv_grad = tuple(Partial() if isinstance(kp, Replicate) and isinstance(qp, Shard) else kp
                    for qp, kp in zip(q.placements, k.placements))
    return S.local_call(local, (q, k, v), tuple(q.placements), (tuple(q.placements), kv_grad, kv_grad))


decode_attention = ref.decode_attention
