"""Attention ops of the models: prefill through the kernel, decode plain.

``flash_attention`` runs

  * on CUDA tensors, the hand-written kernel
    (:func:`repro_torch.kernels.flash_attention.kernel.flash_attention`) --
    it launches or raises;
  * on CPU tensors, the plain PyTorch version (:func:`ref.block_attention`);
  * with ``impl="plain"``, the plain version on whatever device the tensors
    are on (the yardstick the kernel is held to on the card).

``decode_attention`` (one token against the cache) has no kernel in the JAX
package either and is always the plain version.
"""

from __future__ import annotations

from repro_torch.kernels import check_impl
from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q, k, v, *, causal=True, window=0, q_block=1024, kv_block=1024, q_offset=0, impl=None):
    check_impl(impl)
    fn = ref.block_attention if impl == "plain" else kernel.flash_attention
    return fn(q, k, v, causal=causal, window=window, q_block=q_block, kv_block=kv_block, q_offset=q_offset)


decode_attention = ref.decode_attention
