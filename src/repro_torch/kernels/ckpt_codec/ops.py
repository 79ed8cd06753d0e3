"""Checkpoint codec op: CUDA tensors -> the kernel, CPU tensors or
``impl="plain"`` -> the plain PyTorch version.

``quantize`` runs

  * on a CUDA tensor, the hand-written kernel
    (:func:`repro_torch.kernels.ckpt_codec.kernel.quantize`) -- it launches or
    raises;
  * on a CPU tensor, the plain PyTorch version (:func:`ref.quantize`);
  * with ``impl="plain"``, the plain version on whatever device the tensor is
    on (the yardstick the kernel is held to on the card).

``dequantize`` has no kernel in the JAX package either and is always plain.
"""

from __future__ import annotations

from repro_torch.kernels import check_impl
from repro_torch.kernels.ckpt_codec import kernel, ref

BLOCK = ref.BLOCK


def quantize(x, block: int = BLOCK, *, impl=None):
    check_impl(impl)
    return (ref.quantize if impl == "plain" else kernel.quantize)(x, block)


dequantize = ref.dequantize
