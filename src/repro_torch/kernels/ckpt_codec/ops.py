"""Checkpoint codec op: CUDA tensors -> the kernel, tensors on any other
device or ``impl="plain"`` -> the plain PyTorch version.

``quantize`` runs

  * on a CUDA tensor, the hand-written kernel
    (:func:`repro_torch.kernels.ckpt_codec.kernel.quantize`) -- it launches or
    raises;
  * on a tensor on any other device, the plain PyTorch version
    (:func:`ref.quantize`);
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
    return (kernel.quantize if impl is None and x.device.type == "cuda" else ref.quantize)(x, block)


dequantize = ref.dequantize
