"""Gradient compression with error feedback (the port of :mod:`repro.optim.compress`).

int8 block-quantized gradients with an error-feedback residual (the
1-bit-Adam / EF-SGD family): each gradient leaf, plus the residual the last
step left, is quantized per 256-element block to int8 with one float32 scale
and dequantized again; what the quantization lost is carried to the next
step.  Used between the backward pass and the optimizer::

    grads_q, comp_state = compressed_grad_transform(grads, comp_state)

Every operation is the JAX package's, in its order and precision, on the
gradients' device, so ``q``, the dequantized gradient and the residual equal
the JAX package's bit for bit:

    scale = max |x| / 127 (clamped at 1e-12),  q = clip(round(x / scale), -127, 127)

(``round`` half to even, as ``jnp.round``).  The division by 127 divides by a
tensor: on CUDA, PyTorch's division by a Python scalar multiplies by its
reciprocal, which differs from the quotient by an ulp on some values.  No
Pallas kernel runs here in the JAX package (it is elementwise ``jnp`` and one
block max), so torch operations are its counterpart.  This is not the
checkpoint codec's quantization (:mod:`repro_torch.kernels.ckpt_codec`), which
clamps ``max |x|`` before it divides.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.checkpoint import tree as tree_lib

BLOCK = 256


@dataclasses.dataclass
class CompressionState:
    residual: dict  # the same tree as the gradients, float32 leaves


def compress_gradients_init(params) -> CompressionState:
    leaves, treedef = tree_lib.flatten(params)
    return CompressionState(residual=treedef.unflatten(
        [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]))


def quantize_blocks(x: torch.Tensor):
    """float32 x -> ``(q (n_blocks, 256) int8, scale (n_blocks, 1) float32)``:
    x flattened and padded with zeros to whole blocks."""
    flat = x.reshape(-1)
    fp = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    m = fp.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(m / torch.full_like(m, 127.0), 1e-12)
    q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_dequantize(x: torch.Tensor):
    """int8 block quantize, then dequantize: ``(dq, x - dq)`` for float32 x."""
    q, scale = quantize_blocks(x)
    dq = (q.float() * scale).reshape(-1)[: x.numel()].reshape(x.shape)
    return dq, x - dq


def compressed_grad_transform(grads, state: CompressionState):
    """Error-feedback int8 compression of every gradient leaf: returns the
    dequantized gradients (each in its leaf's dtype) and the new state."""
    flat_g, treedef = tree_lib.flatten(grads)
    flat_r = tree_lib.leaves(state.residual)
    if len(flat_r) != len(flat_g):
        raise ValueError(f"the residual holds {len(flat_r)} leaves, the gradients {len(flat_g)}")
    new_g, new_r = [], []
    for g, r in zip(flat_g, flat_r):
        dq, err = quantize_dequantize(g.float() + r)
        new_g.append(dq.to(g.dtype))
        new_r.append(err)
    return treedef.unflatten(new_g), CompressionState(residual=treedef.unflatten(new_r))
