"""Plain PyTorch int8 block quantization: the yardstick of the CUDA codec kernel.

The same functions as :mod:`repro.kernels.ckpt_codec.ref`.  A float leaf is
flattened, widened to float32, padded with zeros to whole 256-element blocks,
and each block is stored as int8 with one float32 scale::

    scale = max(max |x|, 1e-12) / 127,   q = clip(round(x / scale), -127, 127)

``round`` is half-to-even (``torch.round``, like ``jnp.round`` and the
kernel's ``rintf``).  Both divisions are IEEE divisions by a tensor: PyTorch's
CUDA ``div`` by a Python scalar multiplies by its reciprocal instead, which
differs from a division by one ulp on some values.  ``amax`` and ``clamp``
propagate NaN, so a block holding a NaN gets a NaN scale (its ``q`` is a cast of
NaN to int8, undefined here as in the JAX package).

The int8 codec shrinks a checkpoint ~4x against float32 (~2x against bf16),
and with it the checkpoint-write time t_c of the decision point
t_cd = t_h - t_c - t_w (paper Eq. 3).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

BLOCK = 256


def quantize(x: torch.Tensor, block: int = BLOCK):
    """x: any float tensor -> ``(q (n_blocks, block) int8, scales (n_blocks,)
    float32, shape)``."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    fp = F.pad(flat, (0, (-n) % block)).reshape(-1, block)
    m = torch.clamp_min(fp.abs().amax(dim=1), 1e-12)
    scales = m / torch.full_like(m, 127.0)
    q = torch.clamp(torch.round(fp / scales[:, None]), -127, 127).to(torch.int8)
    return q, scales, tuple(x.shape)


def dequantize(q: torch.Tensor, scales: torch.Tensor, shape, dtype=torch.float32) -> torch.Tensor:
    """The float32 products ``q * scale``, cut to ``shape`` and cast to ``dtype``."""
    n = math.prod(shape)
    flat = (q.float() * scales[:, None]).reshape(-1)[:n]
    return flat.reshape(tuple(shape)).to(dtype)


def quantization_error(x: torch.Tensor, block: int = BLOCK) -> float:
    """Largest round-trip error relative to ``max |x|``."""
    q, s, shape = quantize(x, block)
    xf = x.float()
    denom = float(xf.abs().max()) or 1.0
    return float((dequantize(q, s, shape) - xf).abs().max()) / denom
