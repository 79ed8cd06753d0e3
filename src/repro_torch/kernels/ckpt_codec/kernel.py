"""Launch wrapper of the hand-written CUDA checkpoint-codec kernel.

:func:`quantize` takes a float32, bfloat16 or float16 tensor of any shape.  On
a CUDA tensor it launches ``ckpt_codec_quantize_launch`` of
``csrc/ckpt_codec.cu`` (one warp per 256-element block; see the note at the
top of the source) on the current stream, or raises, as it does on a tensor
off the card: :mod:`repro_torch.kernels.ckpt_codec.ops` alone picks the kernel
or the plain version (:func:`repro_torch.kernels.ckpt_codec.ref.quantize`),
and nothing falls back from the kernel to it.

:func:`quantize` is :func:`prepare` (input checks, output allocation)
followed by :func:`launch` (the bare launch); :data:`launches` counts the
kernel's launches in this process.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._launch import I32, I64, PTR, Launch, c_function, call, require_cuda, stream
from repro_torch.kernels.ckpt_codec import ref

#: Kernel launches in this process (incremented once per launch, nowhere else).
launches = 0

#: Input dtypes and their codes in the source.
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# ckpt_codec_quantize_launch's parameters, in order
_ARGTYPES = [PTR] * 3 + [I64, I64, I32, PTR]


def quantize(x: torch.Tensor, block: int = ref.BLOCK):
    """Returns ``(q (n_blocks, 256) int8, scales (n_blocks,) float32, shape)``."""
    return launch(prepare(x, block))


def prepare(x: torch.Tensor, block: int = ref.BLOCK) -> Launch:
    """Check the CUDA input of :func:`quantize`, allocate its outputs and bind
    the launch's arguments; raises on anything the kernel cannot run."""
    dev = require_cuda("ckpt_codec", x)
    if block != ref.BLOCK:
        raise ValueError(f"the kernel quantizes blocks of {ref.BLOCK} elements, not {block}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x has dtype {x.dtype}, expected one of {sorted(map(str, DTYPES))}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.numel() < 1:
        raise ValueError("x is empty")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel loads 16 bytes at a time)")
    n = x.numel()
    n_blocks = -(-n // block)
    q = torch.empty((n_blocks, block), dtype=torch.int8, device=dev)
    scales = torch.empty((n_blocks,), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), q.data_ptr(), scales.data_ptr(), n, n_blocks, DTYPES[x.dtype], stream(dev))
    return Launch(c_function("ckpt_codec_quantize_launch", _ARGTYPES), args, (x,), (q, scales, tuple(x.shape)))


def launch(job: Launch):
    """Launch a prepared quantization on the stream it was prepared for;
    returns ``(q, scales, shape)``.  Raises on a nonzero ``cudaGetLastError()``."""
    global launches
    outs = call("ckpt_codec", job)
    launches += 1
    return outs
