"""Launch wrapper of the hand-written CUDA flash-attention kernel.

:func:`flash_attention` takes q ``(B, Sq, H, D)`` and k / v ``(B, Sk, KV, D)``.
On CUDA tensors it launches ``flash_attention_launch`` of
``csrc/flash_attention.cu`` on the current stream, or raises.  The kernel runs
one block per (batch, kv head, q tile), the G query heads of a kv head as
rows of the tile.  bfloat16 at D in :data:`TMA_HEAD_DIMS` (the served models'
64, 112, 128 and 256; D = 112 in the D = 128 body, with the tensor maps' rows
112 columns long, so TMA zero-fills and clips the last 16) runs a warp-specialised body: one producer warp loads Q, K and V
by TMA (tensor maps encoded at each launch) into a ring of stages, and two
consumer warpgroups run ``wgmma`` products and the online softmax, with the
next tile's Q K^T issued before the current tile's softmax.  bfloat16 at D =
16 or 32 runs ``mma.sync`` tiles, float32 the FMA units; see the note at the
top of the source.  On CPU
tensors it runs the plain PyTorch version
(:func:`repro_torch.kernels.flash_attention.ref.block_attention`), because no
kernel runs there.  Nothing falls back from the kernel to the plain version.

:func:`flash_attention` is :func:`prepare` (input checks, output allocation)
followed by :func:`launch` (the bare launch); :data:`launches` counts the
kernel's launches in this process.

On CUDA the launch runs inside :class:`FlashAttention`, a
``torch.autograd.Function`` whose backward recomputes
:func:`~repro_torch.kernels.flash_attention.ref.block_attention` (with the
forward's ``q_block`` / ``kv_block`` and mask arguments) and differentiates
it.  This is no fallback: the kernel always runs the forward.  :func:`prepare`
raises when it is reached outside the Function with inputs that require grad.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels._launch import (
    F32, I64, PTR, Launch, c_function, call, check, check_graph, recompute_grads, require_cuda, stream,
)
from repro_torch.kernels.flash_attention import ref

#: Kernel launches in this process (incremented once per launch, nowhere else).
launches = 0

#: Head dims the kernel is built for.
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: bfloat16 head dims of the wgmma + TMA body (the others take mma.sync tiles).
TMA_HEAD_DIMS = (64, 112, 128, 256)
#: Query rows of a TMA block: 128 // G positions x G heads.
TMA_ROWS = 128
#: Keys of a kv tile of the TMA body by head dim (``TmaTile`` in the source).
TMA_KV_TILE = {64: 128, 112: 128, 128: 128, 256: 64}
#: Largest TMA coordinate (a signed 32-bit int) and grid rows of q tiles.
TMA_COORD_MAX, QTILES_MAX = 2**31 - 1, 65535
#: Largest G = H / KV (the query heads of a kv head share a block's rows), ``kMaxGroup``.
ROWS = 64
#: Input dtypes and their codes in the source; the output has q's dtype.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# flash_attention_launch's parameters, in order
_ARGTYPES = [PTR] * 4 + [I64] * 10 + [F32, PTR]


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0, q_block=1024, kv_block=1024):
    """Attention of q over k / v, returned in q's dtype.

    ``q_block`` / ``kv_block`` are the plain version's tiles; the kernel has
    its own.
    """
    if q.device.type == "cpu":
        return ref.block_attention(
            q, k, v, causal=causal, window=window, q_block=q_block, kv_block=kv_block, q_offset=q_offset
        )
    return FlashAttention.apply(q, k, v, causal, window, q_offset, q_block, kv_block)


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel.  Backward: the gradient of the plain version,
    recomputed on the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_block, kv_block):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=q_block, kv_block=kv_block)
        return launch(prepare(q, k, v, causal=causal, window=window, q_offset=q_offset))

    @staticmethod
    def backward(ctx, grad_out):
        grads = recompute_grads(ref.block_attention, ctx.saved_tensors, ctx.needs_input_grad[:3], (grad_out,), **ctx.kw)
        return (*grads, None, None, None, None, None)


def prepare(q, k, v, *, causal=True, window=0, q_offset=0) -> Launch:
    """Check the CUDA inputs of :func:`flash_attention`, allocate its output
    and bind the launch's arguments; raises on anything the kernel cannot run."""
    dev = require_cuda("flash_attention", q)
    check_graph("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be 4-d (B, S, heads, D), got {tuple(q.shape)} and {tuple(k.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not supported; the kernel is built for {HEAD_DIMS}")
    check("q", q, tuple(DTYPES), (B, Sq, H, D), dev)
    check("k", k, q.dtype, (B, Sk, KV, D), dev)
    check("v", v, q.dtype, (B, Sk, KV, D), dev)
    if KV < 1 or H % KV or H // KV > ROWS:
        raise ValueError(f"{H} query heads over {KV} kv heads: need H % KV == 0 and H / KV <= {ROWS}")
    if min(B, Sq, Sk) < 1 or max(B, KV) > 65535:
        raise ValueError(f"unsupported sizes B={B}, Sq={Sq}, Sk={Sk}, KV={KV}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window ({window}) and q_offset ({q_offset}) must be >= 0")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernel loads 16 bytes at a time)")
    if q.dtype == torch.bfloat16 and D in TMA_HEAD_DIMS:
        check_tma(q, k, v, window=window, q_offset=q_offset)
    out = torch.empty_like(q)
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Sq, Sk, H, KV, D, int(bool(causal)), int(window), int(q_offset), DTYPES[q.dtype],
        1.0 / math.sqrt(D),
        stream(dev),
    )
    return Launch(c_function("flash_attention_launch", _ARGTYPES), args, (q, k, v), (out,))


def check_tma(q, k, v, *, window=0, q_offset=0) -> None:
    """Raise unless the TMA body can take q, k, v: each must start on a 16-byte
    boundary and have unit stride in D and strides of whole 16-byte units in the
    other dims (a tensor map's rules); positions, the window and the number of q
    tiles must fit the kernel's 32-bit coordinates and its grid.  Needs no card."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (TMA's alignment)")
        if x.stride(-1) != 1 or any(st * x.element_size() % 16 for st in x.stride()[:-1]):
            raise ValueError(f"{name} has strides {tuple(x.stride())}; TMA needs unit stride in D and "
                             "multiples of 16 bytes in the other dims")
    B, Sq, H, _ = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if max(Sq + q_offset, Sk, window, B * KV) > TMA_COORD_MAX:
        raise ValueError(f"positions (Sq + q_offset = {Sq + q_offset}, Sk = {Sk}), window {window} or "
                         f"B * KV = {B * KV} exceed the TMA body's 32-bit coordinates")
    positions = TMA_ROWS // (H // KV)
    if -(-Sq // positions) > QTILES_MAX:
        raise ValueError(f"Sq = {Sq} needs more than {QTILES_MAX} q tiles of {positions} positions")


def launch(job: Launch) -> torch.Tensor:
    """Launch a prepared attention on the stream it was prepared for; returns
    its output.  Raises on a nonzero ``cudaGetLastError()``."""
    global launches
    (out,) = call("flash_attention", job)
    launches += 1
    return out
