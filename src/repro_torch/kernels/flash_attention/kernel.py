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
top of the source.  On a tensor off the card it raises:
:mod:`repro_torch.kernels.flash_attention.ops` alone picks the kernel or the
plain version (:func:`repro_torch.kernels.flash_attention.ref.block_attention`),
and nothing falls back from the kernel to it.

:func:`flash_attention` is :func:`prepare` (input checks, output allocation)
followed by :func:`launch` (the bare launch); :data:`launches` counts the
kernel's launches in this process.

The launch runs inside :class:`FlashAttention`, a
``torch.autograd.Function``.  Its backward is chosen by what the inputs show
(:func:`backward_path`): bfloat16 CUDA tensors at D in
:data:`BACKWARD_HEAD_DIMS` whose every query row sees a key take the
hand-written backward kernel (``flash_attention_backward_launch``, from the
forward's output and its log-sum-exp, which the forward writes only then);
everything else (float32, D = 16, 32 or 256, a row that sees no key)
recomputes
:func:`~repro_torch.kernels.flash_attention.ref.block_attention` (with the
forward's ``q_block`` / ``kv_block`` and mask arguments) and differentiates
it.  Either way the kernel runs the forward.  :func:`prepare` raises when it
is reached outside the Function with inputs that require grad.
:func:`backward_prepare` / :func:`backward_launch` are the backward kernel's
checks and bare launch; :data:`backward_launches` counts its launches.
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
#: Backward kernel launches in this process (likewise).
backward_launches = 0

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
#: bfloat16 head dims of the backward kernel (D = 112 in the D = 128 layout, as the forward).
BACKWARD_HEAD_DIMS = (64, 112, 128)
#: Keys of a dK / dV block and query positions of its q tiles (``kBwdKeys``, ``kBwdQueries``);
#: the LSE / D workspace's rows are padded to the latter.
BACKWARD_KEYS, BACKWARD_QUERIES = 128, 64
#: Blocks the dK / dV grid asks for before it splits a kv head's query heads further: three
#: for each of the H100's 132 SMs.
BACKWARD_BLOCKS = 3 * 132

# flash_attention_launch's and flash_attention_backward_launch's parameters, in order
_ARGTYPES = [PTR] * 5 + [I64] * 10 + [F32, PTR]
_BACKWARD_ARGTYPES = [PTR] * 11 + [I64] * 10 + [F32, PTR]


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0, q_block=1024, kv_block=1024):
    """Attention of q over k / v, returned in q's dtype.

    ``q_block`` / ``kv_block`` are the plain version's tiles; the kernel has
    its own.
    """
    return FlashAttention.apply(q, k, v, causal, window, q_offset, q_block, kv_block)


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel.  Backward: the backward kernel from the saved q, k,
    v, output and LSE where :func:`backward_path` says ``"kernel"``, else the
    gradient of the plain version, recomputed on the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_block, kv_block):
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=q_block, kv_block=kv_block)
        ctx.kernel_backward = any(ctx.needs_input_grad[:3]) and backward_path(
            q.device.type, q.dtype, q.shape[-1], sq=q.shape[1], sk=k.shape[1], window=window, q_offset=q_offset
        ) == "kernel"
        job = prepare(q, k, v, causal=causal, window=window, q_offset=q_offset, lse=ctx.kernel_backward)
        out = launch(job)
        ctx.save_for_backward(q, k, v, *((out, job.outs[1]) if ctx.kernel_backward else ()))
        return out

    @staticmethod
    def backward(ctx, grad_out):
        needs = ctx.needs_input_grad[:3]
        if ctx.kernel_backward:
            kw = {key: ctx.kw[key] for key in ("causal", "window", "q_offset")}
            grads = backward_launch(backward_prepare(*ctx.saved_tensors, grad_out.contiguous(), **kw))
            grads = tuple(g if n else None for g, n in zip(grads, needs))
        else:
            grads = recompute_grads("flash_attention", ref.block_attention, ctx.saved_tensors, needs, (grad_out,),
                                    **ctx.kw)
        return (*grads, None, None, None, None, None)


def sees_a_key(sq: int, sk: int, window: int, q_offset: int) -> bool:
    """Does every query row see at least one key?  Only a window can leave a row
    none: the last row, at ``q_offset + sq - 1``, sees keys above ``q_offset +
    sq - 1 - window``, and there are none when that is ``sk - 1`` or more
    (with or without the causal mask)."""
    return not window or q_offset + sq < sk + window


def backward_path(device_type: str, dtype: torch.dtype, head_dim: int, *, sq: int, sk: int, window: int = 0,
                  q_offset: int = 0) -> str:
    """Which backward :class:`FlashAttention` runs: ``"kernel"`` for bfloat16
    CUDA tensors at D in :data:`BACKWARD_HEAD_DIMS` whose every row sees a key,
    else ``"plain"`` (the recompute of :func:`ref.block_attention`)."""
    if (device_type == "cuda" and dtype == torch.bfloat16 and head_dim in BACKWARD_HEAD_DIMS
            and sees_a_key(sq, sk, window, q_offset)):
        return "kernel"
    return "plain"


def backward_groups(batch: int, kv_heads: int, group: int, sk: int) -> int:
    """Groups a kv head's ``group`` query heads are split into in the dK / dV
    grid: the fewest (a divisor of ``group``) that give
    :data:`BACKWARD_BLOCKS` blocks of (batch, kv head, group, key tile), else
    one a head.  Each group's dK / dV is a float32 partial, summed after."""
    base = batch * kv_heads * -(-sk // BACKWARD_KEYS)
    for n in range(1, group + 1):
        if group % n == 0 and base * n >= BACKWARD_BLOCKS:
            return n
    return group


def prepare(q, k, v, *, causal=True, window=0, q_offset=0, lse=False) -> Launch:
    """Check the CUDA inputs of :func:`flash_attention`, allocate its output
    (and with ``lse`` its float32 ``(B, H, Sq)`` log-sum-exp, the launch's
    second output) and bind the launch's arguments; raises on anything the
    kernel cannot run."""
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
    outs = (out, torch.empty((B, H, Sq), dtype=torch.float32, device=dev)) if lse else (out,)
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), outs[1].data_ptr() if lse else None,
        B, Sq, Sk, H, KV, D, int(bool(causal)), int(window), int(q_offset), DTYPES[q.dtype],
        1.0 / math.sqrt(D),
        stream(dev),
    )
    return Launch(c_function("flash_attention_launch", _ARGTYPES), args, (q, k, v), outs)


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
    its output (the LSE, when asked for, is ``job.outs[1]``).  Raises on a
    nonzero ``cudaGetLastError()``."""
    global launches
    out = call("flash_attention", job)[0]
    launches += 1
    return out


def backward_prepare(q, k, v, o, lse, do, *, causal=True, window=0, q_offset=0) -> Launch:
    """Check the inputs of the backward kernel (the forward's q, k, v, its
    output ``o`` and ``lse``, and ``do``, the output's gradient), allocate dq,
    dk, dv and the float32 workspaces, and bind the launch's arguments; raises
    on anything the kernel cannot run."""
    dev = require_cuda("flash_attention_backward", q)
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if backward_path(dev.type, q.dtype, D, sq=Sq, sk=Sk, window=window, q_offset=q_offset) != "kernel":
        raise ValueError(f"the backward kernel takes bfloat16 at D in {BACKWARD_HEAD_DIMS} with a key for every "
                         f"row, got {q.dtype}, D = {D}, Sq = {Sq}, Sk = {Sk}, window {window}, q_offset {q_offset}")
    for name, x in (("q", q), ("o", o), ("do", do)):
        check(name, x, torch.bfloat16, (B, Sq, H, D), dev)
    for name, x in (("k", k), ("v", v)):
        check(name, x, torch.bfloat16, (B, Sk, KV, D), dev)
    check("lse", lse, torch.float32, (B, H, Sq), dev)
    if KV < 1 or H % KV or H // KV > ROWS or max(B, KV) > 65535:
        raise ValueError(f"unsupported heads {H} over {KV} kv heads or batch {B}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"window ({window}) and q_offset ({q_offset}) must be >= 0")
    check_tma(q, k, v, window=window, q_offset=q_offset)
    for name, x in (("o", o), ("do", do)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (TMA's alignment)")
    if -(-Sk // BACKWARD_KEYS) > QTILES_MAX:
        raise ValueError(f"Sk = {Sk} needs more than {QTILES_MAX} key tiles of {BACKWARD_KEYS}")
    groups = backward_groups(B, KV, H // KV, Sk)
    sq_pad = -(-Sq // BACKWARD_QUERIES) * BACKWARD_QUERIES
    stats = torch.empty((B * H, 2, sq_pad), dtype=torch.float32, device=dev)
    part = torch.empty((2, groups, B, Sk, KV, D), dtype=torch.float32, device=dev) if groups > 1 else None
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    args = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), do.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), None if part is None else part.data_ptr(),
        B, Sq, Sk, H, KV, D, int(bool(causal)), int(window), int(q_offset), groups,
        1.0 / math.sqrt(D),
        stream(dev),
    )
    keep = (q, k, v, o, lse, do, stats) + (() if part is None else (part,))
    return Launch(c_function("flash_attention_backward_launch", _BACKWARD_ARGTYPES), args, keep, (dq, dk, dv))


def backward_launch(job: Launch) -> tuple:
    """Launch a prepared backward on the stream it was prepared for; returns
    ``(dq, dk, dv)``.  Raises on a nonzero ``cudaGetLastError()``."""
    global backward_launches
    grads = call("flash_attention_backward", job)
    backward_launches += 1
    return grads
