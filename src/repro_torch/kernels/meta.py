"""The model kernels on the meta device: shapes, and the FLOPs of their plain versions.

A dry run (:mod:`repro_torch.launch.dryrun`) runs the models on meta tensors,
which have shapes and dtypes but no storage.  There the flash-attention,
RG-LRU and SSM scan ops call the shape-only operators of this module in
place of their kernels: each returns empty outputs of the right shapes and
dtypes and never runs the plain version (the scans' plain versions loop over
time in Python: 32,768 steps a layer at a 32k prompt).  Each is a
``torch.library`` operator with a FLOP formula
(:func:`torch.utils.flop_counter.register_flop_formula`), so a FLOP counter
over the run counts the work the plain version does:

  * attention: ``4 * B * H * D * q_block * kv_block`` for every (q block, kv
    block) tile :func:`repro_torch.kernels.flash_attention.ref.block_attention`
    visits (``Q K^T`` and ``P V``, two FLOPs a multiply-add; the lengths
    padded to their blocks as there, masked tiles skipped);
  * RG-LRU scan: ``5 * B * S * W`` (``a^2``, ``1 - a^2``, ``a h``, ``beta x``
    and their sum; ``exp`` and ``sqrt`` are transcendentals, not counted);
  * SSM scan: ``4 * B * S * D * N`` (``exp(dtA) h + dBx``, ``h C`` and the sum
    over N).

Each has a backward operator (shapes of the inputs' gradients) counted as
three forwards: the kernels' backward recomputes the plain forward and
differentiates it (:func:`repro_torch.kernels._launch.recompute_grads`),
whose products are twice the forward's.  On any other device the operators
raise: they only describe work.
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention.ref import _tile_visible

#: The backward's FLOPs as a multiple of the forward's (recompute + gradient).
BACKWARD_FACTOR = 3


def _shapes_only(*_args, **_kwargs):
    raise RuntimeError("a shape-only operator: it runs on meta tensors (a dry run) only")


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::attention_shapes", mutates_args=())
def attention_shapes(q: Tensor, k: Tensor, v: Tensor, causal: bool, window: int, q_offset: int, q_block: int,
                     kv_block: int) -> Tensor:
    _shapes_only()


@attention_shapes.register_fake
def _(q, k, v, causal, window, q_offset, q_block, kv_block):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::attention_shapes_grad", mutates_args=())
def attention_shapes_grad(q: Tensor, k: Tensor, v: Tensor, grad: Tensor, causal: bool, window: int, q_offset: int,
                          q_block: int, kv_block: int) -> tuple[Tensor, Tensor, Tensor]:
    _shapes_only()


@attention_shapes_grad.register_fake
def _(q, k, v, grad, causal, window, q_offset, q_block, kv_block):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _attention_setup(ctx, inputs, output):
    q, k, v, *rest = inputs
    ctx.save_for_backward(q, k, v)
    ctx.rest = rest


def _attention_backward(ctx, grad):
    return (*attention_shapes_grad(*ctx.saved_tensors, grad, *ctx.rest), None, None, None, None, None)


attention_shapes.register_autograd(_attention_backward, setup_context=_attention_setup)


def attention_flops(q_shape, k_shape, causal, window, q_offset, q_block, kv_block) -> int:
    """The FLOPs of ``block_attention`` on these shapes (see the module's note)."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    qb, kb = min(q_block, sq), min(kv_block, sk)
    nq, nk = -(-sq // qb), -(-sk // kb)
    tiles = sum(_tile_visible(i, j, qb, kb, causal, window, q_offset) for i in range(nq) for j in range(nk))
    return 4 * b * h * d * qb * kb * tiles


@register_flop_formula(torch.ops.repro_torch.attention_shapes)
def _(q, k, v, causal, window, q_offset, q_block, kv_block, *args, out_shape=None, **kwargs) -> int:
    return attention_flops(q, k, causal, window, q_offset, q_block, kv_block)


@register_flop_formula(torch.ops.repro_torch.attention_shapes_grad)
def _(q, k, v, grad, causal, window, q_offset, q_block, kv_block, *args, out_shape=None, **kwargs) -> int:
    return BACKWARD_FACTOR * attention_flops(q, k, causal, window, q_offset, q_block, kv_block)


def flash_attention(q, k, v, *, causal=True, window=0, q_block=1024, kv_block=1024, q_offset=0):
    """The flash-attention op's meta path: an output of q's shape and dtype."""
    return attention_shapes(q, k, v, causal, window, q_offset, q_block, kv_block)


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::rglru_scan_shapes", mutates_args=())
def rglru_scan_shapes(log_a: Tensor, gated_x: Tensor) -> tuple[Tensor, Tensor]:
    _shapes_only()


@rglru_scan_shapes.register_fake
def _(log_a, gated_x):
    b, s, w = log_a.shape
    return log_a.new_empty((b, s, w), dtype=torch.float32), log_a.new_empty((b, w), dtype=torch.float32)


@torch.library.custom_op("repro_torch::rglru_scan_shapes_grad", mutates_args=())
def rglru_scan_shapes_grad(log_a: Tensor, gated_x: Tensor, grad_h: Tensor) -> tuple[Tensor, Tensor]:
    _shapes_only()


@rglru_scan_shapes_grad.register_fake
def _(log_a, gated_x, grad_h):
    return torch.empty_like(log_a), torch.empty_like(gated_x)


def _rglru_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _rglru_backward(ctx, grad_h, grad_last):
    return rglru_scan_shapes_grad(*ctx.saved_tensors, grad_h)


rglru_scan_shapes.register_autograd(_rglru_backward, setup_context=_rglru_setup)


@register_flop_formula(torch.ops.repro_torch.rglru_scan_shapes)
def _(log_a, gated_x, *args, out_shape=None, **kwargs) -> int:
    return 5 * log_a[0] * log_a[1] * log_a[2]


@register_flop_formula(torch.ops.repro_torch.rglru_scan_shapes_grad)
def _(log_a, gated_x, grad_h, *args, out_shape=None, **kwargs) -> int:
    return BACKWARD_FACTOR * 5 * log_a[0] * log_a[1] * log_a[2]


# ---------------------------------------------------------------------------
# SSM scan
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::ssm_scan_shapes", mutates_args=())
def ssm_scan_shapes(dtA: Tensor, dBx: Tensor, C: Tensor) -> tuple[Tensor, Tensor]:
    _shapes_only()


@ssm_scan_shapes.register_fake
def _(dtA, dBx, C):
    b, s, d, n = dtA.shape
    return dtA.new_empty((b, s, d), dtype=torch.float32), dtA.new_empty((b, d, n), dtype=torch.float32)


@torch.library.custom_op("repro_torch::ssm_scan_shapes_grad", mutates_args=())
def ssm_scan_shapes_grad(dtA: Tensor, dBx: Tensor, C: Tensor, grad_y: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    _shapes_only()


@ssm_scan_shapes_grad.register_fake
def _(dtA, dBx, C, grad_y):
    return torch.empty_like(dtA), torch.empty_like(dBx), torch.empty_like(C)


def _ssm_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _ssm_backward(ctx, grad_y, grad_last):
    return ssm_scan_shapes_grad(*ctx.saved_tensors, grad_y)


ssm_scan_shapes.register_autograd(_ssm_backward, setup_context=_ssm_setup)


@register_flop_formula(torch.ops.repro_torch.ssm_scan_shapes)
def _(dtA, dBx, C, *args, out_shape=None, **kwargs) -> int:
    b, s, d, n = dtA
    return 4 * b * s * d * n


@register_flop_formula(torch.ops.repro_torch.ssm_scan_shapes_grad)
def _(dtA, dBx, C, grad_y, *args, out_shape=None, **kwargs) -> int:
    b, s, d, n = dtA
    return BACKWARD_FACTOR * 4 * b * s * d * n


def on_meta(x) -> bool:
    """Does ``x`` (a DTensor: its local shard) lie on the meta device?"""
    return (x.to_local() if hasattr(x, "to_local") else x).device.type == "meta"
