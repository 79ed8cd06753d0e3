"""Launch wrapper of the hand-written CUDA RG-LRU scan kernel.

:func:`rglru_scan` takes log_a and gated_x ``(B, S, W)`` float32.  On CUDA
tensors it launches ``rglru_scan_launch`` of ``csrc/rglru_scan.cu`` on the
current stream, or raises.  When W is a multiple of 4 and the tensors start on
16-byte boundaries (the served width 4096), a block takes 32 channels over
all of S in time chunks staged through shared memory by TMA: elementwise
warps turn each chunk into (a, beta * x), one warp walks the chain h = a * h +
beta * x, and h leaves by TMA stores.  Other widths take one thread per
channel.  Both round every operation as the plain version does, so their
outputs equal it bit for bit; see the note at the top of the source.  On CPU
tensors it runs the plain PyTorch version
(:func:`repro_torch.kernels.rglru_scan.ref.rglru_scan`).  Nothing falls back
from the kernel to the plain version.  The scan starts from a zero state, as
the TPU kernel does.

:func:`rglru_scan` is :func:`prepare` followed by :func:`launch`;
:data:`launches` counts the kernel's launches in this process.

On CUDA the launch runs inside :class:`RGLRUScan`, a
``torch.autograd.Function`` whose backward recomputes
:func:`~repro_torch.kernels.rglru_scan.ref.rglru_scan` and differentiates it.
This is no fallback: the kernel always runs the forward.  :func:`prepare`
raises when it is reached outside the Function with inputs that require grad.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._launch import (
    I64, PTR, Launch, c_function, call, check, check_graph, recompute_grads, require_cuda, stream,
)
from repro_torch.kernels.rglru_scan import ref

#: Kernel launches in this process (incremented once per launch, nowhere else).
launches = 0

# rglru_scan_launch's parameters, in order
_ARGTYPES = [PTR] * 4 + [I64] * 3 + [PTR]


def rglru_scan(log_a, gated_x):
    """Returns h ``(B, S, W)`` and h_last ``(B, W)``, both float32."""
    if log_a.device.type == "cpu":
        return ref.rglru_scan(log_a, gated_x)
    return RGLRUScan.apply(log_a, gated_x)


class RGLRUScan(torch.autograd.Function):
    """Forward: the kernel.  Backward: the gradient of the plain scan,
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, log_a, gated_x):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(log_a, gated_x)
        return launch(prepare(log_a, gated_x))

    @staticmethod
    def backward(ctx, grad_h, grad_h_last):
        return recompute_grads("rglru_scan", ref.rglru_scan, ctx.saved_tensors, ctx.needs_input_grad,
                               (grad_h, grad_h_last))


def prepare(log_a, gated_x) -> Launch:
    """Check the CUDA inputs of :func:`rglru_scan`, allocate its outputs and
    bind the launch's arguments; raises on anything the kernel cannot run."""
    dev = require_cuda("rglru_scan", log_a)
    check_graph("rglru_scan", log_a, gated_x)
    if log_a.dim() != 3:
        raise ValueError(f"log_a must be (B, S, W), got {tuple(log_a.shape)}")
    B, S, W = log_a.shape
    check("log_a", log_a, torch.float32, (B, S, W), dev)
    check("gated_x", gated_x, torch.float32, (B, S, W), dev)
    if min(B, S, W) < 1:
        raise ValueError(f"empty scan {tuple(log_a.shape)}")
    h = torch.empty((B, S, W), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, W), dtype=torch.float32, device=dev)
    args = (log_a.data_ptr(), gated_x.data_ptr(), h.data_ptr(), h_last.data_ptr(), B, S, W, stream(dev))
    return Launch(c_function("rglru_scan_launch", _ARGTYPES), args, (log_a, gated_x), (h, h_last))


def launch(job: Launch):
    """Launch a prepared scan on the stream it was prepared for; returns
    ``(h, h_last)``.  Raises on a nonzero ``cudaGetLastError()``."""
    global launches
    outs = call("rglru_scan", job)
    launches += 1
    return outs
