"""Launch wrapper of the hand-written CUDA Mamba-1 selective-scan kernel.

:func:`ssm_scan` takes dtA, dBx ``(B, S, D, N)`` float32 and C ``(B, S, N)``.
On CUDA tensors it launches ``ssm_scan_launch`` of ``csrc/ssm_scan.cu`` (one
lane per (b, d, n); see the note at the top of the source) on the current
stream, or raises; on CPU tensors it runs the plain PyTorch version
(:func:`repro_torch.kernels.ssm_scan.ref.ssm_scan`).  Nothing falls back from
the kernel to the plain version.  The scan starts from a zero state, as the
TPU kernel does.

:func:`ssm_scan` is :func:`prepare` followed by :func:`launch`;
:data:`launches` counts the kernel's launches in this process.

On CUDA the launch runs inside :class:`SSMScan`, a ``torch.autograd.Function``
whose backward recomputes :func:`~repro_torch.kernels.ssm_scan.ref.ssm_scan`
and differentiates it.  This is no fallback: the kernel always runs the
forward.  :func:`prepare` raises when it is reached outside the Function with
inputs that require grad.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._launch import (
    I64, PTR, Launch, c_function, call, check, check_graph, recompute_grads, require_cuda, stream,
)
from repro_torch.kernels.ssm_scan import ref

#: Kernel launches in this process (incremented once per launch, nowhere else).
launches = 0

#: State sizes N the kernel takes (the N lanes of a channel share a warp).
STATE_SIZES = (1, 2, 4, 8, 16, 32)
#: dtypes of C and their codes in the source.
C_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# ssm_scan_launch's parameters, in order
_ARGTYPES = [PTR] * 5 + [I64] * 5 + [PTR]


def ssm_scan(dtA, dBx, C):
    """Returns y ``(B, S, D)`` and h_last ``(B, D, N)``, both float32."""
    if dtA.device.type == "cpu":
        return ref.ssm_scan(dtA, dBx, C)
    return SSMScan.apply(dtA, dBx, C)


class SSMScan(torch.autograd.Function):
    """Forward: the kernel.  Backward: the gradient of the plain scan,
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, dtA, dBx, C):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dtA, dBx, C)
        return launch(prepare(dtA, dBx, C))

    @staticmethod
    def backward(ctx, grad_y, grad_h_last):
        return recompute_grads("ssm_scan", ref.ssm_scan, ctx.saved_tensors, ctx.needs_input_grad, (grad_y, grad_h_last))


def prepare(dtA, dBx, C) -> Launch:
    """Check the CUDA inputs of :func:`ssm_scan`, allocate its outputs and
    bind the launch's arguments; raises on anything the kernel cannot run."""
    dev = require_cuda("ssm_scan", dtA)
    check_graph("ssm_scan", dtA, dBx, C)
    if dtA.dim() != 4:
        raise ValueError(f"dtA must be (B, S, D, N), got {tuple(dtA.shape)}")
    B, S, D, N = dtA.shape
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} is not supported; the kernel takes {STATE_SIZES}")
    check("dtA", dtA, torch.float32, (B, S, D, N), dev)
    check("dBx", dBx, torch.float32, (B, S, D, N), dev)
    check("C", C, tuple(C_DTYPES), (B, S, N), dev)
    if min(B, S, D) < 1:
        raise ValueError(f"empty scan {tuple(dtA.shape)}")
    y = torch.empty((B, S, D), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, D, N), dtype=torch.float32, device=dev)
    args = (
        dtA.data_ptr(), dBx.data_ptr(), C.data_ptr(), y.data_ptr(), h_last.data_ptr(),
        B, S, D, N, C_DTYPES[C.dtype], stream(dev),
    )
    return Launch(c_function("ssm_scan_launch", _ARGTYPES), args, (dtA, dBx, C), (y, h_last))


def launch(job: Launch):
    """Launch a prepared scan on the stream it was prepared for; returns
    ``(y, h_last)``.  Raises on a nonzero ``cudaGetLastError()``."""
    global launches
    outs = call("ssm_scan", job)
    launches += 1
    return outs
