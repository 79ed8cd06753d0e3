"""Launch wrapper of the hand-written CUDA kernel that forms the Mamba-1 scan's
inputs.

:func:`mamba_inputs` takes ``dt_pre = dt_low @ dt_proj`` ``(B, S, D)``, the
bias ``(D,)``, ``A_log`` ``(D, N)`` float32, ``x_act`` ``(B, S, D)`` and
``bmat`` ``(B, S, N)`` (a strided view is fine, with unit stride along N),
and launches ``mamba_inputs_launch`` of ``csrc/mamba_inputs.cu`` (see the
note at the top of the source) on the current stream: one pass writes fresh
float32 ``(dtA, dBx)`` ``(B, S, D, N)``, bit for bit the plain
:func:`~repro_torch.kernels.mamba_inputs.ref.mamba_inputs`'s.  It raises on
anything the kernel cannot run (a tensor off the card, mixed or other dtypes,
a state size outside :data:`STATE_SIZES`) and never falls back:
:mod:`repro_torch.kernels.mamba_inputs.ops` alone picks the kernel or the
plain version.

:func:`mamba_inputs` is :func:`prepare` followed by :func:`launch`;
:data:`launches` counts the kernel's launches in this process.  The launch
runs inside :class:`MambaInputs`, a ``torch.autograd.Function`` whose
backward recomputes the plain formation and differentiates it; :func:`prepare`
raises when it is reached outside the Function with inputs that require grad.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._launch import (
    I32, I64, PTR, Launch, c_function, call, check, check_graph, recompute_grads, require_cuda, stream,
)
from repro_torch.kernels.mamba_inputs import ref
from repro_torch.kernels.ssm_scan.kernel import STATE_SIZES

#: Kernel launches in this process (incremented once per launch, nowhere else).
launches = 0

#: dtypes of dt_pre, the bias, x_act and bmat (one for all four), and their codes in the source.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# mamba_inputs_launch's parameters, in order
_ARGTYPES = [PTR] * 7 + [I64] * 3 + [I32] + [I64] * 2 + [I32, PTR]


def mamba_inputs(dt_pre, dt_bias, A_log, x_act, bmat):
    """Returns ``(dtA, dBx)``, both ``(B, S, D, N)`` float32."""
    return MambaInputs.apply(dt_pre, dt_bias, A_log, x_act, bmat)


class MambaInputs(torch.autograd.Function):
    """Forward: the kernel.  Backward: the gradient of the plain formation,
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, dt_pre, dt_bias, A_log, x_act, bmat):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(dt_pre, dt_bias, A_log, x_act, bmat)
        return launch(prepare(dt_pre, dt_bias, A_log, x_act, bmat))

    @staticmethod
    def backward(ctx, grad_dtA, grad_dBx):
        return recompute_grads("mamba_inputs", ref.mamba_inputs, ctx.saved_tensors, ctx.needs_input_grad,
                               (grad_dtA, grad_dBx))


def prepare(dt_pre, dt_bias, A_log, x_act, bmat) -> Launch:
    """Check the CUDA inputs of :func:`mamba_inputs`, allocate its outputs and
    bind the launch's arguments; raises on anything the kernel cannot run."""
    dev = require_cuda("mamba_inputs", dt_pre)
    check_graph("mamba_inputs", dt_pre, dt_bias, A_log, x_act, bmat)
    if dt_pre.dim() != 3 or A_log.dim() != 2:
        raise ValueError(f"dt_pre must be (B, S, D) and A_log (D, N), got {tuple(dt_pre.shape)} and "
                         f"{tuple(A_log.shape)}")
    B, S, D = dt_pre.shape
    N = A_log.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} is not supported; the kernel takes {STATE_SIZES}")
    check("dt_pre", dt_pre, tuple(DTYPES), (B, S, D), dev)
    check("dt_bias", dt_bias, dt_pre.dtype, (D,), dev)
    check("A_log", A_log, torch.float32, (D, N), dev)
    check("x_act", x_act, dt_pre.dtype, (B, S, D), dev)
    if bmat.device != dev or bmat.dtype != dt_pre.dtype or tuple(bmat.shape) != (B, S, N):
        raise ValueError(f"bmat is {bmat.dtype}{tuple(bmat.shape)} on {bmat.device}, expected "
                         f"{dt_pre.dtype}{(B, S, N)} on {dev}")
    if N > 1 and bmat.stride(2) != 1:
        raise ValueError("bmat must have unit stride along its states")
    if min(B, S, D) < 1:
        raise ValueError(f"empty input {(B, S, D)}")
    outs = tuple(torch.empty((B, S, D, N), dtype=torch.float32, device=dev) for _ in range(2))
    args = (dt_pre.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(), x_act.data_ptr(), bmat.data_ptr(),
            *(o.data_ptr() for o in outs), B, S, D, N, bmat.stride(0), bmat.stride(1), DTYPES[dt_pre.dtype],
            stream(dev))
    return Launch(c_function("mamba_inputs_launch", _ARGTYPES), args, (dt_pre, dt_bias, A_log, x_act, bmat), outs)


def launch(job: Launch):
    """Launch a prepared formation on the stream it was prepared for; returns
    ``(dtA, dBx)``.  Raises on a nonzero ``cudaGetLastError()``."""
    global launches
    outs = call("mamba_inputs", job)
    launches += 1
    return outs
