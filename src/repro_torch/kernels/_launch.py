"""What every launch wrapper of the port shares: input checks and the
prepared-launch record.

A wrapper's ``prepare`` checks its inputs (raising on anything its kernel
cannot run), allocates the outputs and binds the C function's arguments into a
:class:`Launch`; its ``launch`` calls the C function, raises on a nonzero
``cudaGetLastError()`` and counts the launch.  A caller timing a kernel puts
only ``launch`` between its events.

The model kernels have no backward of their own (nor do the TPU kernels they
replace: the JAX package differentiates through its plain references).  Each
is wrapped in a ``torch.autograd.Function`` whose forward is the kernel launch
and whose backward recomputes the plain version on the saved inputs
(:func:`recompute_grads`).  This is no fallback: the kernel always runs the
forward, and the plain version only gives the gradient.  A kernel's output is
a fresh tensor with no ``grad_fn``, so :func:`check_graph` makes ``prepare``
raise when it is reached outside its Function with inputs that require grad:
the gradient would stop there without an error.

Every launch of the port passes :func:`call`, and every kernel's backward
:func:`recompute_grads`: they hold the spans ``kernel.<name>`` and
``kernel.<name>.recompute`` (:mod:`repro_torch.obs`), so a profiler's trace
can charge each launch and each recompute to its kernel by name.
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable, Sequence
from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.kernels import _build

PTR, I32, I64, F32, F64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_double


class Launch(NamedTuple):
    """A checked launch: the C function, its arguments (the tensors they point
    into are held in ``keep`` and ``outs``), and the output tensors the launch
    writes."""

    fn: Callable[..., int]
    args: tuple
    keep: tuple
    outs: tuple


#: name -> bound C function, so a launch does not look for the library again
_FUNCTIONS: dict[str, Callable[..., int]] = {}


def c_function(name: str, argtypes: Sequence) -> Callable[..., int]:
    """``name`` of the built library (built and loaded at the first call in the
    process), with its argument types declared (a pointer undeclared would be
    cut to 32 bits)."""
    fn = _FUNCTIONS.get(name)
    if fn is None:
        fn = getattr(_build.load_library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[name] = fn
    return fn


def check(name, x, dtype, shape, device):
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (``dtype`` may be a tuple of the dtypes accepted)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if x.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {' or '.join(map(str, dtypes))}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_graph(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an input requires grad: the launch is
    then outside its ``torch.autograd.Function`` (whose forward runs with grad
    mode off), and its output would cut the graph."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel was reached with inputs that require grad outside its autograd "
            "Function; its output would carry no gradient"
        )


def recompute_grads(name: str, plain: Callable, saved: Sequence[torch.Tensor], needs: Sequence[bool],
                    grad_outputs: Sequence, **kw) -> tuple:
    """The backward of kernel ``name``'s Function: ``plain(*saved, **kw)``
    again on detached copies of the saved inputs, with grad mode on, and the
    gradients of its outputs (weighted by ``grad_outputs``; ``None`` for an
    output that took no gradient) with respect to the inputs marked in
    ``needs``, inside the span ``kernel.<name>.recompute``.  Returns one
    gradient or ``None`` per input."""
    with obs.current().span(f"kernel.{name}.recompute"):
        inputs = [t.detach().requires_grad_(bool(n)) for t, n in zip(saved, needs)]
        with torch.enable_grad():
            outs = plain(*inputs, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None]
        wrt = [t for t in inputs if t.requires_grad]
        if not wrt or not pairs:
            return tuple(None for _ in inputs)
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs], allow_unused=True))
        return tuple(next(got) if t.requires_grad else None for t in inputs)


def require_cuda(name: str, x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on cuda, not {x.device}")
    return x.device


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def call(name: str, job: Launch) -> tuple:
    """Run a prepared launch inside the span ``kernel.<name>``; raises when
    the launch is refused."""
    with obs.current().span(f"kernel.{name}"):
        err = job.fn(*job.args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")
    return job.outs
