"""Launch wrapper of the hand-written CUDA AdamW kernels.

:func:`update` takes one leaf's parameter, gradient and moments, and the
step's scalars (:mod:`repro_torch.kernels.adamw.ref`'s ``step`` and
``consts``), all on the card, and launches ``adamw_update_launch`` of
``csrc/adamw.cu`` (see the note at the top of the source) on the current
stream: one launch reads the four once and writes fresh ``(new_p, new_mu,
new_nu)``, bit for bit the plain :func:`~repro_torch.kernels.adamw.ref.upd_block`'s.
:func:`sum_of_squares` launches ``adamw_sumsq_launch``: a leaf's float32 sum
of squares in two deterministic stages.  Both raise on anything their kernels
cannot run (a tensor off the card, a dtype or a pairing of dtypes they do not
take, a non-contiguous tensor, mixed devices) and never fall back; nothing of
either reads a value back to the host.

Each is ``prepare`` (input checks, output allocation) followed by ``launch``
(the bare launch, inside the span ``kernel.adamw`` or ``kernel.adamw_sumsq``);
:data:`launches` and :data:`sumsq_launches` count them in this process.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._launch import F32, I32, I64, PTR, Launch, c_function, call, require_cuda, stream

#: Update launches in this process (incremented once per launch, nowhere else).
launches = 0
#: Sum-of-squares launches in this process (each one call of both stages).
sumsq_launches = 0

#: Parameter (and gradient) and moment dtypes, and their codes in the source.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: float32 partial sums of the first stage at most (``kMaxPartials`` in the source).
SUMSQ_PARTIALS = 1024

# adamw_update_launch's and adamw_sumsq_launch's parameters, in order
_UPDATE_ARGTYPES = [PTR] * 8 + [F32] * 6 + [I64, I32, I32, PTR]
_SUMSQ_ARGTYPES = [PTR] * 3 + [I64, I32, PTR]


def _check_leaf(name: str, x: torch.Tensor, device: torch.device, numel: int | None = None) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} has dtype {x.dtype}, expected float32 or bfloat16")
    if numel is not None and x.numel() != numel:
        raise ValueError(f"{name} has {x.numel()} elements, expected {numel}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def prepare(p, g, mu, nu, step: torch.Tensor, consts: tuple) -> Launch:
    """Check the inputs of :func:`update`, allocate its outputs and bind the
    launch's arguments; raises on anything the kernel cannot run."""
    dev = require_cuda("adamw", p)
    _check_leaf("p", p, dev)
    for name, x in (("g", g), ("mu", mu), ("nu", nu)):
        _check_leaf(name, x, dev, p.numel())
    if g.dtype != p.dtype:
        raise TypeError(f"g has dtype {g.dtype}, expected the parameter's {p.dtype}")
    if nu.dtype != mu.dtype:
        raise TypeError(f"nu has dtype {nu.dtype}, expected mu's {mu.dtype}")
    if step.device != dev or step.dtype != torch.float32 or tuple(step.shape) != (4,) or not step.is_contiguous():
        raise ValueError(f"step must be a contiguous float32 (4,) tensor on {dev}")
    if len(consts) != 6:
        raise ValueError(f"consts holds (b1, b2, 1 - b1, 1 - b2, eps, weight_decay), not {consts!r}")
    if p.numel() == 0:
        raise ValueError("the leaf is empty")
    outs = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in (p, mu, nu))
    args = (p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(), *(x.data_ptr() for x in outs),
            step.data_ptr(), *map(float, consts), p.numel(), DTYPES[p.dtype], DTYPES[mu.dtype], stream(dev))
    return Launch(c_function("adamw_update_launch", _UPDATE_ARGTYPES), args, (p, g, mu, nu, step), outs)


def update(p, g, mu, nu, step: torch.Tensor, consts: tuple):
    """``(new_p, new_mu, new_nu)`` of one leaf on the card (see the module)."""
    return launch(prepare(p, g, mu, nu, step, consts))


def launch(job: Launch):
    """Launch a prepared update on the stream it was prepared for; returns
    ``(new_p, new_mu, new_nu)``.  Raises on a nonzero ``cudaGetLastError()``."""
    global launches
    outs = call("adamw", job)
    launches += 1
    return outs


def sum_of_squares(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of the squares of ``x`` (a 0-dim tensor on the card)."""
    return launch_sum_of_squares(prepare_sum_of_squares(x))


def prepare_sum_of_squares(x: torch.Tensor) -> Launch:
    """Check the input of :func:`sum_of_squares`, allocate the partial sums
    and the output, and bind the launch's arguments."""
    dev = require_cuda("adamw_sumsq", x)
    _check_leaf("x", x, dev)
    if x.numel() == 0:
        raise ValueError("x is empty")
    partials = torch.empty((SUMSQ_PARTIALS,), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), partials.data_ptr(), out.data_ptr(), x.numel(), DTYPES[x.dtype], stream(dev))
    return Launch(c_function("adamw_sumsq_launch", _SUMSQ_ARGTYPES), args, (x, partials), out)


def launch_sum_of_squares(job: Launch) -> torch.Tensor:
    """Launch a prepared sum of squares (both stages); returns the 0-dim sum."""
    global sumsq_launches
    out = call("adamw_sumsq", job)
    sumsq_launches += 1
    return out
