"""Launch wrapper of the hand-written CUDA spot-sweep kernel.

:func:`spot_sweep` takes the padded ``(cells, periods)`` grid as tensors.
On a CUDA tensor it launches ``spot_sweep_launch`` of ``csrc/spot_sweep.cu``
(one thread per (scheme, cell); see the note at the top of the source) on
the current stream, or raises; on a CPU tensor it runs the plain PyTorch
version (:func:`repro_torch.kernels.spot_sweep.ref.sweep_plain`), because
no kernel runs there.  Nothing falls back from the kernel to the plain
version.

:func:`spot_sweep` is :func:`prepare` (input checks, scheme codes, output
allocation) followed by :func:`launch` (the bare kernel launch), so a caller
timing the kernel can put only :func:`launch` between its events.

:data:`launches` counts the kernel's launches in this process; a caller
resets it to 0 before a run to see whether the run went through the kernel.
"""

from __future__ import annotations

import ctypes
from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.core.schemes import Scheme
from repro_torch.kernels import _build
from repro_torch.kernels.spot_sweep import ref

#: Kernel launches in this process (incremented once per launch, nowhere else).
launches = 0

#: Scheme codes of the CUDA source (``SchemeCode``).
SCHEME_CODES = {Scheme.NONE: 0, Scheme.OPT: 1, Scheme.HOUR: 2, Scheme.EDGE: 3, Scheme.ADAPT: 4}

_PTR, _I64, _F64 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double
# spot_sweep_launch's parameters, in order
_ARGTYPES = (
    [_PTR, _I64, _I64, _I64]  # schemes, S, C, P
    + [_PTR] * 4  # A, B, valid, horizon
    + [_PTR] * 4  # ptr0, edges_flat, edge_base, edge_n
    + [_PTR] * 3  # tab_flat, tab_off, tab_top
    + [_F64] * 7  # init_saved, work_s, t_c, t_r, hour_delta, interval, bin_s
    + [_I64]  # n_bins
    + [_PTR] * 5  # done, comp_time, n_ckpt, work_lost, n_kills
    + [_PTR] * 3  # rec_exists, rec_end, rec_user
    + [_PTR]  # stream
)


def _launch_fn():
    fn = _build.load_library().spot_sweep_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


class Launch(NamedTuple):
    """A checked sweep, ready to launch: the C function, its arguments (the
    tensors they point into are held in ``keep`` and ``outs``), and the
    output tensors the launch writes."""

    fn: Callable[..., int]
    args: tuple
    keep: tuple
    outs: tuple


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def spot_sweep(schemes, A, B, valid, horizon, consts, ptr0=None, edges=None, tables=None):
    """The fused sweep over a padded ``(cells, periods)`` grid.

    Same arguments and results as
    :func:`~repro_torch.kernels.spot_sweep.ref.sweep_plain`: ``(done,
    comp_time, n_ckpt, work_lost, n_kills)`` shaped ``(S, C)`` and
    ``(rec_exists, rec_end, rec_user)`` shaped ``(S, C, P)``.
    """
    if A.device.type == "cpu":
        return ref.sweep_plain(schemes, A, B, valid, horizon, consts, ptr0, edges, tables)
    return launch(prepare(schemes, A, B, valid, horizon, consts, ptr0, edges, tables))


def prepare(schemes, A, B, valid, horizon, consts, ptr0=None, edges=None, tables=None) -> Launch:
    """Check the CUDA inputs of :func:`spot_sweep`, allocate its outputs and
    bind the launch's arguments; raises on anything the kernel cannot run."""
    if A.device.type != "cuda":
        raise ValueError(f"the spot_sweep kernel runs on cuda, not {A.device}")

    schemes = tuple(schemes)
    unknown = [s for s in schemes if s not in SCHEME_CODES]
    if unknown or not schemes:
        raise ValueError(f"the sweep kernel runs {sorted(s.value for s in SCHEME_CODES)}, got {schemes}")
    dev = A.device
    S = len(schemes)
    C, P = A.shape
    f64, i64 = torch.float64, torch.int64
    _check("A", A, f64, (C, P), dev)
    _check("B", B, f64, (C, P), dev)
    _check("valid", valid, torch.bool, (C, P), dev)
    _check("horizon", horizon, f64, (C,), dev)
    ptrs = {k: None for k in ("ptr0", "edges_flat", "edge_base", "edge_n", "tab_flat", "tab_off", "tab_top")}
    if Scheme.EDGE in schemes:
        if ptr0 is None or edges is None:
            raise ValueError("EDGE needs ptr0 and edges")
        edges_flat, edge_base, edge_n = edges
        _check("ptr0", ptr0, i64, (C, P), dev)
        _check("edges_flat", edges_flat, f64, (edges_flat.shape[0],), dev)
        _check("edge_base", edge_base, i64, (C,), dev)
        _check("edge_n", edge_n, i64, (C,), dev)
        # the kernel reads edges_flat[edge_base + cursor] for ptr0 <= cursor < edge_n
        if C and (
            int(ptr0.min()) < 0
            or int(edge_base.min()) < 0
            or int((edge_base + edge_n).max()) > edges_flat.shape[0]
        ):
            raise ValueError("edge cursors out of range of edges_flat")
        ptrs.update(ptr0=ptr0, edges_flat=edges_flat, edge_base=edge_base, edge_n=edge_n)
    if Scheme.ADAPT in schemes:
        if tables is None:
            raise ValueError("ADAPT needs tables")
        tab_flat, tab_off, tab_top = tables
        _check("tab_flat", tab_flat, f64, (tab_flat.shape[0],), dev)
        _check("tab_off", tab_off, i64, (C,), dev)
        _check("tab_top", tab_top, i64, (C,), dev)
        # the kernel reads tab_flat[tab_off + i] for 0 <= i <= tab_top + 1
        if C and (
            int(tab_off.min()) < 0
            or int(tab_top.min()) < 0
            or int((tab_off + tab_top).max()) + 2 > tab_flat.shape[0]
        ):
            raise ValueError("survival-table offsets out of range of tab_flat")
        ptrs.update(tab_flat=tab_flat, tab_off=tab_off, tab_top=tab_top)

    codes = torch.tensor([SCHEME_CODES[s] for s in schemes], dtype=torch.int32, device=dev)
    outs = (
        torch.empty((S, C), dtype=torch.bool, device=dev),  # done
        torch.empty((S, C), dtype=f64, device=dev),  # comp_time
        torch.empty((S, C), dtype=i64, device=dev),  # n_ckpt
        torch.empty((S, C), dtype=f64, device=dev),  # work_lost
        torch.empty((S, C), dtype=i64, device=dev),  # n_kills
        torch.empty((S, C, P), dtype=torch.bool, device=dev),  # rec_exists
        torch.empty((S, C, P), dtype=f64, device=dev),  # rec_end
        torch.empty((S, C, P), dtype=torch.bool, device=dev),  # rec_user
    )
    c = consts
    args = (
        codes.data_ptr(), S, C, P,
        A.data_ptr(), B.data_ptr(), valid.data_ptr(), horizon.data_ptr(),
        *(0 if x is None else x.data_ptr() for x in ptrs.values()),
        float(c["init_saved"]), float(c["work_s"]), float(c["t_c"]), float(c["t_r"]),
        float(c["hour_delta"]), float(c["interval"]), float(c["bin_s"]), int(c["n_bins"]),
        *(x.data_ptr() for x in outs),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    keep = (codes, A, B, valid, horizon, *(x for x in ptrs.values() if x is not None))
    return Launch(_launch_fn(), args, keep, outs)


def launch(job: Launch):
    """Launch a prepared sweep on the stream it was prepared for; returns its
    outputs (written when the stream reaches the kernel).  Raises on a
    nonzero ``cudaGetLastError()``."""
    global launches
    err = job.fn(*job.args)
    if err != 0:
        raise RuntimeError(f"spot_sweep kernel launch failed with CUDA error {err}")
    launches += 1
    return job.outs
