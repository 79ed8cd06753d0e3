"""Launch wrapper of the hand-written CUDA spot-sweep kernel.

:func:`spot_sweep` takes the padded ``(cells, periods)`` grid as tensors.
On a CUDA tensor it launches ``spot_sweep_launch`` of ``csrc/spot_sweep.cu``
(one thread per (scheme, cell); see the note at the top of the source) on
the current stream, or raises, as it does on a tensor off the card:
:mod:`repro_torch.kernels.spot_sweep.ops` alone picks the kernel or the plain
version (:func:`repro_torch.kernels.spot_sweep.ref.sweep_plain`), and nothing
falls back from the kernel to it.

:func:`spot_sweep` is :func:`prepare` (input checks, scheme codes, output
allocation) followed by :func:`launch` (the bare kernel launch), so a caller
timing the kernel can put only :func:`launch` between its events.

:data:`launches` counts the kernel's launches in this process; a caller
resets it to 0 before a run to see whether the run went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.schemes import Scheme
from repro_torch.kernels._launch import F64, I64, PTR, Launch, c_function, call, check, require_cuda, stream

#: Kernel launches in this process (incremented once per launch, nowhere else).
launches = 0

#: Scheme codes of the CUDA source (``SchemeCode``).
SCHEME_CODES = {Scheme.NONE: 0, Scheme.OPT: 1, Scheme.HOUR: 2, Scheme.EDGE: 3, Scheme.ADAPT: 4}

# spot_sweep_launch's parameters, in order
_ARGTYPES = (
    [PTR, I64, I64, I64]  # schemes, S, C, P
    + [PTR] * 4  # A, B, valid, horizon
    + [PTR] * 4  # ptr0, edges_flat, edge_base, edge_n
    + [PTR] * 3  # tab_flat, tab_off, tab_top
    + [F64] * 7  # init_saved, work_s, t_c, t_r, hour_delta, interval, bin_s
    + [I64]  # n_bins
    + [PTR] * 5  # done, comp_time, n_ckpt, work_lost, n_kills
    + [PTR] * 3  # rec_exists, rec_end, rec_user
    + [PTR]  # rec_bits (scratch)
    + [PTR]  # stream
)


def spot_sweep(schemes, A, B, valid, horizon, consts, ptr0=None, edges=None, tables=None):
    """The fused sweep over a padded ``(cells, periods)`` grid.

    Same arguments and results as
    :func:`~repro_torch.kernels.spot_sweep.ref.sweep_plain`: ``(done,
    comp_time, n_ckpt, work_lost, n_kills)`` shaped ``(S, C)`` and
    ``(rec_exists, rec_end, rec_user)`` shaped ``(S, C, P)``.
    """
    return launch(prepare(schemes, A, B, valid, horizon, consts, ptr0, edges, tables))


def prepare(schemes, A, B, valid, horizon, consts, ptr0=None, edges=None, tables=None) -> Launch:
    """Check the CUDA inputs of :func:`spot_sweep`, allocate its outputs and
    bind the launch's arguments; raises on anything the kernel cannot run."""
    require_cuda("spot_sweep", A)

    schemes = tuple(schemes)
    unknown = [s for s in schemes if s not in SCHEME_CODES]
    if unknown or not schemes or len(set(schemes)) != len(schemes):
        raise ValueError(f"the sweep kernel runs each of {sorted(s.value for s in SCHEME_CODES)} at most once, "
                         f"got {schemes}")
    dev = A.device
    S = len(schemes)
    C, P = A.shape
    f64, i64 = torch.float64, torch.int64
    check("A", A, f64, (C, P), dev)
    check("B", B, f64, (C, P), dev)
    check("valid", valid, torch.bool, (C, P), dev)
    check("horizon", horizon, f64, (C,), dev)
    ptrs = {k: None for k in ("ptr0", "edges_flat", "edge_base", "edge_n", "tab_flat", "tab_off", "tab_top")}
    if Scheme.EDGE in schemes:
        if ptr0 is None or edges is None:
            raise ValueError("EDGE needs ptr0 and edges")
        edges_flat, edge_base, edge_n = edges
        check("ptr0", ptr0, i64, (C, P), dev)
        check("edges_flat", edges_flat, f64, (edges_flat.shape[0],), dev)
        check("edge_base", edge_base, i64, (C,), dev)
        check("edge_n", edge_n, i64, (C,), dev)
        ptrs.update(ptr0=ptr0, edges_flat=edges_flat, edge_base=edge_base, edge_n=edge_n)
    if Scheme.ADAPT in schemes:
        if tables is None:
            raise ValueError("ADAPT needs tables")
        tab_flat, tab_off, tab_top = tables
        check("tab_flat", tab_flat, f64, (tab_flat.shape[0],), dev)
        check("tab_off", tab_off, i64, (C,), dev)
        check("tab_top", tab_top, i64, (C,), dev)
        ptrs.update(tab_flat=tab_flat, tab_off=tab_off, tab_top=tab_top)
    need_edge, need_adapt = Scheme.EDGE in schemes, Scheme.ADAPT in schemes
    bad = out_of_range(ptr0 if need_edge else None, edges if need_edge else None, tables if need_adapt else None)
    if bad:
        raise ValueError("; ".join(bad))

    codes = (ctypes.c_int * S)(*(SCHEME_CODES[s] for s in schemes))  # read on the host at launch
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
    rec_bits = torch.empty((S, C, (P + 31) // 32), dtype=torch.int32, device=dev)  # which periods have a record
    c = consts
    args = (
        codes, S, C, P,
        A.data_ptr(), B.data_ptr(), valid.data_ptr(), horizon.data_ptr(),
        *(0 if x is None else x.data_ptr() for x in ptrs.values()),
        float(c["init_saved"]), float(c["work_s"]), float(c["t_c"]), float(c["t_r"]),
        float(c["hour_delta"]), float(c["interval"]), float(c["bin_s"]), int(c["n_bins"]),
        *(x.data_ptr() for x in outs),
        rec_bits.data_ptr(),
        stream(dev),
    )
    keep = (A, B, valid, horizon, rec_bits, *(x for x in ptrs.values() if x is not None))
    return Launch(c_function("spot_sweep_launch", _ARGTYPES), args, keep, outs)


def out_of_range(ptr0=None, edges=None, tables=None) -> list[str]:
    """What the kernel would read out of bounds: the message of each range
    check the inputs fail (none for good inputs).

    The kernel reads ``edges_flat[edge_base + cursor]`` for ``ptr0 <= cursor <
    edge_n`` and ``tab_flat[tab_off + i]`` for ``0 <= i <= tab_top + 1``.  The
    six reductions are read back to the host together: one synchronization.
    """
    checks = []  # (two least values that must be >= 0, a largest end, its limit, message)
    if edges is not None and ptr0.numel():
        edges_flat, edge_base, edge_n = edges
        checks.append((ptr0.min(), edge_base.min(), (edge_base + edge_n).max(), edges_flat.shape[0],
                       "edge cursors out of range of edges_flat"))
    if tables is not None and tables[1].numel():
        tab_flat, tab_off, tab_top = tables
        checks.append((tab_off.min(), tab_top.min(), (tab_off + tab_top).max() + 2, tab_flat.shape[0],
                       "survival-table offsets out of range of tab_flat"))
    if not checks:
        return []
    values = torch.stack([x for entry in checks for x in entry[:3]]).tolist()
    return [msg for k, (*_, limit, msg) in enumerate(checks)
            if min(values[3 * k], values[3 * k + 1]) < 0 or values[3 * k + 2] > limit]


def launch(job: Launch):
    """Launch a prepared sweep on the stream it was prepared for; returns its
    outputs (written when the stream reaches the kernel).  Raises on a
    nonzero ``cudaGetLastError()``."""
    global launches
    outs = call("spot_sweep", job)
    launches += 1
    return outs
