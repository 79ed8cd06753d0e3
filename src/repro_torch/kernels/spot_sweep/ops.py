"""Spot-sweep op: the fused (type × bid × seed) sweep over a period grid.

``spot_sweep_grid`` evaluates every scheme of a scenario over a pre-built
period grid (:class:`repro_torch.engine.batch._PeriodGrid`) on one torch
device and returns the per-scheme output dicts of
:func:`repro.kernels.spot_sweep.ops.spot_sweep_grid`:

  * on a CUDA device, the hand-written kernel
    (:func:`repro_torch.kernels.spot_sweep.kernel.spot_sweep`) — it launches
    or raises;
  * on any other device, the plain PyTorch version
    (:func:`repro_torch.kernels.spot_sweep.ref.sweep_plain`);
  * with ``impl="plain"``, the plain version on whatever device was asked
    for (the yardstick the kernel is held to on the card).

The sweep's states and per-period run records come back to the host, where
the NumPy biller folds the records into costs, so ``cost`` is the same
left-to-right sum on every device.

ACC is not period-structured and has no kernel: as in
:func:`repro.kernels.spot_sweep.ops.spot_sweep_grid`, it is routed to its
own lockstep walk (:func:`repro_torch.engine.batch._run_acc`, torch ops on
the same device) under a ``sim`` span of its own, and the kernel gets the
other five schemes in its one launch.  A scheme set of ACC alone launches no
kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.schemes import Scheme
from repro_torch.engine.base import resolve_device
from repro_torch.engine.batch import _bill_runs_flat, _run_acc
from repro_torch.kernels import IMPLS, check_impl
from repro_torch.kernels.spot_sweep import kernel, ref
from repro_torch.obs import telemetry as obs

__all__ = ["IMPLS", "device_arrays", "spot_sweep_grid", "sweep_consts"]


def _edge_inputs(grid, t_r):
    """Per-cell EDGE sweep inputs ``(edges_flat, edge_base, edge_n, ptr0)``
    — the one place the per-market edge arrays expand to the cell axis."""
    flat, base_m, n_m = grid.edges()
    m_of = np.arange(grid.n_cells) // grid.n_bids
    return flat, base_m[m_of], n_m[m_of], grid.edge_ptr0(t_r)


def device_arrays(grid, device, need_edge, need_adapt, t_r, adapt_tables):
    """Device copies of the grid/table arrays, memoized on the grid object
    (which :func:`repro_torch.engine.batch.grid_and_tables` keeps per
    scenario), so repeat runs skip the host→device transfer."""
    cache = grid.__dict__.setdefault("_sweep_device", {}).setdefault(str(device), {})

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if "A" not in cache:
        cache["A"] = put(grid.A)
        cache["B"] = put(grid.B)
        cache["valid"] = put(grid.valid)
        cache["horizon"] = put(grid.horizon)
    if need_edge and cache.get("_edge_t_r") != t_r:
        flat, base, n, ptr0 = _edge_inputs(grid, t_r)
        cache["edges"] = (put(flat), put(base), put(n))
        cache["ptr0"] = put(ptr0)
        cache["_edge_t_r"] = t_r
    if need_adapt and cache.get("_tables_src") is not adapt_tables:
        # keyed on the table *object*: fresh tables must never mix with a
        # stale device copy
        cache["tables"] = (put(adapt_tables.flat), put(adapt_tables.off), put(adapt_tables.top))
        cache["_tables_src"] = adapt_tables
    return cache


def sweep_consts(scenario, adapt_tables) -> dict:
    """The scalar simulation constants of one sweep."""
    params = scenario.params
    return dict(
        init_saved=float(scenario.initial_saved_work),
        work_s=float(scenario.work_s),
        t_c=float(params.t_c),
        t_r=float(params.t_r),
        hour_delta=float(params.billing_period_s),
        interval=float(params.adapt_interval_s),
        bin_s=float(adapt_tables.bin_s) if adapt_tables is not None else 0.0,
        n_bins=int(adapt_tables.n_bins) if adapt_tables is not None else 1,
    )


def spot_sweep_grid(schemes, grid, scenario, adapt_tables=None, device=None, impl=None):
    """Evaluate ``schemes`` over a period grid on ``device`` (the GPU by
    default).

    Returns ``(outs, info)``: ``outs`` maps each scheme to the standard
    output dict (``completed`` / ``completion_time`` / ``cost`` /
    ``n_checkpoints`` / ``n_kills`` / ``work_lost_s``, host NumPy arrays),
    ``info`` carries the sweep's ``impl`` label (``"cuda"`` or ``"plain"``).
    The sim and billing phases are recorded as telemetry spans (``sim`` with
    an ``impl`` attr — ``"torch"`` for ACC's own — and ``bill`` per scheme).
    """
    check_impl(impl)
    schemes = tuple(schemes)
    dev = resolve_device(device)
    params = scenario.params
    label = "cuda" if impl is None and dev.type == "cuda" else "plain"
    tel = obs.current()
    outs: dict[Scheme, dict] = {}
    if Scheme.ACC in schemes:
        with tel.span("sim", scheme=Scheme.ACC.value, impl="torch"):
            outs[Scheme.ACC] = _run_acc(grid, scenario, dev)
        schemes = tuple(s for s in schemes if s is not Scheme.ACC)
        if not schemes:
            return outs, {"impl": label}

    need_edge = Scheme.EDGE in schemes
    need_adapt = Scheme.ADAPT in schemes
    sweep = kernel.spot_sweep if label == "cuda" else ref.sweep_plain

    with tel.span("sim", impl=label):
        arrs = device_arrays(grid, dev, need_edge, need_adapt, params.t_r, adapt_tables)
        out = sweep(
            schemes, arrs["A"], arrs["B"], arrs["valid"], arrs["horizon"],
            sweep_consts(scenario, adapt_tables),
            ptr0=arrs.get("ptr0") if need_edge else None,
            edges=arrs.get("edges") if need_edge else None,
            tables=arrs.get("tables") if need_adapt else None,
        )
        done, comp, ckpt, lost, kills, rex, rend, ruser = (x.cpu().numpy() for x in out)

    delta = float(params.billing_period_s)
    for si, scheme in enumerate(schemes):
        with tel.span("bill", scheme=scheme.value):
            cc, pp = np.nonzero(rex[si])
            total, _ = _bill_runs_flat(
                grid, pp, cc, grid.A[cc, pp], rend[si][cc, pp], ruser[si][cc, pp], delta
            )
            outs[scheme] = {
                "completed": done[si] & np.isfinite(comp[si]),
                "completion_time": comp[si],
                "cost": total,
                "n_checkpoints": ckpt[si],
                "n_kills": kills[si],  # counted by the sweep, not re-derived here
                "work_lost_s": lost[si],
            }
    return outs, {"impl": label}
