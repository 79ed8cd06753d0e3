"""The plain PyTorch version of the fused spot sweep.

The torch twin of :func:`repro.kernels.spot_sweep.kernel.build_sweep_scan`:
a loop over the padded period axis advancing every period-synchronized
scheme (NONE / OPT / HOUR / EDGE) through
:func:`~repro_torch.engine.kernels.period_step_masked`, a masked while-loop
walk of the HOUR/EDGE checkpoint windows (:func:`_windows_kernel`), and the
cell-decoupled ADAPT walk (:func:`_adapt_decoupled`) whose run records are
rebuilt after the loop.  It runs on whatever device its tensors lie on: the
CPU path of :mod:`repro_torch.kernels.spot_sweep.ops`, and the yardstick the
CUDA kernel is held to on the card.

Every output is bit-identical to the CUDA kernel's (``csrc/spot_sweep.cu``)
and to ``repro``'s sweep (all arithmetic is IEEE float64 + − × ÷ and
compares, in the same association order).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.schemes import Scheme
from repro_torch.engine import kernels as _k
from repro_torch.engine.kernels import _EPS, period_step_masked


def _windows_kernel(go, a, b, start_work, saved, work_s, t_c, hour_delta=None, edge=None):
    """HOUR (``hour_delta``) / EDGE (``edge = (edges_flat, base, n_edges,
    ptr0)``) checkpoint-window walk with masks in place of compaction.

    Returns the scheme-kernel 5-tuple ``(done_now, done_at, work_end, sv,
    ckpt_add)``.
    """
    C = b.shape[0]
    dev = b.device
    false = torch.zeros(C, dtype=torch.bool, device=dev)
    work, t, sv = saved, start_work, saved
    done_now, tail, in_loop = false, false, go
    done_at = torch.full((C,), math.nan, dtype=torch.float64, device=dev)
    ckpt_add = torch.zeros(C, dtype=torch.int64, device=dev)
    if edge is not None:
        edges_flat, base, n_edges, cursor = edge
    k = 1  # HOUR window index
    while bool(in_loop.any()):
        if edge is None:
            s = a + k * hour_delta - t_c  # launch + k*Δ - t_c
            no_more = in_loop & ~(s < b)
            window = in_loop & (s < b) & (s > start_work)
            # s <= start_work windows are skipped but the walk continues
        else:
            have = in_loop & (cursor < n_edges)
            idx = torch.where(have, base + cursor, 0)
            s = torch.where(have, edges_flat[idx], math.inf)
            no_more = in_loop & (~have | ~(s < b))
            window = in_loop & have & (s < b)
        tail = tail | no_more
        in_loop = in_loop & ~no_more
        state = (work, t, sv, done_now, done_at, ckpt_add, in_loop)
        window, state = _k.windows_advance(s, window, state, work_s, t_c, b)
        work, t, sv, done_now, done_at, ckpt_add, in_loop = state
        if edge is None:
            k += 1
        else:
            cursor = cursor + window.to(torch.int64)  # only consumed edges advance
    # tail segment: work to b, maybe completing
    lhs = work + (b - t)
    d2 = tail & (lhs >= (work_s - _EPS))
    done_now = done_now | d2
    done_at = torch.where(d2, t + (work_s - work), done_at)
    work_end = torch.where(tail, lhs, work)
    return done_now, done_at, work_end, sv, ckpt_add


def _adapt_decoupled(A, B, valid, horizon, c, tab):
    """ADAPT over every cell's own ``(period, decision-tick)`` cursor.

    One while loop advances each cell through its periods and ticks; period
    entry (stepping over invalid periods and consuming too-short availability
    windows) is a masked phase of the loop, so the iteration count is the
    busiest single cell's total.  Any ``valid`` mask is walked as the TPU
    kernel's masked period steps walk it: invalid periods are skipped, not
    only a tail of them.
    The loop carries only ``(C,)`` vectors.  The run records are rebuilt
    after it: every processed period of a cell ends in exactly one record
    (mid-trace shorts and kills end at ``B[c, p]``, shorts at the horizon
    are unbilled, the one possible completion ends at ``comp_time[c]`` in
    the cell's final cursor period).

    Returns ``(done, comp_time, n_ckpt, work_lost, n_kills)`` and the
    records ``(rec_exists, rec_end, rec_user)`` shaped ``(C, P)``.
    """
    tab_flat, tab_off, tab_top = tab
    work_s, t_c, t_r = c["work_s"], c["t_c"], c["t_r"]
    interval, bin_s, n_bins = c["interval"], c["bin_s"], c["n_bins"]
    C, P = A.shape
    dev = A.device
    rows = torch.arange(C, device=dev)
    cnt = valid.sum(dim=1)
    # the first valid period at or after each p, and P past the last
    nxt = torch.where(valid, torch.arange(P, device=dev), P).flip(1).cummin(dim=1).values.flip(1)
    nxt = torch.cat([nxt, torch.full((C, 1), P, dtype=nxt.dtype, device=dev)], dim=1)
    zf = torch.zeros(C, dtype=torch.float64, device=dev)
    zi = torch.zeros(C, dtype=torch.int64, device=dev)
    saved = torch.full((C,), c["init_saved"], dtype=torch.float64, device=dev)
    alive = cnt > 0
    entering = torch.ones(C, dtype=torch.bool, device=dev)
    done = torch.zeros(C, dtype=torch.bool, device=dev)
    p = n_ckpt = n_kills = zi
    t = work = sv = next_dec = a_cur = b_cur = work_lost = zf
    comp_time = torch.full((C,), math.inf, dtype=torch.float64, device=dev)

    while bool(alive.any()):
        # -- enter cells into their next period (shorts retry next iteration)
        ent = alive & entering
        p = torch.where(ent, nxt[rows, p], p)
        no_more = ent & (p >= P)
        alive = alive & ~no_more
        ent = ent & ~no_more
        pc = torch.clamp(p, max=P - 1)
        a = A[rows, pc]
        b = B[rows, pc]
        start_work = a + t_r
        short = ent & (start_work >= b)
        shortk = short & (b < horizon)
        n_kills = n_kills + shortk.to(torch.int64)
        go = ent & ~short
        t = torch.where(go, start_work, t)
        work = torch.where(go, saved, work)
        sv = torch.where(go, saved, sv)
        next_dec = torch.where(go, start_work + interval, next_dec)
        a_cur = torch.where(go, a, a_cur)
        b_cur = torch.where(go, b, b_cur)
        entering = entering & ~go
        p = torch.where(short, p + 1, p)
        live = alive & ~entering

        # -- one decision tick (the shared body)
        live, t, work, sv, next_dec, d_at, fin, ck, kl = _k.adapt_tick_core(
            live, t, work, sv, next_dec, a_cur, b_cur, work_s, t_c, t_r,
            interval, tab_flat, tab_off, tab_top, bin_s, n_bins,
        )
        comp_time = torch.where(fin, d_at, comp_time)
        done = done | fin
        alive = alive & ~fin
        n_ckpt = n_ckpt + ck.to(torch.int64)
        n_kills = n_kills + kl.to(torch.int64)
        work_lost = torch.where(kl, work_lost + (work - sv), work_lost)
        saved = torch.where(kl, sv, saved)
        p = torch.where(kl, p + 1, p)
        entering = entering | kl

    # -- rebuild the run records from the final cursor state (see above)
    p_idx = torch.arange(P, device=dev)[None, :]
    short_g = (A + t_r) >= B  # NaN pads compare False
    unbilled_short = short_g & ~(B < horizon[:, None])
    p_last = torch.where(done, p, P)[:, None]
    rex = valid & (p_idx <= p_last) & ~unbilled_short
    ruser = done[:, None] & (p_idx == p[:, None])
    rend = torch.where(ruser, comp_time[:, None], B)
    return (done, comp_time, n_ckpt, work_lost, n_kills), (rex, rend, ruser)


def sweep_plain(schemes, A, B, valid, horizon, consts, ptr0=None, edges=None, tables=None):
    """The fused sweep over a padded ``(cells, periods)`` grid, in plain torch.

    ``A`` / ``B`` are ``(C, P)`` float64 (NaN-padded), ``valid`` ``(C, P)``
    bool, ``horizon`` ``(C,)`` float64; ``consts`` maps ``init_saved``,
    ``work_s``, ``t_c``, ``t_r``, ``hour_delta``, ``interval``, ``bin_s``,
    ``n_bins``.  EDGE needs ``ptr0`` ``(C, P)`` int64 and ``edges =
    (edges_flat, edge_base, edge_n)``; ADAPT needs ``tables = (tab_flat,
    tab_off, tab_top)``.

    Returns ``(done, comp_time, n_ckpt, work_lost, n_kills)`` shaped
    ``(S, C)`` and ``(rec_exists, rec_end, rec_user)`` shaped ``(S, C,
    P)``.
    """
    schemes = tuple(schemes)
    S = len(schemes)
    C, P = A.shape
    dev = A.device
    c = consts
    work_s, t_c, t_r = c["work_s"], c["t_c"], c["t_r"]

    finals = [None] * S
    rex = torch.zeros((S, C, P), dtype=torch.bool, device=dev)
    rend = torch.empty((S, C, P), dtype=torch.float64, device=dev)
    ruser = torch.zeros((S, C, P), dtype=torch.bool, device=dev)

    if Scheme.ADAPT in schemes:
        si = schemes.index(Scheme.ADAPT)
        finals[si], (rex[si], rend[si], ruser[si]) = _adapt_decoupled(A, B, valid, horizon, c, tables)

    sync = [(si, s) for si, s in enumerate(schemes) if s != Scheme.ADAPT]
    states = {}
    for si, _ in sync:
        states[si] = (
            torch.full((C,), c["init_saved"], dtype=torch.float64, device=dev),  # saved
            torch.zeros(C, dtype=torch.bool, device=dev),  # done
            torch.full((C,), math.inf, dtype=torch.float64, device=dev),  # comp_time
            torch.zeros(C, dtype=torch.int64, device=dev),  # n_ckpt
            torch.zeros(C, dtype=torch.float64, device=dev),  # work_lost
            torch.zeros(C, dtype=torch.bool, device=dev),  # has_run (NONE)
            torch.zeros(C, dtype=torch.int64, device=dev),  # n_kills
        )

    for p in range(P if sync else 0):
        a, b, v = A[:, p], B[:, p], valid[:, p]
        for si, scheme in sync:

            def run_kernel(go, a_, b_, sw, sv, scheme=scheme):
                if scheme == Scheme.NONE:
                    return _k._kernel_none(b_, sw, sv, work_s)
                if scheme == Scheme.OPT:
                    return _k._kernel_opt(b_, sw, sv, work_s, t_c)
                if scheme == Scheme.HOUR:
                    return _windows_kernel(go, a_, b_, sw, sv, work_s, t_c, hour_delta=c["hour_delta"])
                flat, base, n_edges = edges
                return _windows_kernel(go, a_, b_, sw, sv, work_s, t_c, edge=(flat, base, n_edges, ptr0[:, p]))

            states[si], (ex, end, user) = period_step_masked(
                scheme, states[si], a, b, v, horizon, t_r, run_kernel
            )
            rex[si, :, p], rend[si, :, p], ruser[si, :, p] = ex, end, user

    for si, _ in sync:
        saved, done, comp_time, n_ckpt, work_lost, _, n_kills = states[si]
        finals[si] = (done, comp_time, n_ckpt, work_lost, n_kills)

    stacked = tuple(torch.stack([f[j] for f in finals]) for j in range(5))
    return stacked + (rex, rend, ruser)
