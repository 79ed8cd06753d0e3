"""SpotTrainer: the paper's ACC control loop driving a real PyTorch training job.

The port of :mod:`repro.train.spot_trainer`, line for line in its control
loop.  A training loop on leased spot capacity, with the monitoring
subsystem's three events wired to real actions:

    E_ckpt      -> CheckpointManager.save (async; t_c is *measured* and fed
                   back into the decision point t_cd = t_h - t_c - t_w)
    E_terminate -> lease ends; live training state is genuinely discarded
    E_launch    -> restore latest checkpoint (+ data-iterator step) and resume

Time is virtual (each optimizer step advances the clock by ``step_time_s``;
checkpoints advance it by the measured-or-modelled t_c), so a multi-day spot
campaign replays in seconds of wall time while exercising the actual
save/discard/restore machinery.  Each lease is billed with
:func:`repro_torch.core.run_cost` (the builtin ``sum()`` of the JAX package,
so ``cost`` equals its trainer's bit for bit).

Beyond the paper:

  * model-size-aware t_c: bytes(params+opt)/snapshot_bandwidth, cut ~4x by
    the int8 codec (which quantizes on the card, see
    :mod:`repro_torch.checkpoint.manager`);
  * straggler watchdog: EWMA of step wall time; steps slower than
    ``straggler_factor`` x EWMA fire a straggler event;
  * degraded recovery: a corrupt checkpoint is quarantined and the next
    older one tried; with every one damaged, the run restarts from a fresh
    state with the pristine data state.

The JAX trainer's ``relaunch_shardings`` (elastic restore onto another mesh)
has no meaning on one card and is left out.  Two places hold two copies of
the training state for a moment, as in the JAX package: a preemption builds
the fresh state before the old one is dropped, and a restore reads the
checkpoint while the live state it replaces is still held.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointCorruptionError, CheckpointManager
from repro_torch.checkpoint import tree as tree_lib
from repro_torch.core import PriceTrace, SimParams, Termination, run_cost
from repro_torch.core.events import EventKind, SpotEventGenerator
from repro_torch.core.lifecycle import AppState, Lifecycle
from repro_torch.core.simulator import _next_launch_time
from repro_torch.obs import telemetry as obs


@dataclasses.dataclass
class SpotTrainerConfig:
    a_bid: float
    ckpt_dir: str
    max_steps: int = 200
    step_time_s: float = 10.0  # virtual seconds per optimizer step
    snapshot_bw_bytes_s: float = 2e9  # device->host+IO bandwidth for t_c model
    sim: SimParams = dataclasses.field(default_factory=SimParams)
    codec: str = "raw"
    keep: int = 3
    async_io: bool = True
    straggler_factor: float = 3.0
    measure_t_c: bool = True  # fold measured t_c back into decision points


@dataclasses.dataclass
class SpotRunReport:
    completed: bool
    steps_done: int
    virtual_time_s: float
    cost: float
    n_checkpoints: int
    n_preemptions: int
    n_restores: int
    restore_fallbacks: int
    straggler_events: int
    losses: list[float]
    lease_log: list[tuple[float, float]]  # (launch, end) virtual times


class SpotTrainer:
    def __init__(
        self,
        cfg: SpotTrainerConfig,
        *,
        train_step: Callable,  # (params, opt_state, batch) -> (params, opt_state, metrics)
        init_params: Callable[[], tuple],  # () -> (params, opt_state)
        data,  # TokenStream
        trace: PriceTrace,
        on_straggler: Callable | None = None,
    ):
        self.cfg = cfg
        self.train_step = train_step
        self.init_params = init_params
        self.data = data
        self.trace = trace
        self.on_straggler = on_straggler
        self.mgr = CheckpointManager(
            cfg.ckpt_dir, keep=cfg.keep, codec_name=cfg.codec, async_io=cfg.async_io
        )
        self.lifecycle = Lifecycle()
        self.t_c_estimate = cfg.sim.t_c  # refined after the first save

    @classmethod
    def from_scenario(
        cls,
        scenario,
        *,
        ckpt_dir: str,
        train_step: Callable,
        init_params: Callable[[], tuple],
        data,
        market: int = 0,
        bid_index: int = 0,
        on_straggler: Callable | None = None,
        **config_overrides,
    ) -> "SpotTrainer":
        """Drive the trainer from a declarative :class:`repro_torch.engine.Scenario`.

        The scenario supplies the market (``market`` indexes its materialized
        (type, seed) cells), the A_bid (``bid_index`` into the scenario's bid
        grid, on-demand-scaled when ``bid_fractions`` is set) and the
        :class:`SimParams`; everything else of :class:`SpotTrainerConfig` can
        be overridden via keyword.  This makes a live training campaign just
        one more backend for the same scenario the simulation engines sweep —
        e.g. simulate the full bid grid with ``repro_torch.engine.run`` first, then
        replay the chosen cell against real training state here.
        """
        cellm = scenario.materialize_cell(market)
        a_bid = scenario.market_bids(cellm)[bid_index]
        cfg = SpotTrainerConfig(
            a_bid=a_bid, ckpt_dir=ckpt_dir, sim=scenario.params, **config_overrides
        )
        return cls(
            cfg,
            train_step=train_step,
            init_params=init_params,
            data=data,
            trace=cellm.trace,
            on_straggler=on_straggler,
        )

    # ------------------------------------------------------------------
    def _state_bytes(self, params, opt_state) -> int:
        return sum(_nbytes(x) for x in tree_lib.leaves((params, opt_state)))

    def _virtual_t_c(self, params, opt_state) -> float:
        bytes_ = self._state_bytes(params, opt_state)
        if self.cfg.codec == "int8":
            bytes_ = bytes_ // 4 + bytes_ // 256  # q + scales
        return bytes_ / self.cfg.snapshot_bw_bytes_s

    # ------------------------------------------------------------------
    def run(self) -> SpotRunReport:
        tel = obs.current()
        cfg = self.cfg
        sim = cfg.sim
        self.lifecycle.map_modules()  # New -> Inactive (composition)
        params, opt_state = self.init_params()
        data0 = self.data.state_dict()  # pristine iterator state for total-loss recovery
        step = 0
        losses: list[float] = []
        cost = 0.0
        n_ckpt = n_preempt = n_restore = n_fallback = n_straggler = 0
        leases: list[tuple[float, float]] = []
        ewma = None

        t_c = self._virtual_t_c(params, opt_state) if cfg.measure_t_c else sim.t_c
        self.t_c_estimate = t_c

        t = 0.0 if self.trace.price_at(0.0) <= cfg.a_bid else self._next_launch(0.0)
        while t is not None and step < cfg.max_steps and t < self.trace.horizon:
            launch = t
            if tel.enabled:
                tel.event(EventKind.LAUNCH.value, launch, price=self.trace.price_at(launch))
                tel.count(f"events.{EventKind.LAUNCH.value}")
            self.lifecycle.deploy() if self.lifecycle.state == AppState.INACTIVE else self.lifecycle.heal()
            # resume from checkpoint if one exists (first launch: fresh state).
            # Degraded recovery: a corrupt snapshot is quarantined and the next
            # older one tried — the run repays the lost steps instead of dying;
            # with every checkpoint damaged it restarts from pristine state.
            restored = False
            for s in reversed(self.mgr.steps()):
                try:
                    (params, opt_state), extra = self.mgr.restore((params, opt_state), step=s)
                except CheckpointCorruptionError as e:
                    self.mgr.quarantine(s)
                    n_fallback += 1
                    tel.count("trainer.restore_fallbacks")
                    if tel.enabled:
                        tel.event("trainer.restore_fallback", t, step=s, reason=e.reason)
                    continue
                self.data.load_state_dict(extra["data"])
                step = int(extra["step"])
                n_restore += 1
                tel.count("trainer.restores")
                restored = True
                break
            if not restored and n_fallback:
                # every checkpoint was corrupt: restart from scratch, keeping
                # step and data-iterator state consistent with the fresh params
                step = 0
                self.data.load_state_dict(data0)
            t = launch + sim.t_r  # recovery overhead
            gen = SpotEventGenerator(
                a_bid=cfg.a_bid,
                params=dataclasses.replace(sim, t_c=max(t_c, 1.0)),
                price_fn=self.trace.price_at,
            )
            k = 1
            terminated = None
            while step < cfg.max_steps:
                t_h = launch + k * sim.billing_period_s
                t_cd = t_h - max(t_c, 1.0) - sim.t_w
                # --- run real training steps until the checkpoint decision point
                while step < cfg.max_steps and t + cfg.step_time_s <= t_cd:
                    batch = next(self.data)
                    wall0 = time.monotonic()
                    params, opt_state, metrics = self.train_step(params, opt_state, batch)
                    wall = time.monotonic() - wall0
                    ewma = wall if ewma is None else 0.9 * ewma + 0.1 * wall
                    if wall > cfg.straggler_factor * ewma and step > 3:
                        n_straggler += 1
                        tel.count("trainer.stragglers")
                        if self.on_straggler is not None:
                            self.on_straggler(step, wall, ewma)
                    losses.append(float(metrics["loss"]))
                    step += 1
                    t += cfg.step_time_s
                if step >= cfg.max_steps:
                    break
                # --- decision points (paper Eq. 3-4)
                events = list(gen.events_for_hour(t_h))
                kinds = {e.kind for e in events}
                if EventKind.CKPT in kinds:
                    wall0 = time.monotonic()
                    self.mgr.save(
                        step, (params, opt_state), {"step": step, "data": self.data.state_dict()}
                    )
                    io_wall = time.monotonic() - wall0
                    n_ckpt += 1
                    tel.count("trainer.checkpoints")
                    if cfg.measure_t_c:
                        # virtual t_c: modelled bytes/bw; real I/O wall time is
                        # folded in as a lower bound so t_cd stays feasible
                        t_c = max(self._virtual_t_c(params, opt_state), io_wall)
                        self.t_c_estimate = t_c
                t = t_h
                if EventKind.TERMINATE in kinds:
                    terminated = t_h
                    break
                k += 1
            end = t if terminated is None else terminated
            cost += run_cost(self.trace, launch, end, Termination.USER, sim.billing_period_s)
            leases.append((launch, end))
            if tel.enabled:
                tel.event("trainer.lease", launch, end=end, steps=step)
            if terminated is None:  # completed (or horizon)
                break
            # genuine preemption: discard live state
            n_preempt += 1
            tel.count("trainer.preemptions")
            params, opt_state = self.init_params()
            self.lifecycle.resource_failure()  # Active -> Unreachable
            t = self._next_launch(terminated + 1e-9)

        completed = step >= cfg.max_steps
        if self.lifecycle.state != AppState.TERMINATED:
            if self.lifecycle.state in (AppState.UNBALANCED, AppState.UNREACHABLE):
                self.lifecycle.heal()
            if self.lifecycle.state == AppState.ACTIVE or self.lifecycle.state == AppState.INACTIVE:
                self.lifecycle.release()
        self.mgr.wait()
        return SpotRunReport(
            completed=completed,
            steps_done=step,
            virtual_time_s=t if t is not None else math.inf,
            cost=cost,
            n_checkpoints=n_ckpt,
            n_preemptions=n_preempt,
            n_restores=n_restore,
            restore_fallbacks=n_fallback,
            straggler_events=n_straggler,
            losses=losses,
            lease_log=leases,
        )

    def _next_launch(self, t_from: float) -> float | None:
        return _next_launch_time(self.trace, t_from, self.cfg.a_bid, self.cfg.sim.poll_s)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    x = np.asarray(x)
    return x.size * x.dtype.itemsize
