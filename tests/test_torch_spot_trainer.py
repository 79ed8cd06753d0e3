"""The port's SpotTrainer: the JAX trainer's tests, and the same report.

The first part mirrors ``tests/train/test_spot_trainer.py`` (a smoke glm4-9b
trained under a trace that preempts the lease; with the raw codec the
preempted run ends on the same loss as the uninterrupted one, bit for bit)
and ``tests/train/test_degraded_recovery.py`` (a stand-in scalar step, so
the recovery paths run in milliseconds).

The second part runs the port's and the JAX package's trainers on the same
traces, under the same fault plans, with the same deterministic stand-in
step (the loss a function of the step): ``steps_done``, ``virtual_time_s``,
``cost``, the checkpoint / preemption / restore / fallback counts, the losses
and ``lease_log`` must be ``==``.  ``straggler_events`` is left out: it reads
the wall clock.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from repro import faults as jax_faults
from repro.core import PriceTrace as JaxPriceTrace
from repro.core import SimParams as JaxSimParams
from repro.core import get_instance as jax_get_instance
from repro.core import synthetic_trace as jax_synthetic_trace
from repro.train.spot_trainer import SpotTrainer as JaxSpotTrainer
from repro.train.spot_trainer import SpotTrainerConfig as JaxSpotTrainerConfig
from repro_torch import faults, obs
from repro_torch.configs import get_smoke_config
from repro_torch.core import HOUR, PriceTrace, SimParams, get_instance, step_trace, synthetic_trace
from repro_torch.data import TokenStream
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.spot_trainer import SpotTrainer, SpotTrainerConfig
from repro_torch.train.steps import make_train_step

OPT = AdamWConfig(lr=1e-3, moment_dtype="float32")


def _setup(tmp_path, trace, max_steps=24, a_bid=0.5, step_time=300.0):
    cfg = get_smoke_config("glm4-9b")
    train_step = make_train_step(cfg, OPT, remat=False, q_block=16, kv_block=16)
    data = TokenStream(vocab_size=cfg.vocab_size, batch=2, seq_len=32, seed=7, device="cpu")

    def init():
        params = T.init_params(cfg, 0, device="cpu")
        return params, adamw_init(params, OPT)

    tcfg = SpotTrainerConfig(
        a_bid=a_bid, ckpt_dir=str(tmp_path), max_steps=max_steps, step_time_s=step_time,
        sim=SimParams(t_c=300.0, t_r=600.0), async_io=False,
    )
    return SpotTrainer(tcfg, train_step=train_step, init_params=init, data=data, trace=trace), data


def test_uninterrupted_run_completes(tmp_path):
    trainer, _ = _setup(tmp_path / "a", step_trace([(0.0, 0.40)]))
    report = trainer.run()
    assert report.completed and report.n_preemptions == 0 and report.steps_done == 24
    assert report.cost > 0
    assert np.mean(report.losses[-5:]) < np.mean(report.losses[:5])


def test_preemption_checkpoint_restore_and_equivalence(tmp_path):
    """The spike covers t_cd / t_td of hour 1 (3600) and ends at 4000: the
    trainer checkpoints, is preempted, restores and ends on the uninterrupted
    run's loss, bit for bit (raw codec; the data order is a function of step)."""
    trace = step_trace([(0.0, 0.40), (3200.0, 1.00), (4000.0, 0.40)])
    trainer, _ = _setup(tmp_path / "spot", trace)
    with obs.Telemetry() as tel:
        report = trainer.run()
    assert report.completed and report.n_preemptions == 1
    assert report.n_checkpoints >= 1 and report.n_restores == 1
    names = [e.name for e in tel.events]
    assert names.count("E_launch") == 2 and names.count("trainer.lease") == 2
    assert "E_ckpt" in names and "E_terminate" in names
    assert tel.counter("trainer.preemptions") == 1 and tel.counter("trainer.restores") == 1

    quiet, _ = _setup(tmp_path / "quiet", step_trace([(0.0, 0.40)]))
    ref = quiet.run()
    assert ref.completed
    assert report.losses[-1] == ref.losses[-1]
    assert report.virtual_time_s > ref.virtual_time_s


def test_preemption_cost_follows_billing(tmp_path):
    trace = step_trace([(0.0, 0.40), (3200.0, 1.00), (4000.0, 0.40)])
    trainer, _ = _setup(tmp_path / "b", trace)
    report = trainer.run()
    assert report.lease_log[0][1] == pytest.approx(3600.0)
    assert report.cost == pytest.approx(sum(0.40 * np.ceil((e - s) / HOUR - 1e-9) for s, e in report.lease_log))


def test_straggler_watchdog_fires(tmp_path):
    trainer, data = _setup(tmp_path / "c", step_trace([(0.0, 0.40)]), max_steps=12)
    events = []
    trainer.on_straggler = lambda step, wall, ewma: events.append(step)
    orig = trainer.train_step
    p0, o0 = trainer.init_params()
    orig(p0, o0, data.batch_at(0))
    walls = []

    def slow_step(p, o, b):
        # the 9th step stalls for 10x the slowest step so far, so it stands out of
        # the EWMA however loaded the machine is (eager steps vary more than jitted ones)
        if len(walls) == 8:
            time.sleep(max(0.5, 10 * max(walls)))
        t0 = time.monotonic()
        out = orig(p, o, b)
        walls.append(time.monotonic() - t0)
        return out

    trainer.train_step = slow_step
    report = trainer.run()
    assert report.straggler_events >= 1 and events


def test_model_size_aware_t_c(tmp_path):
    trainer, _ = _setup(tmp_path / "d", step_trace([(0.0, 0.40)]), max_steps=2)
    params, opt = trainer.init_params()
    bytes_ = trainer._state_bytes(params, opt)
    n = sum(x.numel() for x in [*params.values()] if isinstance(x, torch.Tensor))
    assert bytes_ > 2 * n  # bf16 params plus two float32 moments
    assert trainer._virtual_t_c(params, opt) == pytest.approx(bytes_ / 2e9)
    trainer.cfg = dataclasses.replace(trainer.cfg, codec="int8")
    assert trainer._virtual_t_c(params, opt) < bytes_ / 2e9 / 2


def test_int8_campaign_restores_within_the_codec_step(tmp_path):
    trace = step_trace([(0.0, 0.40), (3200.0, 1.00), (4000.0, 0.40)])
    trainer, _ = _setup(tmp_path / "q", trace, max_steps=12)
    trainer.cfg = dataclasses.replace(trainer.cfg, codec="int8")
    trainer.mgr.codec_name = "int8"
    report = trainer.run()
    assert report.completed and report.n_preemptions == 1 and report.n_restores == 1
    assert all(np.isfinite(report.losses))


def test_from_scenario_plumbing(tmp_path):
    from repro_torch.engine import Scenario

    it = get_instance("m1.xlarge")
    sc = Scenario.grid(work_s=3600.0, bids=(0.5, 0.6), instances=(it,), horizon_days=2.0, bid_fractions=True,
                       params=SimParams(t_c=120.0))
    trainer = SpotTrainer.from_scenario(
        sc, ckpt_dir=str(tmp_path), train_step=lambda *a: None, init_params=lambda: (None, None), data=None,
        bid_index=1, max_steps=5,
    )
    assert trainer.cfg.a_bid == round(0.6 * it.on_demand, 3)
    assert trainer.cfg.sim.t_c == 120.0 and trainer.cfg.max_steps == 5
    assert trainer.trace.horizon == sc.materialize()[0].trace.horizon
    np.testing.assert_array_equal(trainer.trace.prices, sc.materialize()[0].trace.prices)


# ---------------------------------------------------------------------------
# Degraded recovery (tests/train/test_degraded_recovery.py), stand-in step
# ---------------------------------------------------------------------------


def _arrays(spike_hours=((3, 4), (6, 7))):
    t = np.arange(0, 3600.0 * 24 + 300, 300.0)
    p = np.full(len(t) - 1, 0.1)
    for lo, hi in spike_hours:
        p[(t[:-1] >= 3600 * lo) & (t[:-1] < 3600 * hi)] = 2.0
    return t, p


def _trace(spike_hours=((3, 4), (6, 7))):
    return PriceTrace(*_arrays(spike_hours))


def _step(params, opt, batch):
    return params + 1, opt, {"loss": float(params)}


class _Data:
    """Minimal TokenStream stand-in with resumable state."""

    def __init__(self):
        self.i = 0

    def __next__(self):
        self.i += 1
        return self.i

    def state_dict(self):
        return {"i": self.i}

    def load_state_dict(self, s):
        self.i = s["i"]


def _stand_in(pkg, tmp_path, trace, max_steps=110, **kw):
    trainer_cls, cfg_cls, sim_cls = pkg
    cfg = cfg_cls(a_bid=0.5, ckpt_dir=str(tmp_path / "ckpt"), max_steps=max_steps, step_time_s=300.0,
                  sim=sim_cls(t_c=60.0, t_w=60.0, t_r=60.0), async_io=False, keep=4, **kw)
    return trainer_cls(cfg, train_step=_step, init_params=lambda: (np.float64(0.0), np.float64(0.0)),
                       data=_Data(), trace=trace)


PORT = (SpotTrainer, SpotTrainerConfig, SimParams)
JAX = (JaxSpotTrainer, JaxSpotTrainerConfig, JaxSimParams)


def _trainer(tmp_path, trace, max_steps=110):
    return _stand_in(PORT, tmp_path, trace, max_steps)


def test_clean_two_preemption_run_baseline(tmp_path):
    rep = _trainer(tmp_path, _trace()).run()
    assert rep.completed and rep.n_preemptions == 2
    assert rep.n_restores == 2 and rep.restore_fallbacks == 0


def test_corrupt_latest_falls_back_to_older_checkpoint(tmp_path):
    tr = _trainer(tmp_path, _trace())
    plan = faults.FaultPlan([faults.FaultRule(site="ckpt.restore", key="77")], seed=0)
    with plan, obs.Telemetry() as tel:
        rep = tr.run()
    assert rep.completed and rep.steps_done == tr.cfg.max_steps
    assert rep.restore_fallbacks == 1 and rep.n_restores == 2
    assert tel.counter("trainer.restore_fallbacks") == 1 and tel.counter("trainer.restores") == 2
    assert [a.key for a in plan.log] == ["77"]
    assert [e.name for e in tel.events].count("trainer.restore_fallback") == 1
    assert tr.mgr.steps() == [44]
    assert os.path.isdir(os.path.join(tr.mgr.root, "step_000000077.corrupt"))


def test_every_checkpoint_corrupt_restarts_from_scratch(tmp_path):
    tr = _trainer(tmp_path, _trace())
    plan = faults.FaultPlan([faults.FaultRule(site="ckpt.restore", p=1.0, max_fires=99)], seed=0)
    with plan, obs.Telemetry() as tel:
        rep = tr.run()
    assert rep.completed and rep.steps_done == tr.cfg.max_steps
    assert rep.n_restores == 0 and rep.restore_fallbacks >= 1
    assert tel.counter("trainer.restore_fallbacks") == rep.restore_fallbacks


def test_scratch_restart_resets_data_iterator_consistently(tmp_path):
    tr = _trainer(tmp_path, _trace(spike_hours=((3, 4),)))
    plan = faults.FaultPlan([faults.FaultRule(site="ckpt.restore", p=1.0, max_fires=99)], seed=0)
    with plan:
        rep = tr.run()
    assert rep.completed and rep.steps_done == tr.cfg.max_steps
    assert tr.data.i == rep.steps_done
    assert len(rep.losses) > rep.steps_done


def test_no_plan_means_no_fallbacks(tmp_path):
    rep = _trainer(tmp_path, _trace()).run()
    assert rep.restore_fallbacks == 0
    assert faults.current() is faults.NULL


def test_report_losses_match_executed_steps(tmp_path):
    tr = _trainer(tmp_path, _trace())
    plan = faults.FaultPlan([faults.FaultRule(site="ckpt.restore", key="77")], seed=0)
    with plan:
        rep = tr.run()
    clean = _trainer(tmp_path / "clean", _trace()).run()
    assert len(rep.losses) == len(clean.losses) + (77 - 44)


# ---------------------------------------------------------------------------
# The port's report against the JAX package's
# ---------------------------------------------------------------------------

FIELDS = ("completed", "steps_done", "virtual_time_s", "cost", "n_checkpoints", "n_preemptions", "n_restores",
          "restore_fallbacks", "losses", "lease_log")
RULES = {
    "clean": [],
    "fallback": [dict(site="ckpt.restore", key="77")],
    "all_corrupt": [dict(site="ckpt.restore", p=1.0, max_fires=99)],
    "torn_save": [dict(site="ckpt.save", kind="torn", p=0.5, max_fires=3)],
}


def _market(kind):
    """(port trace, JAX trace) of the same prices."""
    if kind == "spikes":
        t, p = _arrays()
    elif kind == "one_spike":
        t, p = _arrays(((3, 4),))
    else:  # a calibrated synthetic trace, the market of repro_torch.launch.train
        tr = synthetic_trace(get_instance("m1.xlarge", "eu-west-1"), horizon_days=10, seed=3)
        jtr = jax_synthetic_trace(jax_get_instance("m1.xlarge", "eu-west-1"), horizon_days=10, seed=3)
        np.testing.assert_array_equal(tr.prices, jtr.prices)
        return tr, jtr
    return PriceTrace(t, p), JaxPriceTrace(t.copy(), p.copy())


@pytest.mark.parametrize("market", ["spikes", "one_spike", "synthetic"])
@pytest.mark.parametrize("rules", list(RULES))
def test_report_equals_the_jax_trainers(tmp_path, market, rules):
    tr, jtr = _market(market)
    a_bid = 0.5 if market != "synthetic" else 0.40
    max_steps = 110 if market != "synthetic" else 300
    port = _stand_in(PORT, tmp_path / "port", tr, max_steps=max_steps)
    jax_ = _stand_in(JAX, tmp_path / "jax", jtr, max_steps=max_steps)
    port.cfg = dataclasses.replace(port.cfg, a_bid=a_bid)
    jax_.cfg = dataclasses.replace(jax_.cfg, a_bid=a_bid)
    plan = faults.FaultPlan([faults.FaultRule(**r) for r in RULES[rules]], seed=3)
    jplan = jax_faults.FaultPlan([jax_faults.FaultRule(**r) for r in RULES[rules]], seed=3)
    with plan:
        rep = port.run()
    with jplan:
        jrep = jax_.run()
    for f in FIELDS:
        assert getattr(rep, f) == getattr(jrep, f), f
    assert [a.describe() for a in plan.log] == [a.describe() for a in jplan.log]
    assert port.mgr.steps() == jax_.mgr.steps()
    if market == "spikes":
        assert rep.n_preemptions == 2
