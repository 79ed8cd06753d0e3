"""The port's fault plan against the JAX package's: the same decisions.

Whether a site fires is a pure function of (seed, site, key) and the number
of earlier hits at that pair; for the same plan, the port's
:class:`FaultPlan` must fire exactly where :class:`repro.faults.FaultPlan`
does.
"""

import json

import pytest

from repro import faults as jax_faults
from repro_torch import faults, obs

RULES = [
    dict(site="ckpt.save", kind="torn", p=0.3, max_fires=2),
    dict(site="ckpt.restore", kind="raise", p=0.5, after=1),
    dict(site="ckpt.save", kind="raise", p=1.0, key="17"),
    dict(site="other.site", kind="hang", p=0.7, delay_s=0.0),
]


@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_decisions_equal_the_jax_plan(seed):
    plan = faults.FaultPlan([faults.FaultRule(**r) for r in RULES], seed=seed)
    jplan = jax_faults.FaultPlan([jax_faults.FaultRule(**r) for r in RULES], seed=seed)
    for site in ("ckpt.save", "ckpt.restore", "other.site"):
        for key in list(range(40)) + ["17", "a/b"]:
            for _ in range(3):
                a, b = plan.fire(site, key), jplan.fire(site, key)
                assert (a is None) == (b is None), (site, key)
                if a is not None:
                    assert (a.site, a.kind, a.key, a.hit, a.delay_s) == (b.site, b.kind, b.key, b.hit, b.delay_s)
    assert [x.describe() for x in plan.log] == [x.describe() for x in jplan.log]
    assert plan.log  # some fired


def test_activation_is_lifo_and_null_by_default():
    assert faults.current() is faults.NULL
    p1, p2 = faults.FaultPlan(seed=1), faults.FaultPlan(seed=2)
    with p1:
        with faults.activate(p2):
            assert faults.current() is p2
        assert faults.current() is p1
    assert faults.current() is faults.NULL
    with pytest.raises(RuntimeError):
        with faults.NULL:
            pass


def test_check_raises_and_counts_on_telemetry():
    plan = faults.FaultPlan([faults.FaultRule("ckpt.save", kind="raise")])
    with obs.Telemetry() as tel, plan:
        with pytest.raises(faults.InjectedFault):
            faults.current().check("ckpt.save", 3)
        faults.current().check("ckpt.save", 3)  # budget spent
    assert tel.counter("faults.injected") == 1
    assert tel.counter("faults.injected.ckpt.save") == 1


def test_load_plan_and_env(tmp_path, caplog):
    path = tmp_path / "plan.json"
    path.write_text(json.dumps({"seed": 4, "rules": [{"site": "ckpt.restore", "p": 1.0}, {"site": "typo.site"}]}))
    plan = faults.load_plan(path)
    assert plan.seed == 4 and len(plan.rules) == 2
    assert "typo.site" in caplog.text
    assert faults.plan_from_env({faults.ENV_VAR: str(path)}).seed == 4
    assert faults.plan_from_env({}) is None
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"rules": [{"site": "ckpt.save", "bogus": 1}]}))
    with pytest.raises(ValueError, match="unknown fault-rule keys"):
        faults.load_plan(bad)


def test_sites_and_register():
    assert {"ckpt.save", "ckpt.restore"} <= set(faults.SITES)
    faults.register_site("test.port_site", "one hit per test")
    faults.register_site("test.port_site", "one hit per test")
    with pytest.raises(ValueError):
        faults.register_site("test.port_site", "something else")
    with pytest.raises(ValueError):
        faults.FaultRule("ckpt.save", kind="explode")
