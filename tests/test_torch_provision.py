"""Provisioning (Algorithm 1, Eq. 7-8) and the application model (Eq. 1-2,
5-6) of the port, on the CPU, against the JAX package.

The cases of ``tests/core/test_provision.py`` and ``test_appdef.py``, each
through both packages: failure pdfs, survival and hazard, every EET value
and every ``algorithm1`` decision ``==``, the application template and its
validation, and the controller's workflow execution.
"""

import math

import numpy as np
import pytest

import repro.core as R
from repro.core.appdef import Policy as RefPolicy
from repro.core.appdef import Resource as RefResource
from repro.core.appdef import Tier as RefTier

from repro_torch.core import (
    SLA,
    Application,
    Controller,
    EventKind,
    FailurePdf,
    Monitoring,
    ProvisioningDecision,
    Workflow,
    algorithm1,
    catalog,
    expected_execution_time,
    spot_application,
    step_trace,
    synthetic_trace,
)
from repro_torch.core.appdef import Policy, Resource, Tier

KILLS = [(0.0, 0.40), (7200.0, 1.0), (7800.0, 0.40), (11400.0, 1.0), (12000.0, 0.40)]


def churny_segments():
    segs, t = [], 0.0
    for _ in range(100):
        segs += [(t, 0.40), (t + 1800.0, 1.0)]
        t += 3600.0
    return segs, t + 3600.0


def traces(segs, horizon_s):
    return step_trace(segs, horizon_s=horizon_s), R.step_trace(segs, horizon_s=horizon_s)


def test_failure_pdf_survival_and_hazard_match_jax():
    tr, rtr = traces(KILLS, 100 * 3600.0)
    pdf, rpdf = FailurePdf.from_trace(tr, bid=0.50, bin_s=60.0), R.FailurePdf.from_trace(rtr, bid=0.50, bin_s=60.0)
    np.testing.assert_array_equal(pdf.pdf, rpdf.pdf)
    assert pdf.censored == rpdf.censored == pytest.approx(1 / 3)
    assert pdf.pdf[120] == pytest.approx(1 / 3) and pdf.pdf[60] == pytest.approx(1 / 3)
    for age in (0.0, 1800.0, 3 * 3600.0, 7199.0, 7200.0, 1e6):
        assert pdf.survival(age) == rpdf.survival(age)
        assert pdf.hazard(age, 3600.0) == rpdf.hazard(age, 3600.0)
    assert pdf.survival(0.0) == 1.0 and pdf.survival(3 * 3600.0) == pytest.approx(1 / 3)


@pytest.mark.parametrize("work_s", [600.0, 1800.0, 7200.0, 10 * 3600.0, 1e6])
@pytest.mark.parametrize("recovery_s", [0.0, 600.0])
def test_eet_matches_jax(work_s, recovery_s):
    quiet = traces([(0.0, 0.40)], 200 * 3600.0)
    churny = traces(*churny_segments())
    killed = traces(KILLS, 100 * 3600.0)
    for tr, rtr in (quiet, churny, killed):
        pdf, rpdf = FailurePdf.from_trace(tr, 0.50), R.FailurePdf.from_trace(rtr, 0.50)
        got = expected_execution_time(pdf, work_s, recovery_s)
        assert got == R.expected_execution_time(rpdf, work_s, recovery_s)
    pdf_q = FailurePdf.from_trace(quiet[0], 0.50)
    assert expected_execution_time(pdf_q, 7200.0, 600.0) == pytest.approx(7200.0)


def test_eet_increases_with_failure_rate():
    pdf_q = FailurePdf.from_trace(step_trace([(0.0, 0.40)], horizon_s=200 * 3600.0), 0.50)
    pdf_c = FailurePdf.from_trace(step_trace(*churny_segments()), 0.50)
    w = 2 * 3600.0
    assert expected_execution_time(pdf_c, w, 600.0) > expected_execution_time(pdf_q, w, 600.0)
    long = expected_execution_time(pdf_c, 10 * 3600.0, 600.0)
    assert math.isinf(long) or long > 10 * 3600.0


def same_decision(got: ProvisioningDecision, want) -> None:
    assert got.a_bid == want.a_bid
    assert got.instance.name == want.instance.name and got.eet_s == want.eet_s
    assert got.candidates == want.candidates


@pytest.mark.parametrize(
    "sla", [dict(min_compute_units=8.0, regions=("eu-west-1",), os="linux"), dict(min_compute_units=2.0),
            dict(min_compute_units=4.0, regions=("us-east-1", "ap-southeast-1"))],
    ids=["eu-linux-8", "any-2", "two-regions-4"],
)
@pytest.mark.parametrize("work_h", [1.0, 5.0, 40.0])
def test_algorithm1_decisions_match_jax(sla, work_h):
    feasible = [it for it in catalog() if SLA(**sla).admits(it)]
    rcat = R.catalog()
    histories = {it.name: synthetic_trace(it, horizon_days=20, seed=3) for it in feasible}
    rhist = {it.name: R.synthetic_trace(it, horizon_days=20, seed=3) for it in rcat if R.SLA(**sla).admits(it)}
    cache, rcache = {}, {}
    got = algorithm1(work_h * 3600.0, SLA(**sla), catalog(), histories, recovery_s=600.0, pdf_cache=cache)
    want = R.algorithm1(work_h * 3600.0, R.SLA(**sla), rcat, rhist, recovery_s=600.0, pdf_cache=rcache)
    same_decision(got, want)
    assert got.a_bid == min(it.on_demand for it in feasible)  # Eq. 7
    assert got.eet_s == min(got.candidates.values()) and set(cache) == set(rcache)
    same_decision(algorithm1(work_h * 3600.0, SLA(**sla), catalog(), histories, 600.0, pdf_cache=cache), want)


def test_algorithm1_never_available_type_and_errors():
    cat = [it for it in catalog() if it.region == "eu-west-1" and it.os == "linux"][:3]
    rcat = [it for it in R.catalog() if it.region == "eu-west-1" and it.os == "linux"][:3]
    hist = {cat[0].name: step_trace([(0.0, 99.0)], horizon_s=50 * 3600.0)}  # never below A_bid
    hist[cat[1].name] = synthetic_trace(cat[1], horizon_days=10, seed=1)
    rhist = {rcat[0].name: R.step_trace([(0.0, 99.0)], horizon_s=50 * 3600.0),
             rcat[1].name: R.synthetic_trace(rcat[1], horizon_days=10, seed=1)}
    got = algorithm1(3 * 3600.0, SLA(), cat, hist)
    same_decision(got, R.algorithm1(3 * 3600.0, R.SLA(), rcat, rhist))
    assert math.isinf(got.candidates[cat[0].name])
    with pytest.raises(ValueError, match="SLA"):
        algorithm1(3600.0, SLA(min_compute_units=1e9), catalog(), {})
    with pytest.raises(ValueError, match="history"):
        algorithm1(3600.0, SLA(), cat, {})


def app_view(app) -> dict:
    """A package-neutral view of an Application (enums by value)."""
    mon = app.monitoring
    return {
        "name": app.name,
        "tiers": [t.name for t in app.tiers],
        "resources": [(r.name, r.provider, r.type, r.size) for r in app.resources],
        "resource_map": app.resource_map,
        "policies": [(p.name, p.spec) for p in app.policies],
        "users": app.users,
        "events": [e.value for e in mon.events],
        "workflows": [(w.name, w.actions) for w in mon.workflows],
        "event_map": {k.value: v for k, v in mon.event_map.items()},
        "workflow_map": {k: v.value for k, v in mon.workflow_map.items()},
    }


@pytest.mark.parametrize("args", [("genome-job", "m1.xlarge", 0.44, 10.0), ("j", "m1.small", 0.05, 1.0)])
def test_spot_application_matches_jax(args):
    app = spot_application(*args, sla={"min_ecu": 4}, ckpt_volume_size="8GB")
    assert app_view(app) == app_view(R.spot_application(*args, sla={"min_ecu": 4}, ckpt_volume_size="8GB"))
    app = spot_application(*args)
    assert app_view(app) == app_view(R.spot_application(*args))
    mon = app.monitoring
    assert set(mon.events) == {EventKind.CKPT, EventKind.TERMINATE, EventKind.LAUNCH}
    assert mon.workflow_for(EventKind.LAUNCH).actions == ("launch_spot", "mount_volume", "resume_tasks")
    assert next(p for p in app.policies if p.name == "bids").spec == {"A_bid": args[2], "S_bid": args[3]}


@pytest.mark.parametrize(
    "break_it, match",
    [(lambda a: {**a, "resource_map": {"r9": "t1"}}, "unknown resource"),
     (lambda a: {**a, "resource_map": {"r1": "t9"}}, "unknown tier"),
     (lambda a: {**a, "workflows": ("W_other",)}, "unknown workflow"),
     (lambda a: {**a, "events": ("LAUNCH",)}, "unregistered event"),
     (lambda a: {**a, "event_map": {"LAUNCH": "nowhere"}}, "unknown target")],
)
def test_validate_rejects_what_jax_rejects(break_it, match):
    """Each broken application, built in both packages: both refuse it alike."""
    base = {"resource_map": {"r1": "t1"}, "workflows": ("W_ckpt",), "events": ("CKPT", "LAUNCH"),
            "event_map": {"LAUNCH": "r1"}}
    spec = break_it(base)

    def build(tier, resource, policy, workflow, monitoring, application, kind):
        wfs = tuple(workflow(n, ("save_results",)) for n in spec["workflows"])
        mon = monitoring(
            events=tuple(kind[e] for e in spec["events"]), workflows=wfs,
            event_map={kind[k]: v for k, v in spec["event_map"].items()},
            workflow_map={"W_ckpt": kind.CKPT},
        )
        return application(
            name="x", tiers=(tier("t1"),), resources=(resource("r1", "ec2", "spot_instance", "m1.small"),),
            resource_map=spec["resource_map"], policies=(policy("bids", {}),), users=("u",), monitoring=mon,
        )

    app = build(Tier, Resource, Policy, Workflow, Monitoring, Application, EventKind)
    rapp = build(RefTier, RefResource, RefPolicy, R.Workflow, R.Monitoring, R.Application, R.EventKind)
    with pytest.raises(ValueError) as want:
        rapp.validate()
    with pytest.raises(ValueError, match=match) as got:
        app.validate()
    assert str(got.value) == str(want.value)


def test_controller_executes_workflows_as_jax():
    for pkg_app, pkg_ctl, kinds in ((spot_application, Controller, EventKind),
                                    (R.spot_application, R.Controller, R.EventKind)):
        app = pkg_app("j", "m1.small", 0.05, 1.0)
        calls = []
        registry = {a: (lambda a=a: (lambda **ctx: calls.append((a, ctx))))()
                    for wf in app.monitoring.workflows for a in wf.actions}
        ctl = pkg_ctl(registry)
        ctl.execute(app.monitoring.workflow_for(kinds.LAUNCH), step=3)
        assert calls == [(a, {"step": 3}) for a in ("launch_spot", "mount_volume", "resume_tasks")]
        assert ctl.log == ["W_launch:launch_spot", "W_launch:mount_volume", "W_launch:resume_tasks"]
        with pytest.raises(KeyError, match="no handler"):
            pkg_ctl({}).execute(app.monitoring.workflow_for(kinds.CKPT))
        with pytest.raises(KeyError, match="no workflow"):
            app.monitoring.workflow_for(object())
