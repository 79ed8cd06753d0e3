"""Host-side model of the spot market, the checkpointing schemes and provisioning.

  * market    — instance catalog and calibrated price traces
  * billing   — run termination kinds, the bill of one run (``run_cost``)
  * schemes   — NONE/OPT/HOUR/EDGE/ADAPT and the paper's ACC, simulation
                constants, the failure pdf, ACC's decision points
  * simulator — the scalar discrete-event simulator (paper §VII), the
                single-attempt primitives, the relaunch poll
  * provision — Algorithm 1 (A_bid, instance type by EET) and the SLA filter
  * events    — the monitoring events E_ckpt / E_terminate / E_launch
  * appdef    — A=(T,R,Rm,P,U,M) unified definition + Controller
  * lifecycle — the application lifecycle FSM (paper Fig. 3)
"""

from repro_torch.core.billing import BillingItem, Termination, bill_run, run_cost
from repro_torch.core.events import Event, EventKind, SpotEventGenerator
from repro_torch.core.lifecycle import AppState, Lifecycle
from repro_torch.core.market import (
    HOUR,
    InstanceType,
    PriceTrace,
    TraceModel,
    catalog,
    constant_trace,
    ensemble_seed,
    get_instance,
    sample_traces_batch,
    shift_trace,
    step_trace,
    synthetic_trace,
    synthetic_traces_batch,
    trace_ensemble,
)
from repro_torch.core.provision import SLA, ProvisioningDecision, algorithm1, expected_execution_time
from repro_torch.core.appdef import Application, Controller, Monitoring, Workflow, spot_application
from repro_torch.core.schemes import (
    ALL_SCHEMES,
    REALISTIC_SCHEMES,
    FailurePdf,
    Scheme,
    SimParams,
    adapt_should_checkpoint,
    decision_points,
)
from repro_torch.core.simulator import (
    AttemptResult,
    InstanceRun,
    SimResult,
    simulate,
    simulate_acc_attempt,
    simulate_attempt,
)

__all__ = [
    "ALL_SCHEMES",
    "HOUR",
    "REALISTIC_SCHEMES",
    "SLA",
    "AppState",
    "Application",
    "AttemptResult",
    "BillingItem",
    "Controller",
    "Event",
    "EventKind",
    "FailurePdf",
    "InstanceRun",
    "InstanceType",
    "Lifecycle",
    "Monitoring",
    "PriceTrace",
    "ProvisioningDecision",
    "Scheme",
    "SimParams",
    "SimResult",
    "SpotEventGenerator",
    "Termination",
    "TraceModel",
    "Workflow",
    "adapt_should_checkpoint",
    "algorithm1",
    "bill_run",
    "catalog",
    "constant_trace",
    "decision_points",
    "ensemble_seed",
    "expected_execution_time",
    "get_instance",
    "run_cost",
    "sample_traces_batch",
    "shift_trace",
    "simulate",
    "simulate_acc_attempt",
    "simulate_attempt",
    "spot_application",
    "step_trace",
    "synthetic_trace",
    "synthetic_traces_batch",
    "trace_ensemble",
]
