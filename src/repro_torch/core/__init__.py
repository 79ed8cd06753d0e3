"""Host-side model of the spot market and the checkpointing schemes.

  * market    — instance catalog and calibrated price traces
  * billing   — run termination kinds, the bill of one run (``run_cost``)
  * schemes   — the scheme enum, simulation constants, the failure pdf,
                ACC's decision points
  * simulator — the per-run result records, the relaunch poll
  * provision — the SLA admission filter
  * events    — the monitoring events E_ckpt / E_terminate / E_launch
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
    ensemble_seed,
    get_instance,
    sample_traces_batch,
    step_trace,
    synthetic_trace,
)
from repro_torch.core.provision import SLA
from repro_torch.core.schemes import FailurePdf, Scheme, SimParams, decision_points
from repro_torch.core.simulator import InstanceRun, SimResult

__all__ = [
    "HOUR",
    "SLA",
    "AppState",
    "BillingItem",
    "Event",
    "EventKind",
    "FailurePdf",
    "InstanceRun",
    "InstanceType",
    "Lifecycle",
    "PriceTrace",
    "Scheme",
    "SimParams",
    "SimResult",
    "SpotEventGenerator",
    "Termination",
    "TraceModel",
    "bill_run",
    "catalog",
    "decision_points",
    "ensemble_seed",
    "get_instance",
    "run_cost",
    "sample_traces_batch",
    "step_trace",
    "synthetic_trace",
]
