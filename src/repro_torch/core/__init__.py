"""Host-side model of the spot market and the checkpointing schemes.

  * market    — instance catalog and calibrated price traces
  * billing   — run termination kinds
  * schemes   — the scheme enum, simulation constants, the failure pdf
  * simulator — the per-run result records
  * provision — the SLA admission filter
"""

from repro_torch.core.billing import Termination
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
from repro_torch.core.schemes import FailurePdf, Scheme, SimParams
from repro_torch.core.simulator import InstanceRun, SimResult

__all__ = [
    "HOUR",
    "SLA",
    "FailurePdf",
    "InstanceRun",
    "InstanceType",
    "PriceTrace",
    "Scheme",
    "SimParams",
    "SimResult",
    "Termination",
    "TraceModel",
    "catalog",
    "ensemble_seed",
    "get_instance",
    "sample_traces_batch",
    "step_trace",
    "synthetic_trace",
]
