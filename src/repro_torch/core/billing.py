"""How an instance run ended, which decides how its last hour is billed.

EC2 spot billing (paper §IV) charges each instance-hour at the price in
effect at its start.  The final partial hour is free when the provider ends
the run (out-of-bid) and charged in full when the user does (job completion
counts as a user termination); a termination exactly on an hour boundary
never starts (or pays) the next hour.  :func:`bill_run` and :func:`run_cost`
apply these rules to one run (the live trainer bills each lease with them);
the fold that applies them to a whole grid lives in
:func:`repro_torch.engine.batch._bill_runs_flat`.

``run_cost`` sums with the builtin ``sum()``, as
:func:`repro.core.billing.run_cost` does: Python 3.12's ``sum()`` of floats is
compensated, so it can differ from a left-to-right fold by an ulp, and the
trainer's ``cost`` is held ``==`` to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import enum
import math

from repro_torch.core.market import HOUR, PriceTrace


class Termination(enum.Enum):
    OUT_OF_BID = "out_of_bid"  # provider kill: partial hour free
    USER = "user"  # forced by user (incl. job completion): full hour charged


@dataclasses.dataclass(frozen=True)
class BillingItem:
    hour_start: float
    price: float
    charged: bool


def bill_run(
    trace: PriceTrace,
    launch: float,
    end: float,
    termination: Termination,
    billing_period_s: float = HOUR,
) -> list[BillingItem]:
    """Itemized bill for one instance run ``[launch, end)``.

    Returns one item per started billing period.  ``charged=False`` only on
    the final partial period of an out-of-bid kill.
    """
    if end < launch:
        raise ValueError(f"end {end} < launch {launch}")
    if end == launch:
        return []
    items: list[BillingItem] = []
    n_periods = int(math.ceil((end - launch) / billing_period_s - 1e-12))
    for k in range(n_periods):
        start = launch + k * billing_period_s
        full = start + billing_period_s <= end + 1e-9
        charged = full or termination == Termination.USER
        items.append(BillingItem(hour_start=start, price=trace.price_at(start), charged=charged))
    return items


def run_cost(
    trace: PriceTrace,
    launch: float,
    end: float,
    termination: Termination,
    billing_period_s: float = HOUR,
) -> float:
    return sum(i.price for i in bill_run(trace, launch, end, termination, billing_period_s) if i.charged)
