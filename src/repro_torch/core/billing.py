"""How an instance run ended, which decides how its last hour is billed.

EC2 spot billing (paper §IV) charges each instance-hour at the price in
effect at its start.  The final partial hour is free when the provider ends
the run (out-of-bid) and charged in full when the user does (job completion
counts as a user termination).  The fold that applies these rules to a whole
grid lives in :func:`repro_torch.engine.batch._bill_runs_flat`.
"""

from __future__ import annotations

import enum


class Termination(enum.Enum):
    OUT_OF_BID = "out_of_bid"  # provider kill: partial hour free
    USER = "user"  # forced by user (incl. job completion): full hour charged
