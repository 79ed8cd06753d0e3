"""NumPy reference for the fleet EET scoring op.

One placement wave of the vectorized fleet engine scores a ``(lane, type)``
matrix at once: each entry's Eq. 8 expected execution time from the
pre-summed pdf terms.  The heavy prefix sums (``p_fail`` / ``wasted``) are
memoized per ``(seed, type, bid, w_bins)`` by :mod:`repro_torch.fleet.batch` using
the *verbatim* scalar expressions of
:func:`repro_torch.core.provision.expected_execution_time`; this op is the final
elementwise combine — also expression-for-expression the scalar's, so every
score is bit-identical to a direct ``ctx.eet`` / ``algorithm1`` call.
"""

from __future__ import annotations

import numpy as np


def eet_scores_numpy(
    p_fail: np.ndarray,
    wasted: np.ndarray,
    w_scaled: np.ndarray,
    avail: np.ndarray,
) -> np.ndarray:
    """Eq. 8 combine for a ``(lane, type)`` wave.

    ``avail`` is False for types whose history never dips below the bid (the
    all-censored pdf Eq. 8 would misread): those score ``inf``, exactly as
    :meth:`repro_torch.fleet.policies.PlacementContext.eet` and
    :func:`repro_torch.core.provision.algorithm1` return ``math.inf`` for them.
    """
    p_succeed = 1.0 - p_fail
    ok = avail & (p_succeed > 0.0)
    den = np.where(ok, p_succeed, 1.0)
    # scalar: (work_s * p_succeed + wasted) / p_succeed — same association
    return np.where(ok, (w_scaled * p_succeed + wasted) / den, np.inf)
