"""repro_torch: the §VII checkpointing-scheme study on PyTorch and CUDA.

The PyTorch port of :mod:`repro`'s simulation main path.  It keeps
``repro``'s layout and names (``core``, ``engine``, ``kernels``, ``obs``) so
each module's counterpart is easy to find, but it imports neither ``jax`` nor
any ``repro`` module: what it needs of the NumPy host code it keeps as its
own copy.

Entry points run on the GPU unless the caller passes ``device="cpu"``, and
they raise when no GPU is present instead of carrying on on the CPU::

    from repro_torch.engine import BID_LIMITED_SCHEMES, Scenario, run

    sc = Scenario.grid(work_s=24 * 3600.0, bids=[0.5, 0.55], schemes=BID_LIMITED_SCHEMES,
                       seeds=(0,), bid_fractions=True)
    res = run(sc)                  # the hand-written CUDA sweep kernel
    res = run(sc, device="cpu")    # the plain PyTorch version, on the CPU

Library logging follows the JAX package's convention under the port's own
logger name: everything logs under ``"repro_torch"``, which carries a
:class:`logging.NullHandler`, so importing the package configures no
logging; scripts opt in with :func:`configure_logging`, whose level the
``REPRO_LOG`` environment variable sets.
"""

from __future__ import annotations

import logging
import os

logging.getLogger("repro_torch").addHandler(logging.NullHandler())


def configure_logging(level: int | str | None = None, fmt: str = "%(message)s") -> logging.Logger:
    """Attach a plain stream handler (stderr) to the ``"repro_torch"`` logger.

    The level resolves, in order: the ``level`` argument, the ``REPRO_LOG``
    environment variable (``debug`` / ``info`` / ``warning`` / ...), then
    ``INFO``.  Repeated calls reconfigure (the handler is replaced, not
    stacked).  Returns the logger.
    """
    if level is None:
        level = os.environ.get("REPRO_LOG", "info")
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    log = logging.getLogger("repro_torch")
    for h in list(log.handlers):
        if getattr(h, "_repro_configured", False):
            log.removeHandler(h)
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(fmt))
    handler._repro_configured = True
    log.addHandler(handler)
    log.setLevel(level)
    return log
