"""fleet_step: the fleet engine's per-wave EET scoring op.

  * ``ref.py`` — NumPy reference (:func:`~.ref.eet_scores_numpy`), the copy
    of :mod:`repro.kernels.fleet_step.ref`;
  * ``ops.py`` — :func:`~.ops.eet_scores`, the same combine as torch
    elementwise ops on a device.

The JAX package computes it as jitted ``jnp`` outside any Pallas kernel, so
torch ops are its counterpart; no CUDA source is built for it.
"""

from repro_torch.kernels.fleet_step.ops import eet_scores

__all__ = ["eet_scores"]
