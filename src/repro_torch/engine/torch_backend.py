"""The torch backend: the fused spot sweep on a torch device.

:class:`TorchEngine` is the counterpart of :class:`repro.engine.JaxEngine`:
built on :func:`~repro_torch.engine.batch.run_batched`, it evaluates every
scheme of a scenario in one call of
:func:`~repro_torch.kernels.spot_sweep.ops.spot_sweep_grid` — the
hand-written CUDA kernel on the GPU, the plain PyTorch version on the CPU —
and bills the per-period run records on the host.  The grid and table
arrays go to the device once per scenario.
"""

from __future__ import annotations

from repro_torch.engine.base import EngineResult, resolve_device
from repro_torch.engine.batch import run_batched
from repro_torch.engine.scenario import Scenario
from repro_torch.kernels.spot_sweep import ops as sweep_ops


class TorchEngine:
    """The fused sweep on ``device`` (the GPU unless ``device="cpu"``; raises
    at construction when a GPU is asked for and none is present).

    ``impl="plain"`` runs the plain PyTorch version on that device instead
    of the kernel — the yardstick the kernel is held to on the card.
    """

    name = "torch"

    def __init__(self, device=None, impl: str | None = None):
        if impl not in sweep_ops.IMPLS:
            raise ValueError(f"unknown spot_sweep impl {impl!r}; expected one of {sweep_ops.IMPLS}")
        self.device = resolve_device(device)
        self.impl = impl

    def run(self, scenario: Scenario) -> EngineResult:
        return run_batched(scenario, self.name, self._run_schemes)

    def _run_schemes(self, schemes, grid, scenario, adapt_tables):
        return sweep_ops.spot_sweep_grid(
            schemes, grid, scenario, adapt_tables, device=self.device, impl=self.impl
        )
