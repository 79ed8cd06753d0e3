"""RG-LRU scan op of the recurrent blocks: CUDA tensors -> the kernel, CPU
tensors or ``impl="plain"`` -> the plain PyTorch version; the decode step is
plain."""

from __future__ import annotations

from repro_torch.kernels import check_impl
from repro_torch.kernels.rglru_scan import kernel, ref


def rglru_scan(log_a, gated_x, *, impl=None):
    check_impl(impl)
    return (ref.rglru_scan if impl == "plain" else kernel.rglru_scan)(log_a, gated_x)


rglru_step = ref.rglru_step
