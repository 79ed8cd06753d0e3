"""SSM scan op of the Mamba blocks: CUDA tensors -> the kernel, CPU tensors
or ``impl="plain"`` -> the plain PyTorch version; the decode step is plain."""

from __future__ import annotations

from repro_torch.kernels import check_impl
from repro_torch.kernels.ssm_scan import kernel, ref


def ssm_scan(dtA, dBx, C, *, impl=None):
    check_impl(impl)
    return (ref.ssm_scan if impl == "plain" else kernel.ssm_scan)(dtA, dBx, C)


ssm_step = ref.ssm_step
