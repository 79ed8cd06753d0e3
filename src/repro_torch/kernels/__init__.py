"""Hand-written GPU kernels of the port and their plain PyTorch versions.

Each kernel lives in a ``<name>/`` package: ``ref.py`` (the plain PyTorch
version, which the CPU runs), ``kernel.py`` (the launch wrapper) and
``csrc/*.cu`` (the CUDA source, built by :mod:`repro_torch.kernels._build`
at first use on a machine with ``nvcc``).
"""

#: What an op's ``impl`` may ask for: ``None`` (the kernel on a CUDA tensor,
#: the plain version on a CPU tensor) or ``"plain"`` (the plain version on any
#: device).
IMPLS = (None, "plain")


def check_impl(impl) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
