"""Hand-written GPU kernels of the port and their plain PyTorch versions.

Each kernel lives in a ``<name>/`` package: ``ops.py`` (the op the program
calls, and the one place that picks the kernel or the plain version),
``ref.py`` (the plain PyTorch version, which every device but the card runs),
``kernel.py`` (the launch wrapper, which raises off the card) and
``csrc/*.cu`` (the CUDA source, built by :mod:`repro_torch.kernels._build`
at first use on a machine with ``nvcc``).
"""

#: What an op's ``impl`` may ask for: ``None`` (the kernel on a CUDA tensor,
#: the plain version on any other) or ``"plain"`` (the plain version on any
#: device).
IMPLS = (None, "plain")


def check_impl(impl) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
