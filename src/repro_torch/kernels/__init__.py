"""Hand-written GPU kernels of the port and their plain PyTorch versions.

Each kernel lives in a ``<name>/`` package: ``ref.py`` (the plain PyTorch
version, which the CPU runs), ``kernel.py`` (the launch wrapper) and
``csrc/*.cu`` (the CUDA source, built by :mod:`repro_torch.kernels._build`
at first use on a machine with ``nvcc``).
"""
