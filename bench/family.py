"""A model family's files, found by the family's name.

The ``"family"`` of a configuration's model block names one module in each
of two packages: ``bench/reference/<family>.py`` (its plain layers, with
``layer``) and ``bench/roofline/families/<family>.py`` (its model-FLOP
counts, with ``matmul_params``).  A configuration of a family the benchmark
has not seen comes in as those two new files; nothing that is there changes.
"""

from __future__ import annotations

import importlib
import pkgutil


def find(package: str, family: str, attr: str):
    """The module ``<package>.<family>``, which defines ``attr``; a
    ``ValueError`` naming the families ``package`` holds where there is none."""
    name = f"{package}.{family}"
    try:
        module = importlib.import_module(name)
    except ModuleNotFoundError as err:
        if err.name != name:
            raise
        module = None
    if not hasattr(module, attr):
        raise ValueError(f"{package} has no {family!r} family; it has {known(package, attr)}")
    return module


def known(package: str, attr: str) -> tuple[str, ...]:
    """The modules of ``package`` that define ``attr``: its families."""
    path = importlib.import_module(package).__path__
    names = sorted(info.name for info in pkgutil.iter_modules(path))
    return tuple(n for n in names if hasattr(importlib.import_module(f"{package}.{n}"), attr))
