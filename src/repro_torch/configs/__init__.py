"""Architecture registry of the port: ``arch id`` -> :class:`ModelConfig`.

Only the architectures whose serving path has been ported are registered
(``PORTED_ARCHS``); the others of :mod:`repro.configs` raise ``KeyError``
here until their families are ported.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
}

PORTED_ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"arch {arch!r} is not ported yet; ported: {PORTED_ARCHS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
