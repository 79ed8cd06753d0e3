"""Architecture registry of the port: ``arch id`` -> :class:`ModelConfig`.

Every architecture of :mod:`repro.configs` is registered (``PORTED_ARCHS``,
in the same order as its ``ARCH_IDS``); an unknown id raises ``KeyError``.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "internlm2-20b": "repro_torch.configs.internlm2_20b",
    "starcoder2-7b": "repro_torch.configs.starcoder2_7b",
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "falcon-mamba-7b": "repro_torch.configs.falcon_mamba_7b",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
}

PORTED_ARCHS = tuple(_MODULES)


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {PORTED_ARCHS}")
    return importlib.import_module(_MODULES[arch])


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
