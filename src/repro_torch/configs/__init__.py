"""Architecture registry of the port: ``arch id`` -> :class:`ModelConfig`.

Every architecture of :mod:`repro.configs` is registered (``PORTED_ARCHS``,
in the same order as its ``ARCH_IDS``); the architectures the port runs and
the JAX package does not are registered beside them (``PORT_ONLY_ARCHS``).
An unknown id raises ``KeyError``.
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

_PORT_ONLY_MODULES = {
    "jamba2-mini": "repro_torch.configs.jamba2_mini",
}

PORT_ONLY_ARCHS = tuple(_PORT_ONLY_MODULES)


def _module(arch: str):
    module = _MODULES.get(arch) or _PORT_ONLY_MODULES.get(arch)
    if module is None:
        raise KeyError(f"unknown arch {arch!r}; known: {PORTED_ARCHS + PORT_ONLY_ARCHS}")
    return importlib.import_module(module)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
