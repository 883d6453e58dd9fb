"""--arch name -> ModelConfig lookup (the archs this port serves so far)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG
