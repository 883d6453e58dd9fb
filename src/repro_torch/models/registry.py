"""--arch name -> ModelConfig lookup: the six paged token archs the port
serves.  The reference's dense-engine archs (zamba2, xlstm, musicgen,
llama-3.2-vision) are not ported yet."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen1.5-0.5b": "repro_torch.configs.qwen1_5_0_5b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG
