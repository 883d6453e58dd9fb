"""--arch name -> ModelConfig lookup: the reference's ten archs.  The six
attention-cache token archs serve on the paged engine, zamba2 and xlstm
on the dense-cache engine; musicgen (frame embeddings) and
llama-3.2-vision (patch embeddings for its cross layers) run through
`transformer.prefill` / `decode_step`."""
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
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    mod = importlib.import_module(_MODULES[name])
    return mod.SMOKE if smoke else mod.CONFIG
