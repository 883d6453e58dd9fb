"""qwen1.5-0.5b [dense] — QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936, tied embeddings
(published 0.5B config).  Same values as `repro.configs.qwen1_5_0_5b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    d_model=1024,
    num_layers=24,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    pattern=("dense",),
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e4,
)

SMOKE = CONFIG.with_(
    d_model=64, num_layers=2, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=512,
)
