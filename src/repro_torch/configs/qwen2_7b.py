"""qwen2-7b [dense] — GQA, QKV bias [arXiv:2407.10671; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  Same values as
`repro.configs.qwen2_7b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    d_model=3584,
    num_layers=28,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    pattern=("dense",),
    qkv_bias=True,
)

SMOKE = CONFIG.with_(
    d_model=64, num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
)
