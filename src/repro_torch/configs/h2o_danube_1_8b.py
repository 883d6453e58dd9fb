"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA [arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.  No head_dim, so
2560 / 32 = 80.  Sliding window 4096 on every layer.  Same values as
`repro.configs.h2o_danube_1_8b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    d_model=2560,
    num_layers=24,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    pattern=("dense:window",),
    window_size=4096,
    rope_theta=1e4,
    subquadratic=True,
)

SMOKE = CONFIG.with_(
    d_model=64, num_layers=2, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=512, window_size=16,
)
