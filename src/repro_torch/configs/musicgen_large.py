"""musicgen-large [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048, GELU FFN.  The
EnCodec frontend is a stub: the caller supplies frame embeddings (B, S, D)
(`embeds`); the backbone predicts codebook tokens.  Same values as
`repro.configs.musicgen_large`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    d_model=2048,
    num_layers=48,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pattern=("dense",),
    input_mode="embeddings",
    act="gelu",
    rope_theta=1e4,
)

SMOKE = CONFIG.with_(
    d_model=64, num_layers=2, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=64,
)
