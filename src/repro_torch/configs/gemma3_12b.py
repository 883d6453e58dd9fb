"""gemma3-12b [dense] — 5:1 local:global, 128k ctx [hf:google/gemma-3; unverified].

48L d_model=3840 16H (GQA kv=8) head_dim=256 d_ff=15360 vocab=262144.
Pattern: 5 sliding-window (1024) layers per 1 global layer; tied embeddings
with sqrt(d) scaling; one rope_theta for local and global layers (the
reference's simplification).  Same values as `repro.configs.gemma3_12b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    d_model=3840,
    num_layers=48,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    pattern=("dense:window",) * 5 + ("dense",),
    window_size=1024,
    tie_embeddings=True,
    embed_scale=True,
    act="swiglu",
    subquadratic=True,
)

SMOKE = CONFIG.with_(
    d_model=64, num_layers=12, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, window_size=16,
)
