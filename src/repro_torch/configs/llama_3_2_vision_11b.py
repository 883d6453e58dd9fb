"""llama-3.2-vision-11b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.  Every 5th layer
cross-attends to 1600 patch embeddings that the caller supplies (`enc`;
the vision tower is a stub); the other 32 are GQA self-attention.  Same
values as `repro.configs.llama_3_2_vision_11b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    num_layers=40,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    pattern=("dense", "dense", "dense", "dense", "cross"),
    encoder_tokens=1600,
    rope_theta=5e5,
)

SMOKE = CONFIG.with_(
    d_model=64, num_layers=10, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, encoder_tokens=8,
)
