"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff=1408 (per-expert) vocab=102400, MoE 64e top-6.
Layer 0 dense with d_ff=10944 (published); MLA latent cache (kv_lora=512 +
rope 64); no q compression (q_lora_rank=None).  Same values as
`repro.configs.deepseek_v2_lite_16b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    d_model=2048,
    num_layers=27,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,
    vocab_size=102400,
    pattern=("moe",),
    prefix_pattern=("dense",),
    kv_lora_rank=512,
    q_lora_rank=None,
    rope_head_dim=64,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    rope_theta=1e4,
)

SMOKE = CONFIG.with_(
    d_model=64, num_layers=3, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, kv_lora_rank=32, rope_head_dim=8,
    num_experts=8, experts_per_token=2, moe_d_ff=32,
)
