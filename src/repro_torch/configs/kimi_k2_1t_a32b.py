"""kimi-k2-1t-a32b [moe] — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) head_dim=128 vocab=163840, MoE 384e top-8
with 1 shared expert of moe_d_ff=2048; layer 0 dense at d_ff=18432 (the
published K2 dense-layer width).  GQA where the real K2 uses MLA (the
reference's assignment).  1T total / 32B active parameters: the experts
cannot be resident and must stream.  Same values as
`repro.configs.kimi_k2_1t_a32b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    d_model=7168,
    num_layers=61,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,
    vocab_size=163840,
    pattern=("moe",),
    prefix_pattern=("dense",),
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    optimizer="adafactor",
)

SMOKE = CONFIG.with_(
    d_model=64, num_layers=3, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, num_experts=8, experts_per_token=2,
    moe_d_ff=32,
)
