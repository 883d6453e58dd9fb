"""zamba2-2.7b [hybrid] — Mamba2 + shared attn blocks [arXiv:2411.15242; hf].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Pattern: 5 Mamba2 blocks then the shared attention + MLP block (one
parameter set reused by all 9 superblocks).  Same values as
`repro.configs.zamba2_2_7b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    d_model=2560,
    num_layers=54,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    ssm_state_dim=64,
    ssm_expansion=2,
    rope_theta=1e4,
    subquadratic=True,
)

SMOKE = CONFIG.with_(
    d_model=64, num_layers=12, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=512, ssm_state_dim=16,
)
