"""xlstm-1.3b [ssm] — sLSTM + mLSTM blocks [arXiv:2405.04517; unverified].

48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304.  d_ff=0: mixer-only
blocks (the xLSTM block's projections live inside the mixer).  Same values
as `repro.configs.xlstm_1_3b`.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    d_model=2048,
    num_layers=48,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=("mlstm", "slstm"),
    subquadratic=True,
)

SMOKE = CONFIG.with_(
    d_model=64, num_layers=4, num_heads=2, num_kv_heads=2, vocab_size=512,
)
