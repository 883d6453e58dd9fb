"""Model configuration dataclass (the port's copy of `repro.configs.base`).

Field names match the reference's `ModelConfig` one for one, so a config can
be rebuilt field by field from the reference's (`repro_torch.bridge`).  The
reference's `stream` field (its JAX layer streamer's settings) is not part of
this copy; it comes with the streaming slice.  `jdtype` is `torch_dtype`.
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|audio|vlm
    d_model: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # layer composition
    pattern: tuple[str, ...] = ("dense",)
    prefix_pattern: tuple[str, ...] = ()
    head_dim: int | None = None
    # attention
    qkv_bias: bool = False
    rope_theta: float = 1e6
    window_size: int | None = None
    # MLA
    kv_lora_rank: int | None = None
    q_lora_rank: int | None = None
    rope_head_dim: int = 64
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int | None = None
    moe_capacity_factor: float = 1.25
    moe_serve_resident: bool = False
    moe_ep_mode: str = "tp"
    # SSM
    ssm_state_dim: int = 0
    ssm_expansion: int = 2
    # modality
    input_mode: str = "tokens"       # tokens | embeddings
    encoder_tokens: int = 0
    # misc
    act: str = "swiglu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma-style sqrt(d) embedding scaling
    dtype: str = "bfloat16"
    subquadratic: bool = False
    dense_kernel: str = "auto"       # kernels.ops.dense routing for every
                                     # projection: auto | ref | kernel —
                                     # auto launches the CUDA gpp_matmul on
                                     # a CUDA tensor, the plain path on CPU
    paged_attn_kernel: str = "auto"  # kernels.ops.paged_attn routing for the
                                     # paged read path: auto | ref | kernel
    remat: str = "block"
    optimizer: str = "adamw"
    # serving (paged-KV engine defaults; ServeConfig overrides)
    serve_block_size: int = 16       # tokens per paged-KV block
    serve_token_budget: int = 0      # flat per-step token target; 0 = auto
    prefix_cache: bool = False       # radix-tree prefix reuse (later slice)
    prefix_cache_blocks: int = 0
    speculation: bool = False        # speculative decoding via verify steps
    draft_len: int = 4               # max draft tokens per lane per verify
    obs: bool = False                # telemetry facade (later slice)
    obs_trace_capacity: int = 65536
    metrics_retention: int = 0       # ledger rows kept (0 = unbounded)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def num_superblocks(self) -> int:
        body = self.num_layers - len(self.prefix_pattern)
        if body % len(self.pattern):
            raise ValueError(
                f"{self.name}: {body} body layers not divisible by pattern "
                f"{self.pattern}")
        return body // len(self.pattern)

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- analytic parameter counts (the ledger's weight-stream bytes) ----
    def _block_params(self, kind: str) -> int:
        d, f, hd = self.d_model, self.d_ff, self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        base = kind.split(":")[0]
        if base not in ("dense", "shared_attn"):
            raise ValueError(f"{kind!r} blocks are not part of this port yet")
        n_mlp = d * f * (3 if self.act == "swiglu" else 2)
        return d * H * hd + 2 * d * KV * hd + H * hd * d + n_mlp

    def active_params(self) -> int:
        """Per-token parameter count (embedding + every layer's weights)."""
        n = sum(self._block_params(k) for k in self.prefix_pattern)
        n += sum(self._block_params(k) * self.num_superblocks
                 for k in self.pattern)
        if self.input_mode == "tokens":
            n += self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        return n
