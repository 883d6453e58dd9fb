"""Backbone for paged serving: the paged slice of
`repro.models.transformer` — dense and MoE blocks over GQA or MLA
attention.

Parameters and pools keep the reference's tree layout: stacked superblock
leaves carry a leading (num_superblocks, ...) dim, so `pool[i]` / `w[i]` is
a contiguous view for the kernels, and the reference's `jax.lax.scan` over
superblocks is a Python loop here.

Entry points:
  param_specs / init_params(cfg, generator, device)
  forward(params, cfg, batch)          full-sequence logits (the draft
                                       model's rollout)
  paged_cache_specs / init_paged_caches
  prefill_chunk, decode_step_paged, verify_step_paged
The pools are updated in place (the reference returns new ones); each step
function still returns (logits, caches) for a like-for-like call shape.
`forward` runs the reference's resident path; its layer streamer and
sharding arguments come with distribution.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (Spec, embed, embed_specs,
                                       head_logits, init_from_specs,
                                       map_specs, mlp, mlp_specs, rmsnorm,
                                       rmsnorm_specs, stack_specs, unembed)

PAGED_BLOCK_KINDS = ("dense", "moe")


def _attn_cfg(cfg: ModelConfig, kind: str) -> attn.AttnConfig:
    window = cfg.window_size if kind.endswith(":window") else None
    return attn.AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, window=window,
        kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=cfg.q_lora_rank,
        rope_head_dim=cfg.rope_head_dim, dtype=cfg.torch_dtype,
        dense_mode=cfg.dense_kernel, paged_mode=cfg.paged_attn_kernel)


def _moe_cfg(cfg: ModelConfig) -> moe_mod.MoeConfig:
    return moe_mod.MoeConfig(
        d_model=cfg.d_model, d_ff=cfg.moe_d_ff or cfg.d_ff,
        num_experts=cfg.num_experts, experts_per_token=cfg.experts_per_token,
        num_shared_experts=cfg.num_shared_experts,
        capacity_factor=cfg.moe_capacity_factor, act=cfg.act,
        dtype=cfg.torch_dtype, dense_kernel=cfg.dense_kernel)


def supports_paged(cfg: ModelConfig) -> bool:
    kinds = tuple(cfg.prefix_pattern) + tuple(cfg.pattern)
    return (cfg.input_mode == "tokens"
            and all(k.split(":")[0] in PAGED_BLOCK_KINDS for k in kinds))


def _check_supported(cfg: ModelConfig) -> None:
    if not supports_paged(cfg):
        raise ValueError(
            f"{cfg.name}: this port serves token models of "
            f"{PAGED_BLOCK_KINDS} blocks; kinds "
            f"{tuple(cfg.prefix_pattern) + tuple(cfg.pattern)} are not "
            "ported yet")


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    d, dt = cfg.d_model, cfg.torch_dtype
    sp = {
        "ln1": rmsnorm_specs(d, dt),
        "attn": attn.attn_specs(_attn_cfg(cfg, kind)),
        "ln2": rmsnorm_specs(d, dt),
    }
    if kind.split(":")[0] == "moe":
        sp["moe"] = moe_mod.moe_specs(_moe_cfg(cfg))
    else:
        sp["mlp"] = mlp_specs(d, cfg.d_ff, dt, cfg.act)
    return sp


def param_specs(cfg: ModelConfig) -> dict:
    _check_supported(cfg)
    sp: dict = {"embed": embed_specs(cfg.vocab_size, cfg.d_model,
                                     cfg.torch_dtype)}
    sp["prefix"] = [block_specs(cfg, k) for k in cfg.prefix_pattern]
    sp["blocks"] = {f"b{i}": stack_specs(block_specs(cfg, k),
                                         cfg.num_superblocks)
                    for i, k in enumerate(cfg.pattern)}
    sp["final_norm"] = rmsnorm_specs(cfg.d_model, cfg.torch_dtype)
    if not cfg.tie_embeddings:
        sp["lm_head"] = {"w_out": Spec((cfg.vocab_size, cfg.d_model),
                                       cfg.torch_dtype)}
    return sp


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters from `generator` (which must live on `device`)."""
    return init_from_specs(param_specs(cfg), generator,
                           resolve_device(device))


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """A shallow copy of `params` for serving: it carries one contiguous
    (d_model, vocab) copy of the logits head's table — the tied embedding
    (`embed.embedding_t`) or the untied `lm_head.w_out` (`w_out_t`) — in
    its stored dtype, made here once, which the f32 logits head reads every
    step (`layers.head_logits`)."""
    out = dict(params)
    key, name = (("embed", "embedding") if cfg.tie_embeddings
                 else ("lm_head", "w_out"))
    out[key] = dict(params[key])
    out[key][f"{name}_t"] = params[key][name].t().contiguous()
    return out


# ---------------------------------------------------------------------------
# layer groups (copies of the reference's pure helpers, :412-498)
# ---------------------------------------------------------------------------

def layer_reach(cfg: ModelConfig, kind: str) -> str:
    return "window" if (kind.endswith(":window") and cfg.window_size) \
        else "global"


def layer_group_keys(cfg: ModelConfig) -> "tuple[str, ...]":
    keys: "list[str]" = []
    for k in tuple(cfg.prefix_pattern) + tuple(cfg.pattern):
        r = layer_reach(cfg, k)
        if r not in keys:
            keys.append(r)
    return tuple(keys) or ("global",)


def layer_group_index(cfg: ModelConfig, kind: str) -> int:
    return layer_group_keys(cfg).index(layer_reach(cfg, kind))


def group_horizons(cfg: ModelConfig) -> "tuple[int | None, ...]":
    return tuple(cfg.window_size if k == "window" else None
                 for k in layer_group_keys(cfg))


def is_stacked_cache_path(path) -> bool:
    return "blocks" in path


def cache_path_group(cfg: ModelConfig, path) -> int:
    """Layer-group index of a paged-cache leaf from its path, e.g.
    ("blocks", "b0", "k") or ("prefix", 0, "k")."""
    for i, k in enumerate(path):
        if k == "prefix":
            return layer_group_index(cfg, cfg.prefix_pattern[path[i + 1]])
        if k == "blocks":
            return layer_group_index(cfg, cfg.pattern[int(path[i + 1][1:])])
    raise ValueError(f"not a paged-cache leaf path: {path}")


def _group_table(cfg: ModelConfig, kind: str, tables):
    if isinstance(tables, (tuple, list)):
        return tables[layer_group_index(cfg, kind)]
    return tables


def paged_cache_specs(cfg: ModelConfig, num_blocks: int,
                      block_size: int) -> dict:
    """Pool specs in the reference's tree layout: stacked superblock
    leaves (S, nb, bs, KVH, hd)."""
    _check_supported(cfg)
    return {
        "prefix": [attn.paged_cache_specs(_attn_cfg(cfg, k), num_blocks,
                                          block_size)
                   for k in cfg.prefix_pattern],
        "blocks": {f"b{i}": stack_specs(attn.paged_cache_specs(
            _attn_cfg(cfg, k), num_blocks, block_size), cfg.num_superblocks)
            for i, k in enumerate(cfg.pattern)},
    }


def init_paged_caches(specs: dict, device) -> dict:
    return map_specs(lambda _, s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=device), specs)


# ---------------------------------------------------------------------------
# paged step functions
# ---------------------------------------------------------------------------

def _index(tree, i: int):
    """Layer i of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _tree_layers(tree: dict, cfg: ModelConfig):
    """(kind, layer) per layer of a params or pools tree: the prefix
    layers, then each superblock's pattern in order (the reference's scan
    order)."""
    yield from zip(cfg.prefix_pattern, tree["prefix"])
    for s in range(cfg.num_superblocks):
        for i, kind in enumerate(cfg.pattern):
            yield kind, _index(tree["blocks"][f"b{i}"], s)


def _layers(params: dict, caches: dict, cfg: ModelConfig):
    """(kind, params, pools) per layer."""
    for (kind, p), (_, c) in zip(_tree_layers(params, cfg),
                                 _tree_layers(caches, cfg)):
        yield kind, p, c


def _block(cfg: ModelConfig, kind: str, p, x, attend):
    """One block: attention (`attend(attn_cfg, params, h)` runs the step's
    GQA or MLA function, as the config says), then the MoE or the MLP."""
    h, _ = attend(_attn_cfg(cfg, kind), p["attn"],
                  rmsnorm(p["ln1"], x, mode=cfg.dense_kernel))
    x = x + h
    h = rmsnorm(p["ln2"], x, mode=cfg.dense_kernel)
    if kind.split(":")[0] == "moe":
        h = moe_mod.moe_apply(p["moe"], _moe_cfg(cfg), h)
    else:
        h = mlp(p["mlp"], h, cfg.act, dense_mode=cfg.dense_kernel)
    return x + h


def _embed_tokens(params, cfg: ModelConfig, tokens):
    x = embed(params["embed"], tokens)
    if cfg.embed_scale:
        # the factor rounded to x's dtype first, as the reference does
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def _logits_head(params, cfg: ModelConfig, x):
    x = rmsnorm(params["final_norm"], x, mode=cfg.dense_kernel)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, cfg.dense_kernel)
    head = params["lm_head"]
    return head_logits(x, head["w_out"], head.get("w_out_t"),
                       cfg.dense_kernel)


# ---------------------------------------------------------------------------
# full-sequence forward (the reference's :162-261, resident path)
# ---------------------------------------------------------------------------

def apply_block(cfg: ModelConfig, kind: str, p: dict, x, positions):
    """One attention block over a whole sequence: causal GQA / window or
    MLA self-attention, then the MLP or the MoE."""
    return _block(cfg, kind, p, x, lambda ac, pa, h: (
        (attn.mla_forward if ac.is_mla else attn.gqa_forward)(
            pa, ac, h, positions), None))


def forward(params: dict, cfg: ModelConfig, batch: dict):
    """Full-sequence forward to f32 logits (B, S, vocab).  batch:
    {"tokens": (B, S)}.  Projections run `kernels.ops.dense`, MoE layers
    `dense_grouped`, norms the RMSNorm kernel and the head
    `layers.head_logits`, as the paged step functions do."""
    _check_supported(cfg)
    x = _embed_tokens(params, cfg, batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    for kind, p in _tree_layers(params, cfg):
        x = apply_block(cfg, kind, p, x, positions)
    return _logits_head(params, cfg, x)


def prefill_chunk(params: dict, cfg: ModelConfig, tokens, caches, table_row,
                  start_pos: int, last_idx: int):
    """One prompt chunk of one lane.  tokens: (1, chunk); table_row: the
    lane's (1, MB) table (or one per layer group); start_pos: absolute
    position of tokens[0] (any token index); last_idx: chunk-local index
    whose logits are returned.  Returns (logits (1, vocab), caches)."""
    x = _embed_tokens(params, cfg, tokens)
    for kind, p, c in _layers(params, caches, cfg):
        row = _group_table(cfg, kind, table_row)
        x = _block(cfg, kind, p, x, lambda ac, pa, h, c=c, row=row: (
            attn.mla_prefill_paged if ac.is_mla else attn.gqa_prefill_paged)(
                pa, ac, h, c, row, start_pos))
    logits = _logits_head(params, cfg, x[:, last_idx:last_idx + 1])
    return logits[:, 0], caches


def decode_step_paged(params: dict, cfg: ModelConfig, tokens, caches,
                      tables, positions, active):
    """One batched decode step.  tokens: (slots, 1); tables: (slots, MB);
    positions: (slots,) per-lane; active: (slots,) bool — inactive lanes
    write the null block and their logits are ignored.
    Returns (logits (slots, 1, vocab), caches)."""
    x = _embed_tokens(params, cfg, tokens)
    for kind, p, c in _layers(params, caches, cfg):
        tb = _group_table(cfg, kind, tables)
        x = _block(cfg, kind, p, x, lambda ac, pa, h, c=c, tb=tb: (
            attn.mla_decode_paged if ac.is_mla else attn.gqa_decode_paged)(
                pa, ac, h, c, tb, positions, active))
    return _logits_head(params, cfg, x), caches


def verify_step_paged(params: dict, cfg: ModelConfig, tokens, caches,
                      tables, positions, active, nvalid):
    """Batched speculative verify: tokens (slots, S) = [last token, drafts,
    pads]; positions are per-lane START positions; nvalid (slots,) real
    tokens per lane.  Returns (logits (slots, S, vocab), caches):
    logits[b, i] scores the token after tokens[b, i]."""
    x = _embed_tokens(params, cfg, tokens)
    for kind, p, c in _layers(params, caches, cfg):
        tb = _group_table(cfg, kind, tables)
        x = _block(cfg, kind, p, x, lambda ac, pa, h, c=c, tb=tb: (
            attn.mla_verify_paged if ac.is_mla else attn.gqa_verify_paged)(
                pa, ac, h, c, tb, positions, active, nvalid))
    return _logits_head(params, cfg, x), caches
