"""GQA attention over paged KV pools (the serving slice of
`repro.models.attention`, :300-512).

Pool layout (shared across lanes): k / v (num_blocks, block_size, KVH, hd).
A lane's logical block b (absolute positions [b*bs, (b+1)*bs)) lives at
physical block `tables[lane, b]`; block 0 is the reserved null block.

Unlike the reference, whose functions return new arrays, the three pool
writers update the pools IN PLACE (`index_put_`) and return them, so one
set of device pools serves every step.  Reads go through
`kernels.ops.paged_attn` (the CUDA paged-attention kernel on the card).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.ops import dense, paged_attn
from repro_torch.models.layers import Spec, rope


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int | None = None          # sliding-window size (None = full)
    dtype: torch.dtype = torch.bfloat16
    dense_mode: str = "auto"           # kernels.ops.dense routing
    paged_mode: str = "auto"           # kernels.ops.paged_attn routing


def attn_specs(c: AttnConfig) -> dict:
    """Parameter specs of one GQA layer."""
    sp = {
        "w_q": Spec((c.d_model, c.num_heads, c.head_dim), c.dtype),
        "w_k": Spec((c.d_model, c.num_kv_heads, c.head_dim), c.dtype),
        "w_v": Spec((c.d_model, c.num_kv_heads, c.head_dim), c.dtype),
        "w_o": Spec((c.num_heads, c.head_dim, c.d_model), c.dtype),
    }
    if c.qkv_bias:
        sp["b_q"] = Spec((c.num_heads, c.head_dim), c.dtype)
        sp["b_k"] = Spec((c.num_kv_heads, c.head_dim), c.dtype)
        sp["b_v"] = Spec((c.num_kv_heads, c.head_dim), c.dtype)
    return sp


def paged_cache_specs(c: AttnConfig, num_blocks: int,
                      block_size: int) -> dict:
    """Pool specs of one layer (shared across lanes)."""
    shape = (num_blocks, block_size, c.num_kv_heads, c.head_dim)
    return {"k": Spec(shape, c.dtype), "v": Spec(shape, c.dtype)}


def gqa_project_qkv(p, c: AttnConfig, x, positions):
    """q/k/v projections through `dense` (bias fused into the kernel's
    epilogue), then rope on q and k."""
    q = dense(x, p["w_q"], bias=p.get("b_q"), mode=c.dense_mode)
    k = dense(x, p["w_k"], bias=p.get("b_k"), mode=c.dense_mode)
    v = dense(x, p["w_v"], bias=p.get("b_v"), mode=c.dense_mode)
    return rope(q, positions, c.rope_theta), rope(k, positions, c.rope_theta), v


def _paged_write_span(pool, table_row, start_pos: int, vals):
    """Write vals (1, S, ...) at absolute positions [start_pos, start_pos+S)
    of the lane with table row (1, MB), one (block, offset) per token, so
    start_pos may be any token index.  In place."""
    bs = pool.shape[1]
    S = vals.shape[1]
    pos = start_pos + torch.arange(S, device=pool.device)
    blk = table_row[0].long()[pos // bs]
    pool.index_put_((blk, pos % bs), vals[0])
    return pool


def _paged_write_token(pool, tables, positions, active, vals):
    """One token per lane: vals (B, ...) at each lane's position; inactive
    lanes are parked on null block 0.  In place."""
    bs = pool.shape[1]
    pos = positions.long()
    blk = torch.gather(tables.long(), 1, (pos // bs)[:, None])[:, 0]
    blk = torch.where(active, blk, 0)
    off = torch.where(active, pos % bs, 0)
    pool.index_put_((blk, off), vals)
    return pool


def _paged_write_multi(pool, tables, positions, active, nvalid, vals):
    """S tokens per lane (speculative verify): vals (B, S, ...) land at
    positions[b] + s for s < nvalid[b]; rows past a lane's real tokens and
    inactive lanes are parked on null block 0.  In place."""
    bs = pool.shape[1]
    S = vals.shape[1]
    steps = torch.arange(S, device=pool.device)
    pos = positions.long()[:, None] + steps[None, :]
    valid = active[:, None] & (steps[None, :] < nvalid.long()[:, None])
    blk = torch.gather(tables.long(), 1, torch.where(valid, pos // bs, 0))
    blk = torch.where(valid, blk, 0)
    off = torch.where(valid, pos % bs, 0)
    pool.index_put_((blk, off), vals)
    return pool


def _gqa_paged_attend(c: AttnConfig, q, kc, vc, tables, positions):
    return paged_attn(q, kc, vc, tables, positions,
                      num_kv_heads=c.num_kv_heads,
                      scale=1.0 / math.sqrt(c.head_dim),
                      window=c.window, mode=c.paged_mode)


def gqa_prefill_paged(p, c: AttnConfig, x, cache, table_row, start_pos: int):
    """One prefill chunk (B=1): project, write the chunk's KV, attend over
    the lane's blocks.  x: (1, S, D); start_pos: any token index."""
    S = x.shape[1]
    positions = start_pos + torch.arange(S, device=x.device)[None]
    q, k, v = gqa_project_qkv(p, c, x, positions)
    kc = _paged_write_span(cache["k"], table_row, start_pos, k)
    vc = _paged_write_span(cache["v"], table_row, start_pos, v)
    pos = torch.full((1,), start_pos, dtype=torch.int32, device=x.device)
    out = _gqa_paged_attend(c, q, kc, vc, table_row, pos)
    return (dense(out, p["w_o"], mode=c.dense_mode, contract_dims=2),
            {"k": kc, "v": vc})


def gqa_decode_paged(p, c: AttnConfig, x, cache, tables, positions, active):
    """One-token decode across lanes at heterogeneous positions.
    x: (B, 1, D); tables: (B, MB); positions: (B,); active: (B,) bool."""
    q, k, v = gqa_project_qkv(p, c, x, positions[:, None])
    kc = _paged_write_token(cache["k"], tables, positions, active, k[:, 0])
    vc = _paged_write_token(cache["v"], tables, positions, active, v[:, 0])
    out = _gqa_paged_attend(c, q, kc, vc, tables, positions)
    return (dense(out, p["w_o"], mode=c.dense_mode, contract_dims=2),
            {"k": kc, "v": vc})


def gqa_verify_paged(p, c: AttnConfig, x, cache, tables, positions, active,
                     nvalid):
    """Speculative verify: S = draft_len+1 tokens per lane in one pass.
    x: (B, S, D); positions: (B,) per-lane START positions; nvalid: (B,)
    real tokens per lane (rows past it write null block 0)."""
    S = x.shape[1]
    pos2 = positions[:, None] + torch.arange(S, device=x.device)[None, :]
    q, k, v = gqa_project_qkv(p, c, x, pos2)
    kc = _paged_write_multi(cache["k"], tables, positions, active, nvalid, k)
    vc = _paged_write_multi(cache["v"], tables, positions, active, nvalid, v)
    out = _gqa_paged_attend(c, q, kc, vc, tables, positions)
    return (dense(out, p["w_o"], mode=c.dense_mode, contract_dims=2),
            {"k": kc, "v": vc})
