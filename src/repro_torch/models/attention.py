"""GQA and MLA attention over paged KV pools (the serving slice of
`repro.models.attention`: GQA :300-512, MLA :515-623).

Pool layouts (shared across lanes): GQA k / v (num_blocks, block_size,
KVH, hd); MLA c_kv (num_blocks, block_size, kv_lora) and k_rope
(num_blocks, block_size, rope_dim) — the compressed latent, not full K/V,
is what pages through the pools.  A lane's logical block b (absolute
positions [b*bs, (b+1)*bs)) lives at physical block `tables[lane, b]`;
block 0 is the reserved null block.

Unlike the reference, whose functions return new arrays, the three pool
writers update the pools IN PLACE (`index_put_`) and return them, so one
set of device pools serves every step.  Reads go through
`kernels.ops.paged_attn` (the CUDA paged-attention kernel on the card; for
MLA its latent form, after absorbing w_uk into q).  All attention math
accumulates in f32.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.ops import dense, paged_attn, resolve_paged_attn_mode
from repro_torch.models.layers import Spec, rmsnorm, rope

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int | None = None          # sliding-window size (None = full)
    # MLA
    kv_lora_rank: int | None = None
    q_lora_rank: int | None = None
    rope_head_dim: int = 64
    dtype: torch.dtype = torch.bfloat16
    dense_mode: str = "auto"           # kernels.ops.dense routing
    paged_mode: str = "auto"           # kernels.ops.paged_attn routing

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank is not None


def attn_specs(c: AttnConfig) -> dict:
    """Parameter specs of one GQA or MLA layer."""
    if c.is_mla:
        nope, rr = c.head_dim, c.rope_head_dim
        sp = {
            "w_dkv": Spec((c.d_model, c.kv_lora_rank + rr), c.dtype),
            "w_uk": Spec((c.kv_lora_rank, c.num_heads, nope), c.dtype),
            "w_uv": Spec((c.kv_lora_rank, c.num_heads, nope), c.dtype),
            "w_o": Spec((c.num_heads, nope, c.d_model), c.dtype),
            "kv_norm": Spec((c.kv_lora_rank,), c.dtype),
        }
        if c.q_lora_rank:
            sp["w_dq"] = Spec((c.d_model, c.q_lora_rank), c.dtype)
            sp["w_uq"] = Spec((c.q_lora_rank, c.num_heads, nope + rr),
                              c.dtype)
            sp["q_norm"] = Spec((c.q_lora_rank,), c.dtype)
        else:
            sp["w_q"] = Spec((c.d_model, c.num_heads, nope + rr), c.dtype)
        return sp
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
    if c.is_mla:
        return {
            "c_kv": Spec((num_blocks, block_size, c.kv_lora_rank), c.dtype),
            "k_rope": Spec((num_blocks, block_size, c.rope_head_dim),
                           c.dtype),
        }
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


# ---------------------------------------------------------------------------
# core attention math (the plain read path of MLA)
# ---------------------------------------------------------------------------

def _sdpa(q, k, v, mask, scale):
    """q: (B,S,H,hd) k: (B,T,KVH,hd) v: (B,T,KVH,dv) mask: (B,S,T) or
    (S,T).  The reference's casts: q pre-scaled in f32 and cast to k's
    dtype, f32 logits, probs cast to v's dtype for PV, f32 accumulation.
    v's head dim may differ from q's (MLA: values are nope-only)."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    rep = H // KVH
    qr = (q.float() * scale).to(k.dtype).reshape(B, S, KVH, rep, hd)
    logits = torch.einsum("bsgrh,btgh->bgrst", qr.float(), k.float())
    m = mask[:, None, None] if mask.dim() == 3 else mask
    logits = logits.masked_fill(~m, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgh->bsgrh", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def causal_mask(S: int, T: int, q_offset=0, window: "int | None" = None):
    """(S, T) mask: query i (global position q_offset+i) sees keys j <= it,
    and within `window` if set.  q_offset: an int or a 0-d tensor (whose
    device the mask takes)."""
    device = q_offset.device if isinstance(q_offset, torch.Tensor) else None
    qpos = q_offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def _paged_gather(pool, tables):
    """(nb, bs, ...) x (B, MB) -> (B, MB*bs, ...): each lane's logical KV
    sequence, position-ordered."""
    g = pool[tables.long()]                            # (B, MB, bs, ...)
    return g.reshape(tables.shape[0], -1, *pool.shape[2:])


def paged_mask(positions, T: int, *, S: int = 1,
               window: "int | None" = None):
    """(B, S, T) decode/verify mask over a gathered pool: key slot j holds
    absolute position j; query row s of lane b sits at positions[b] + s."""
    dev = positions.device
    kpos = torch.arange(T, device=dev)[None, None, :]
    qpos = (positions.long()[:, None, None]
            + torch.arange(S, device=dev)[None, :, None])
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention) over paged latent pools
# ---------------------------------------------------------------------------

def _mla_q(p, c: AttnConfig, x, positions):
    nope = c.head_dim
    if c.q_lora_rank:
        cq = rmsnorm({"scale": p["q_norm"]},
                     dense(x, p["w_dq"], mode=c.dense_mode),
                     mode=c.dense_mode)
        q = dense(cq, p["w_uq"], mode=c.dense_mode)
    else:
        q = dense(x, p["w_q"], mode=c.dense_mode)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, c.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _mla_latent(p, c: AttnConfig, x, positions):
    d = dense(x, p["w_dkv"], mode=c.dense_mode)
    c_kv, k_rope = d[..., :c.kv_lora_rank], d[..., c.kv_lora_rank:]
    c_kv = rmsnorm({"scale": p["kv_norm"]}, c_kv, mode=c.dense_mode)
    k_rope = rope(k_rope[..., None, :], positions, c.rope_theta)[..., 0, :]
    return c_kv, k_rope


def _mla_attend(p, c: AttnConfig, q, c_kv, k_rope, mask):
    """The plain MLA read: up-project the latent sequence to per-head K/V,
    then `_sdpa` and the output projection."""
    nope = c.head_dim
    k_nope = dense(c_kv, p["w_uk"], mode=c.dense_mode)
    v = dense(c_kv, p["w_uv"], mode=c.dense_mode)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], c.rope_head_dim)], dim=-1)
    out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(nope + c.rope_head_dim))
    return dense(out[..., :nope], p["w_o"], mode=c.dense_mode,
                 contract_dims=2)


def _mla_absorbed_attend(p, c: AttnConfig, q, ckv, kr, tables, positions,
                         mode: str):
    """The weight-absorbed MLA read (the kernel's form): q_nope folded
    through w_uk so logits contract directly against the latent c_kv /
    k_rope blocks (MQA over the latent, `paged_attn(mla=True)`), then the
    latent output up-projected through w_uv.  The two einsums run outside
    the kernel, as the reference runs them outside Pallas."""
    nope = c.head_dim
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    # q_abs[h] . c_kv[t] == q_nope[h] . k_nope[t, h]
    q_abs = torch.einsum("bshn,rhn->bshr", q_nope, p["w_uk"]).to(q.dtype)
    q_eff = torch.cat([q_abs, q_rope], dim=-1)
    out_lat = paged_attn(q_eff, ckv, kr, tables, positions, num_kv_heads=1,
                         mla=True,
                         scale=1.0 / math.sqrt(nope + c.rope_head_dim),
                         mode=mode)
    out = torch.einsum("bshr,rhn->bshn", out_lat, p["w_uv"]).to(q.dtype)
    return dense(out, p["w_o"], mode=c.dense_mode, contract_dims=2)


def _mla_paged_attend(p, c: AttnConfig, q, ckv, kr, tables, positions,
                      *, prefill: bool):
    """Dispatch the paged MLA read.  "ref" gathers the latent pools and runs
    the unmodified `_mla_attend` (up-project k/v, then `_sdpa`); "kernel"
    runs the absorbed form on the CUDA MLA kernel — the same math
    reassociated, with only the compressed latent crossing HBM."""
    mode = resolve_paged_attn_mode(c.paged_mode, q)
    if mode == "ref":
        ckv_seq = _paged_gather(ckv, tables)
        kr_seq = _paged_gather(kr, tables)
        if prefill:
            mask = causal_mask(q.shape[1], ckv_seq.shape[1], positions[0])
        else:
            mask = paged_mask(positions, ckv_seq.shape[1], S=q.shape[1])
        return _mla_attend(p, c, q, ckv_seq, kr_seq, mask)
    return _mla_absorbed_attend(p, c, q, ckv, kr, tables, positions, mode)


def mla_prefill_paged(p, c: AttnConfig, x, cache, table_row, start_pos: int):
    """MLA prefill chunk (B=1): project, write the chunk's latent rows,
    attend over the lane's blocks.  start_pos: any token index."""
    S = x.shape[1]
    positions = start_pos + torch.arange(S, device=x.device)[None]
    q = _mla_q(p, c, x, positions)
    c_kv, k_rope = _mla_latent(p, c, x, positions)
    ckv = _paged_write_span(cache["c_kv"], table_row, start_pos, c_kv)
    kr = _paged_write_span(cache["k_rope"], table_row, start_pos, k_rope)
    pos = torch.full((1,), start_pos, dtype=torch.int32, device=x.device)
    out = _mla_paged_attend(p, c, q, ckv, kr, table_row, pos, prefill=True)
    return out, {"c_kv": ckv, "k_rope": kr}


def mla_decode_paged(p, c: AttnConfig, x, cache, tables, positions, active):
    """One-token MLA decode across lanes (see `gqa_decode_paged`)."""
    q = _mla_q(p, c, x, positions[:, None])
    c_kv, k_rope = _mla_latent(p, c, x, positions[:, None])
    ckv = _paged_write_token(cache["c_kv"], tables, positions, active,
                             c_kv[:, 0])
    kr = _paged_write_token(cache["k_rope"], tables, positions, active,
                            k_rope[:, 0])
    out = _mla_paged_attend(p, c, q, ckv, kr, tables, positions,
                            prefill=False)
    return out, {"c_kv": ckv, "k_rope": kr}


def mla_verify_paged(p, c: AttnConfig, x, cache, tables, positions, active,
                     nvalid):
    """Speculative verify over the latent pools (see `gqa_verify_paged`);
    positions[b] + s drives both rope and the paged mask."""
    S = x.shape[1]
    pos2 = positions[:, None] + torch.arange(S, device=x.device)[None, :]
    q = _mla_q(p, c, x, pos2)
    c_kv, k_rope = _mla_latent(p, c, x, pos2)
    ckv = _paged_write_multi(cache["c_kv"], tables, positions, active,
                             nvalid, c_kv)
    kr = _paged_write_multi(cache["k_rope"], tables, positions, active,
                            nvalid, k_rope)
    out = _mla_paged_attend(p, c, q, ckv, kr, tables, positions,
                            prefill=False)
    return out, {"c_kv": ckv, "k_rope": kr}
