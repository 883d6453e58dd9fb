"""GQA, MLA and cross attention: the reference's `repro.models.attention`
in torch.

Three cache forms:
  * paged pools (the serving slice, :300-623) — GQA k / v (num_blocks,
    block_size, KVH, hd); MLA c_kv (num_blocks, block_size, kv_lora) and
    k_rope (num_blocks, block_size, rope_dim): the compressed latent, not
    full K/V, pages through the pools.  A lane's logical block b (absolute
    positions [b*bs, (b+1)*bs)) lives at physical block `tables[lane, b]`;
    block 0 is the reserved null block.  The three pool writers update the
    pools IN PLACE (`index_put_`) and return them, so one set of device
    pools serves every step.  Reads go through `kernels.ops.paged_attn`
    (the CUDA paged-attention kernel on the card; for MLA its latent form,
    after absorbing w_uk into q).
  * dense per-lane caches (the dense-cache engine's, :101-117, :322-380,
    :644-670) — GQA k / v (B, span, KVH, hd), span = max_len, or on a
    window layer min(max_len, window) used as a ring (slot pos % span); MLA
    c_kv / k_rope (B, max_len, ...).  Prefill returns new caches; a decode
    writes position `pos` of every row into the cache it was given, in
    place, as the reference's decode step does under `donate_argnums`
    (`transformer.decode_step` copies first for a caller that keeps the
    old cache: the dense-cache engine keeps only its group's rows).
  * none — full-sequence `gqa_forward` / `mla_forward`, and cross
    attention over encoder embeddings (:672-685), whose K/V are recomputed
    from `enc` every call.
The attention itself is plain torch, as the reference's is jnp outside any
Pallas kernel.  All attention math accumulates in f32.

Under a mesh whose model axis is larger than one rank (`dist.collectives`),
`gqa_forward`, `gqa_prefill` and `gqa_decode` take a tensor-parallel form
chosen from the layer's specs (`_tp_form`):
  heads   the q heads divide the model axis (w_o's spec splits its heads):
          a copy at the entry, the rank's q heads (w_q gathered from its
          head_dim split and cut to its heads), k / v for every kv head on
          every rank, of which the rank attends the ones its q heads read,
          w_o row-parallel, then a reduce
  cp      otherwise, when S divides the axis and S > 1 (the reference's
          `_attend` context-parallel branch): the projections run whole on
          every model rank, rank r attends its S/tp query rows at q_offset
          r*S/tp against the whole k / v (`_sdpa_kv_chunked`), projects
          them through w_o, and the rows are gathered back
  whole   otherwise (a decode step of heads that do not divide): every
          model rank computes the layer whole
MLA (`_mla_tp`) and cross attention take a heads form when their heads
divide the model axis, else the whole form.  Dense caches keep every kv
head (and MLA's latent) on every model rank, as `cache_pspecs` places
them.  A decode whose cache is split on its sequence dim over the dp
axis (`cache_pspecs`' long-context case, B < dp) attends over the rank's
positions, returns (max, sum, acc) and merges the ranks' parts with a
log-sum-exp all-reduce over its axes (one, or ("pod", "data")); the
write at `pos` lands on the rank that holds that slot.  MLA's latent cache
takes the same merge.  The reference gets this from GSPMD; here it is written out.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.dist.collectives import (all_reduce, copy_to, current,
                                          gather_from, reduce_from,
                                          spec_dim, take, tp_par)
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


def cross_attn_specs(c: AttnConfig) -> dict:
    """Cross attention: queries from the text, K/V from encoder embeddings,
    per-head RMSNorm on q and k."""
    return {
        "w_q": Spec((c.d_model, c.num_heads, c.head_dim), c.dtype),
        "w_k": Spec((c.d_model, c.num_kv_heads, c.head_dim), c.dtype),
        "w_v": Spec((c.d_model, c.num_kv_heads, c.head_dim), c.dtype),
        "w_o": Spec((c.num_heads, c.head_dim, c.d_model), c.dtype),
        "q_norm": Spec((c.head_dim,), c.dtype),
        "k_norm": Spec((c.head_dim,), c.dtype),
    }


def cache_specs(c: AttnConfig, batch: int, max_len: int) -> dict:
    """Dense per-lane cache specs of one layer; a window layer keeps a
    ring of min(max_len, window) positions."""
    if c.is_mla:
        return {
            "c_kv": Spec((batch, max_len, c.kv_lora_rank), c.dtype),
            "k_rope": Spec((batch, max_len, c.rope_head_dim), c.dtype),
        }
    span = min(max_len, c.window) if c.window else max_len
    shape = (batch, span, c.num_kv_heads, c.head_dim)
    return {"k": Spec(shape, c.dtype), "v": Spec(shape, c.dtype)}


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


def causal_mask(S: int, T: int, q_offset=0, window: "int | None" = None,
                device=None):
    """(S, T) mask: query i (global position q_offset+i) sees keys j <= it,
    and within `window` if set.  q_offset: an int or a 0-d tensor (whose
    device the mask takes; else `device`)."""
    if isinstance(q_offset, torch.Tensor):
        device = q_offset.device
    qpos = q_offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


ATTN_Q_CHUNK = 512  # query rows a block of full-sequence attention


def _sdpa_chunked(q, k, v, scale, *, window=None, chunk=ATTN_Q_CHUNK):
    """Causal attention over the whole sequence, query rows in blocks of
    `chunk` (the reference's `_sdpa_chunked`: one (chunk x T) block of
    logits at a time; a sequence of at most `chunk` rows, or not a whole
    number of chunks, runs as one block)."""
    S, T = q.shape[1], k.shape[1]
    if S <= chunk or S % chunk:
        return _sdpa(q, k, v, causal_mask(S, T, 0, window, q.device), scale)
    return torch.cat([
        _sdpa(q[:, i:i + chunk], k, v,
              causal_mask(chunk, T, i, window, q.device), scale)
        for i in range(0, S, chunk)], dim=1)


ATTN_KV_CHUNK = 1024  # key-block size for context-parallel attention


def _sdpa_parts(q, k, v, mask, scale):
    """Unnormalized attention of q against a block of keys: (m, l, acc)
    with m the rows' max logit (-inf where every key is masked), l the sum
    of exp(logit - m) and acc the f32 sum of exp(logit - m) v.  q: (B, S,
    H, hd); mask (S, T) or (B, S, T).  m, l: (B, KVH, rep, S); acc: (B, S,
    KVH, rep, dv).  The casts are `_sdpa`'s."""
    B, S, H, hd = q.shape
    KVH = k.shape[2]
    rep = H // KVH
    qr = (q.float() * scale).to(k.dtype).reshape(B, S, KVH, rep, hd)
    logits = torch.einsum("bsgrh,btgh->bgrst", qr.float(), k.float())
    msk = mask[:, None, None] if mask.dim() == 3 else mask
    logits = logits.masked_fill(~msk, float("-inf"))
    m = torch.amax(logits, dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros((), device=m.device))
    p = torch.exp(logits - m_safe[..., None])
    acc = torch.einsum("bgrst,btgh->bsgrh", p.to(v.dtype).float(), v.float())
    return m, torch.sum(p, dim=-1), acc


def _sdpa_kv_chunked(q, k, v, scale, *, window=None, chunk=ATTN_KV_CHUNK,
                     q_offset=0):
    """Online-softmax attention over blocks of `chunk` keys (the
    reference's `_sdpa_kv_chunked`).  q's rows may be a sequence shard
    (context parallelism): `q_offset` is their global position for the
    causal and window masks; a row whose keys are all masked so far keeps
    m = -inf.  Peak memory is one (S x chunk) block of logits.  A T that is
    not a whole number of blocks, or at most one, runs `_sdpa`."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    KVH = k.shape[2]
    rep = H // KVH
    vd = v.shape[-1]
    if T % chunk or T <= chunk:
        return _sdpa(q, k, v, causal_mask(S, T, q_offset, window, q.device),
                     scale)
    dev = q.device
    m = torch.full((B, KVH, rep, S), float("-inf"), device=dev)
    l = torch.zeros((B, KVH, rep, S), device=dev)
    acc = torch.zeros((B, S, KVH, rep, vd), device=dev)
    zero = torch.zeros((), device=dev)
    for j in range(T // chunk):
        kc = k[:, j * chunk:(j + 1) * chunk]
        vc = v[:, j * chunk:(j + 1) * chunk]
        # query i is global position q_offset+i; keys are at j*chunk + t
        mask = causal_mask(S, chunk, q_offset - j * chunk, window, dev)
        mj, lj, aj = _sdpa_parts(q, kc, vc, mask, scale)
        m_new = torch.maximum(m, mj)
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
        cj = torch.where(torch.isfinite(mj), torch.exp(mj - m_safe), zero)
        l = l * corr + lj * cj
        acc = (acc * corr.permute(0, 3, 1, 2)[..., None]
               + aj * cj.permute(0, 3, 1, 2)[..., None])
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(B, S, H, vd).to(q.dtype)


# ---------------------------------------------------------------------------
# the tensor-parallel forms (module docstring)
# ---------------------------------------------------------------------------

def _tp_form(spec, S: int, par) -> str:
    if spec_dim(spec["w_o"]) == 0:
        return "heads"
    if S > 1 and S % par.tp == 0:
        return "cp"
    return "whole"


def _kv_heads(k, r: int, Hl: int, rep: int):
    """The kv heads that q heads r*Hl .. (r+1)*Hl-1 read, in an order that
    keeps each q head on its own kv head: a run of kv heads when the q
    heads cover whole groups, the one kv head when they sit inside one
    group, else one kv head a q head."""
    if Hl % rep == 0:
        return k.narrow(2, r * Hl // rep, Hl // rep)
    if rep % Hl == 0:
        return k.narrow(2, r * Hl // rep, 1)
    idx = torch.arange(r * Hl, (r + 1) * Hl, device=k.device) // rep
    return k.index_select(2, idx)


def _tp_qkv(p, c: AttnConfig, x, positions, spec, par, form: str):
    """(q, k, v) of the form: q the rank's heads in the heads form, else
    every head; k / v every kv head.  In the heads and cp forms x enters
    through a copy (each rank's work is a part)."""
    partial = form != "whole"
    xin = copy_to(x, par) if partial else x
    qwant = (None, "model", None) if form == "heads" else None
    w = {"w_q": take(p["w_q"], spec["w_q"], qwant, par, partial=partial)}
    if "b_q" in p:
        w["b_q"] = take(p["b_q"], spec["b_q"],
                        qwant[1:] if qwant else None, par, partial=partial)
    for n in ("w_k", "w_v", "b_k", "b_v"):
        if n in p:
            w[n] = take(p[n], spec[n], None, par, partial=partial)
    q, k, v = gqa_project_qkv(w, c, xin, positions)
    return q, k, v


def _tp_out(p, c: AttnConfig, out, spec, par, form: str):
    """The output projection of the form: row-parallel then a reduce
    (heads), or whole."""
    if form == "heads":
        wo = take(p["w_o"], spec["w_o"], ("model", None, None), par)
        return reduce_from(dense(out, wo, mode=c.dense_mode, contract_dims=2),
                           par)
    wo = take(p["w_o"], spec["w_o"], None, par, partial=form != "whole")
    return dense(out, wo, mode=c.dense_mode, contract_dims=2)


def _tp_attention(p, c: AttnConfig, x, positions, spec, par):
    """Full-sequence attention under the model axis: (out projected, k, v
    with every kv head)."""
    S = x.shape[1]
    form = _tp_form(spec, S, par)
    q, k, v = _tp_qkv(p, c, x, positions, spec, par, form)
    scale = 1.0 / math.sqrt(c.head_dim)
    r = par.rank("model")
    if form == "heads":
        Hl = q.shape[2]
        rep = c.num_heads // c.num_kv_heads
        out = _sdpa_chunked(q, _kv_heads(k, r, Hl, rep),
                            _kv_heads(v, r, Hl, rep), scale, window=c.window)
        return _tp_out(p, c, out, spec, par, form), k, v
    if form == "cp":
        Sl = S // par.tp
        out = _sdpa_kv_chunked(q.narrow(1, r * Sl, Sl), k, v, scale,
                               window=c.window, q_offset=r * Sl)
        y = _tp_out(p, c, out, spec, par, form)
        return gather_from(y, 1, par), k, v
    out = _sdpa_chunked(q, k, v, scale, window=c.window)
    return _tp_out(p, c, out, spec, par, form), k, v


def gqa_forward(p, c: AttnConfig, x, positions, spec=None):
    """Full-sequence GQA self-attention (causal, optional window): the
    projections through `kernels.ops.dense`, the attention in plain torch
    (as the reference computes it in jnp, outside any Pallas kernel).
    Under the model axis, the form of the module docstring."""
    par = tp_par()
    if par is not None and spec is not None:
        return _tp_attention(p, c, x, positions, spec, par)[0]
    q, k, v = gqa_project_qkv(p, c, x, positions)
    out = _sdpa_chunked(q, k, v, 1.0 / math.sqrt(c.head_dim),
                        window=c.window)
    return dense(out, p["w_o"], mode=c.dense_mode, contract_dims=2)


def _write_at(cache, slot: int, vals):
    """vals (B, 1, ...) written into `cache` (B, T, ...) at `slot`, in
    place, the start clamped into range as `lax.dynamic_update_slice`
    clamps it.  Returns `cache`."""
    slot = min(max(slot, 0), cache.shape[1] - 1)
    cache[:, slot] = vals[:, 0]
    return cache


def gqa_prefill(p, c: AttnConfig, x, positions, max_len: int, spec=None):
    """Prefill over a dense cache: returns (out, {"k", "v"}) with the
    cache laid out for `gqa_decode` (a window layer's last span positions
    at their ring slots pos % span).  The cache holds every kv head, under
    the model axis too."""
    B, S, _ = x.shape
    par = tp_par()
    if par is not None and spec is not None:
        y, k, v = _tp_attention(p, c, x, positions, spec, par)
    else:
        q, k, v = gqa_project_qkv(p, c, x, positions)
        out = _sdpa_chunked(q, k, v, 1.0 / math.sqrt(c.head_dim),
                            window=c.window)
        y = dense(out, p["w_o"], mode=c.dense_mode, contract_dims=2)
    span = min(max_len, c.window) if c.window else max_len
    kc = torch.zeros((B, span, c.num_kv_heads, c.head_dim), dtype=k.dtype,
                     device=k.device)
    vc = torch.zeros_like(kc)
    if c.window and S > span:
        rows = torch.arange(B, device=k.device)[:, None]
        slots = positions[:, -span:].long() % span
        kc[rows, slots] = k[:, -span:]
        vc[rows, slots] = v[:, -span:]
    else:
        n = min(S, span)
        kc[:, :n] = k[:, :n]
        vc[:, :n] = v[:, :n]
    return y, {"k": kc, "v": vc}


def _seq_axis(cache_spec):
    """The axes a dense cache's sequence dim is split over, as a spec entry
    (None: whole)."""
    if cache_spec is None:
        return None
    return next(iter(cache_spec.values()))[1]


def _seq_parts(cache_spec, n_loc: int):
    """(the ambient mesh or None, the cache's sequence entry, this rank's
    block index along it, the whole length) of a dense cache holding
    `n_loc` positions here."""
    axis = _seq_axis(cache_spec)
    seq = current() if axis is not None else None
    if seq is None:
        return None, None, 0, n_loc
    return seq, axis, seq.rank(axis), n_loc * seq.size(axis)


def gqa_decode(p, c: AttnConfig, x, cache, pos: int, spec=None,
               cache_spec=None):
    """One-token decode over a dense cache at the one position `pos` of
    every row.  x: (B, 1, D).  A window layer's entry j holds the absolute
    position p' = pos - ((pos - j) % span), visible while p' >= 0 and
    within the window.  Under a mesh: the model axis's form (module
    docstring), and a cache split on its sequence dim (`cache_spec`)
    attended in parts merged across its axis.  Returns (y, the cache's
    leaves), the new K / V written into them in place (`_write_local`)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    par = tp_par()
    form = None
    if par is not None and spec is not None:
        form = _tp_form(spec, 1, par)
        q, k, v = _tp_qkv(p, c, x, positions, spec, par, form)
    else:
        q, k, v = gqa_project_qkv(p, c, x, positions)
    n_loc = cache["k"].shape[1]
    seq, axis, r, span = _seq_parts(cache_spec, n_loc)
    slot = min(max(pos % span if c.window else pos, 0), span - 1)
    kc, vc = (_write_local(cache[n], slot, r, t)
              for n, t in (("k", k), ("v", v)))
    kpos = r * n_loc + torch.arange(n_loc, device=x.device)
    if c.window:
        kpos = pos - ((pos - kpos) % span)
        valid = (kpos >= 0) & (kpos >= pos - (c.window - 1))
    else:
        valid = kpos <= pos
    mask = valid[None, None, :].expand(B, 1, n_loc)
    ka, va = kc, vc
    if form == "heads":
        Hl = q.shape[2]
        rep = c.num_heads // c.num_kv_heads
        rk = par.rank("model")
        ka, va = _kv_heads(kc, rk, Hl, rep), _kv_heads(vc, rk, Hl, rep)
    scale = 1.0 / math.sqrt(c.head_dim)
    if seq is None:
        out = _sdpa(q, ka, va, mask, scale)
    else:
        out = _merge_parts(*_sdpa_parts(q, ka, va, mask, scale), seq, axis,
                           q.shape, q.dtype)
    if form is not None:
        y = _tp_out(p, c, out, spec, par, form)
    else:
        y = dense(out, p["w_o"], mode=c.dense_mode, contract_dims=2)
    return y, {"k": kc, "v": vc}


def _write_local(cache, slot: int, r: int, vals):
    """`_write_at` of the whole cache's `slot` on the rank whose block
    (`r`, of cache.shape[1] positions) holds it; no write elsewhere.
    Returns `cache`."""
    n_loc = cache.shape[1]
    if slot // n_loc == r:
        return _write_at(cache, slot - r * n_loc, vals)
    return cache


def _merge_parts(m, l, acc, par, axis, qshape, dtype):
    """Attention over every rank's keys from the ranks' (m, l, acc): the
    log-sum-exp merge, all-reduced over `axis` (a spec entry)."""
    zero = torch.zeros((), device=m.device)
    m_g = all_reduce(m, par, axis, op="max")
    m_safe = torch.where(torch.isfinite(m_g), m_g, zero)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
    l_g = all_reduce(l * corr, par, axis)
    acc_g = all_reduce(acc * corr.permute(0, 3, 1, 2)[..., None], par,
                       axis)
    out = acc_g / torch.clamp(l_g, min=1e-30).permute(0, 3, 1, 2)[..., None]
    B, S, H, _ = qshape
    return out.reshape(B, S, H, acc.shape[-1]).to(dtype)


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


def _mla_kv(p, c: AttnConfig, c_kv, k_rope):
    """The latent sequence up-projected to per-head K (nope + shared rope)
    and V (nope)."""
    k_nope = dense(c_kv, p["w_uk"], mode=c.dense_mode)
    v = dense(c_kv, p["w_uv"], mode=c.dense_mode)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], c.rope_head_dim)], dim=-1)
    return k, v


def _mla_attend(p, c: AttnConfig, q, c_kv, k_rope, mask):
    """The plain MLA read: up-project the latent sequence to per-head K/V,
    then `_sdpa` and the output projection."""
    nope = c.head_dim
    k, v = _mla_kv(p, c, c_kv, k_rope)
    out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(nope + c.rope_head_dim))
    return dense(out[..., :nope], p["w_o"], mode=c.dense_mode,
                 contract_dims=2)


def _same(x):
    return x


def _mla_tp(p, c: AttnConfig, spec):
    """(the rank's MLA leaves, their config, the entry, the exit) on the
    ambient mesh: the heads form when the heads divide the model axis —
    w_q / w_uq / w_uk / w_uv (stored split on their last dim) taken to the
    rank's heads, w_dq / w_dkv and the norms whole, the latent computed for
    every row on every model rank (the dense latent cache keeps it whole
    there), w_o row-parallel, a copy at the entry and a reduce at the exit
    — else the whole form (every model rank computes the layer whole).  No
    mesh: (p, c, identity, identity)."""
    par = tp_par()
    if par is None or spec is None:
        return p, c, _same, _same
    if c.num_heads % par.tp:
        return ({n: take(w, spec[n], None, par, partial=False)
                 for n, w in p.items()}, c, _same, _same)
    heads = (None, "model", None)
    want = {"w_q": heads, "w_uq": heads, "w_uk": heads, "w_uv": heads,
            "w_o": ("model", None, None)}
    w = {n: take(t, spec[n], want.get(n), par) for n, t in p.items()}
    return (w, dataclasses.replace(c, num_heads=c.num_heads // par.tp),
            lambda x: copy_to(x, par), lambda y: reduce_from(y, par))


def _mla_full(p, c: AttnConfig, x, positions):
    """Full-sequence MLA: (out, c_kv, k_rope)."""
    q = _mla_q(p, c, x, positions)
    c_kv, k_rope = _mla_latent(p, c, x, positions)
    k, v = _mla_kv(p, c, c_kv, k_rope)
    out = _sdpa_chunked(q, k, v,
                        1.0 / math.sqrt(c.head_dim + c.rope_head_dim))
    return (dense(out, p["w_o"], mode=c.dense_mode, contract_dims=2), c_kv,
            k_rope)


def mla_forward(p, c: AttnConfig, x, positions, spec=None):
    """Full-sequence MLA self-attention: the latent up-projected to
    per-head K/V, then `_sdpa_chunked` (causal).  Under the model axis,
    `_mla_tp`'s form."""
    w, cl, enter, leave = _mla_tp(p, c, spec)
    return leave(_mla_full(w, cl, enter(x), positions)[0])


def mla_prefill(p, c: AttnConfig, x, positions, max_len: int, spec=None):
    """MLA prefill over a dense latent cache (B, max_len, ...)."""
    B = x.shape[0]
    w, cl, enter, leave = _mla_tp(p, c, spec)
    out, c_kv, k_rope = _mla_full(w, cl, enter(x), positions)
    ckv = torch.zeros((B, max_len, c.kv_lora_rank), dtype=c_kv.dtype,
                      device=x.device)
    kr = torch.zeros((B, max_len, c.rope_head_dim), dtype=k_rope.dtype,
                     device=x.device)
    n = min(c_kv.shape[1], max_len)
    ckv[:, :n] = c_kv[:, :n]
    kr[:, :n] = k_rope[:, :n]
    return leave(out), {"c_kv": ckv, "k_rope": kr}


def mla_decode(p, c: AttnConfig, x, cache, pos: int, spec=None,
               cache_spec=None):
    """One-token MLA decode over a dense latent cache at position `pos`
    of every row: the plain read (`_mla_attend`).  Under a mesh:
    `_mla_tp`'s form, and a latent cache split on its sequence dim
    (`cache_spec`) attended in parts merged across its axes, as
    `gqa_decode` does; the latent written into the cache in place."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    w, cl, enter, leave = _mla_tp(p, c, spec)
    xin = enter(x)
    q = _mla_q(w, cl, xin, positions)
    c_kv, k_rope = _mla_latent(w, cl, xin, positions)
    n_loc = cache["c_kv"].shape[1]
    seq, axis, r, T = _seq_parts(cache_spec, n_loc)
    slot = min(max(pos, 0), T - 1)
    ckv = _write_local(cache["c_kv"], slot, r, c_kv)
    kr = _write_local(cache["k_rope"], slot, r, k_rope)
    kpos = r * n_loc + torch.arange(n_loc, device=x.device)
    mask = (kpos <= pos)[None, None, :].expand(B, 1, n_loc)
    if seq is None:
        y = _mla_attend(w, cl, q, ckv, kr, mask)
    else:
        k, v = _mla_kv(w, cl, ckv, kr)
        out = _merge_parts(*_sdpa_parts(
            q, k, v, mask, 1.0 / math.sqrt(c.head_dim + c.rope_head_dim)),
            seq, axis, q.shape, q.dtype)
        y = dense(out, w["w_o"], mode=c.dense_mode, contract_dims=2)
    return leave(y), {"c_kv": ckv, "k_rope": kr}


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


# ---------------------------------------------------------------------------
# cross attention (text queries over encoder embeddings)
# ---------------------------------------------------------------------------

def cross_attn_forward(p, c: AttnConfig, x, enc, spec=None):
    """x: (B, S, D) text; enc: (B, T, D) patch / frame embeddings.  q and k
    get a per-head RMSNorm (rows of head_dim, through the RMSNorm kernel on
    the card); no mask, and nothing is cached: K/V are projected from
    `enc` every call, as the reference does.  Under the model axis: the
    heads form when the q heads divide it (a copy of x and enc at the
    entry, the rank's q heads, k / v for every kv head as `_tp_qkv`
    computes them, the norms replicated, w_o row-parallel, then a reduce),
    else the whole form."""
    par = tp_par()
    form = None
    if par is not None and spec is not None:
        form = "heads" if c.num_heads % par.tp == 0 else "whole"
        partial = form == "heads"
        qwant = (None, "model", None) if partial else None
        w = {n: take(t, spec[n], qwant if n == "w_q" else None, par,
                     partial=partial)
             for n, t in p.items() if n != "w_o"}
        if partial:
            x, enc = copy_to(x, par), copy_to(enc, par)
    else:
        w = p
    q = dense(x, w["w_q"], mode=c.dense_mode)
    k = dense(enc, w["w_k"], mode=c.dense_mode)
    v = dense(enc, w["w_v"], mode=c.dense_mode)
    q = rmsnorm({"scale": w["q_norm"]}, q, mode=c.dense_mode)
    k = rmsnorm({"scale": w["k_norm"]}, k, mode=c.dense_mode)
    if form == "heads":
        Hl, rk = q.shape[2], par.rank("model")
        rep = c.num_heads // c.num_kv_heads
        k, v = _kv_heads(k, rk, Hl, rep), _kv_heads(v, rk, Hl, rep)
    mask = torch.ones((x.shape[1], enc.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _sdpa(q, k, v, mask, 1.0 / math.sqrt(c.head_dim))
    if form is not None:
        return _tp_out(p, c, out, spec, par, form)
    return dense(out, p["w_o"], mode=c.dense_mode, contract_dims=2)
