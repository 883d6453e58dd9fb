"""Mixture-of-Experts layer with sort-based token dispatch (the local path of
`repro.models.moe`).

Tokens split into dispatch groups; in each group the router (f32, through
`kernels.ops.dense`) picks the top-k experts of every token, a stable sort
by expert gives each routed (token, choice) a slot in its expert's
capacity-C buffer, and overflow is dropped (combine weight 0).  The groups
fold into the per-expert row dim, (E, G*C, D), so each expert's weights
stream once for all groups through `kernels.ops.dense_grouped` (the CUDA
`gpp_matmul_grouped` on the card).  Every expert runs, rows or none, as in
the reference.  Shared experts are a plain MLP beside the routed ones.

Capacity: C = max(8, ceil(Tg * top_k / E * capacity_factor)) per group.

The reference's mesh paths (`_moe_shard_map*`, expert parallelism across
chips) are not part of this port yet.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.ops import dense, dense_grouped
from repro_torch.models.layers import Spec


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    d_model: int
    d_ff: int                      # per-expert hidden
    num_experts: int
    experts_per_token: int
    num_shared_experts: int = 0
    shared_d_ff: int | None = None  # defaults to d_ff * num_shared
    capacity_factor: float = 1.25
    act: str = "swiglu"
    router_dtype: torch.dtype = torch.float32
    dtype: torch.dtype = torch.bfloat16
    dispatch_groups: int = 16      # token groups
    dense_kernel: str = "auto"     # kernels.ops.dense/dense_grouped routing


def moe_specs(c: MoeConfig) -> dict:
    sp = {
        "router": Spec((c.d_model, c.num_experts), c.dtype),
        "w_gate": Spec((c.num_experts, c.d_model, c.d_ff), c.dtype),
        "w_up": Spec((c.num_experts, c.d_model, c.d_ff), c.dtype),
        "w_down": Spec((c.num_experts, c.d_ff, c.d_model), c.dtype),
    }
    if c.num_shared_experts:
        f = c.shared_d_ff or c.d_ff * c.num_shared_experts
        sp["shared"] = {
            "w_gate": Spec((c.d_model, f), c.dtype),
            "w_up": Spec((c.d_model, f), c.dtype),
            "w_down": Spec((f, c.d_model), c.dtype),
        }
    return sp


def capacity(c: MoeConfig, num_tokens: int) -> int:
    cap = math.ceil(num_tokens * c.experts_per_token / c.num_experts
                    * c.capacity_factor)
    return max(8, int(cap))


def _dispatch_groups(c: MoeConfig, T: int) -> int:
    g = c.dispatch_groups
    while g > 1 and T % g:
        g //= 2
    return max(1, g)


def _dispatch(p, c: MoeConfig, xt: torch.Tensor, C: int):
    """Route + scatter G token groups at once.  xt: (G, Tg, D).  Returns
    the (G, E, C, D) buffer and the combine metadata (sorted_e, slot, keep,
    token_idx, w), each (G, Tg*k), in sorted-entry order."""
    G, Tg, D = xt.shape
    k, E = c.experts_per_token, c.num_experts
    # the reference's `p["router"].astype(router_dtype)` is folded into the
    # kernel's load at an f32 router: W goes in its stored dtype and is
    # widened to f32 in registers (the plain version: w.float()), which is
    # exact, so the logits keep their bits and no f32 copy is made a call
    w = p["router"]
    if c.router_dtype != torch.float32:
        w = w.to(c.router_dtype)
    logits = dense(xt.to(c.router_dtype), w, mode=c.dense_kernel)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, k, dim=-1)                # (G, Tg, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    flat_e = top_e.reshape(G, -1)                              # (G, Tg*k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(E, device=xt.device).expand(G, E).contiguous()
    grp_start = torch.searchsorted(sorted_e, experts, side="left")
    slot = (torch.arange(Tg * k, device=xt.device)[None]
            - torch.gather(grp_start, 1, sorted_e))
    keep = slot < C
    token_idx = order // k

    # each kept (expert, slot) is written once; dropped entries go to a
    # spare slot C that is cut off (the reference adds them as zeros)
    buf = torch.zeros((G, E, C + 1, D), dtype=xt.dtype, device=xt.device)
    g_idx = torch.arange(G, device=xt.device)[:, None]
    rows = torch.gather(xt, 1, token_idx[..., None].expand(G, Tg * k, D))
    buf[g_idx, sorted_e, torch.where(keep, slot, C)] = rows
    w = torch.gather(top_p.reshape(G, -1), 1, order)
    return buf[:, :, :C], (sorted_e, slot, keep, token_idx, w)


def _grouped_ffn(wg, wu, wd, buf: torch.Tensor, act: str,
                 mode: str) -> torch.Tensor:
    """(E, R, D) -> (E, R, D) per-expert FFN through `dense_grouped` (silu
    fused into the gate projection's epilogue)."""
    if act == "swiglu":
        h = (dense_grouped(buf, wg, activation="silu", mode=mode)
             * dense_grouped(buf, wu, mode=mode))
    else:
        h = dense_grouped(buf, wu, activation="gelu", mode=mode)
    return dense_grouped(h, wd, mode=mode)


def _expert_ffn(p, c: MoeConfig, buf: torch.Tensor) -> torch.Tensor:
    """(G, E, C, D) -> (G, E, C, D): the token groups fold into the expert
    row dim, (E, G*C, D), so each expert's weights stream once for all
    groups."""
    G, E, C, D = buf.shape
    rows = buf.transpose(0, 1).reshape(E, G * C, D)
    out = _grouped_ffn(p["w_gate"], p["w_up"], p["w_down"], rows, c.act,
                       c.dense_kernel)
    return out.reshape(E, G, C, D).transpose(0, 1)


def _combine(out_buf: torch.Tensor, meta, Tg: int, dtype) -> torch.Tensor:
    """Gather expert outputs back to token order: (G, E, C, D) -> (G, Tg, D).

    Each token's k weighted contributions are added in the storage dtype,
    in the order the reference's scatter-add visits them (sorted-entry
    order), rounding after each add — deterministic, with no atomics."""
    sorted_e, slot, keep, token_idx, w = meta
    G, Tk = sorted_e.shape
    k = Tk // Tg
    g_idx = torch.arange(G, device=out_buf.device)[:, None]
    gathered = out_buf[g_idx, sorted_e, torch.where(keep, slot, 0)]
    gathered = torch.where(keep[..., None],
                           gathered * w[..., None].to(gathered.dtype),
                           torch.zeros((), dtype=gathered.dtype,
                                       device=gathered.device)).to(dtype)
    # each token's k entries in ascending sorted position: a stable sort by
    # token keeps the sorted-entry order within a token
    pos = torch.argsort(token_idx, dim=-1, stable=True)
    parts = torch.gather(gathered, 1, pos[..., None].expand(
        G, Tk, gathered.shape[-1])).reshape(G, Tg, k, -1)
    out = parts[:, :, 0]
    for j in range(1, k):
        out = out + parts[:, :, j]
    return out


def moe_apply(p, c: MoeConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): grouped dispatch, the routed experts, the
    combine, plus the shared experts."""
    B, S, D = x.shape
    T = B * S
    G = _dispatch_groups(c, T)
    Tg = T // G
    C = capacity(c, Tg)
    buf, meta = _dispatch(p, c, x.reshape(G, Tg, D), C)
    out_buf = _expert_ffn(p, c, buf)
    out = _combine(out_buf, meta, Tg, x.dtype).reshape(B, S, D)

    if c.num_shared_experts:
        xt = x.reshape(T, D)
        sh = p["shared"]
        if c.act == "swiglu":
            hs = (dense(xt, sh["w_gate"], activation="silu",
                        mode=c.dense_kernel)
                  * dense(xt, sh["w_up"], mode=c.dense_kernel))
        else:
            hs = dense(xt, sh["w_up"], activation="gelu", mode=c.dense_kernel)
        out = out + dense(hs, sh["w_down"],
                          mode=c.dense_kernel).reshape(B, S, D)
    return out


def aux_load_balance_loss(p, c: MoeConfig, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (the reference's): E x the
    sum over experts of (the share of tokens whose top expert it is) x
    (its mean router probability).  The router runs through `dense` at
    `router_dtype`, as in `_dispatch`; `transformer.loss_fn` does not add
    it."""
    D = x.shape[-1]
    xt = x.reshape(-1, D)
    w = p["router"]
    if c.router_dtype != torch.float32:
        w = w.to(c.router_dtype)
    logits = dense(xt.to(c.router_dtype), w, mode=c.dense_kernel)
    probs = torch.softmax(logits, dim=-1)
    top_e = torch.argmax(probs, dim=-1)
    frac = (torch.bincount(top_e, minlength=c.num_experts).float()
            / xt.shape[0])
    return c.num_experts * torch.sum(frac * torch.mean(probs, dim=0))
