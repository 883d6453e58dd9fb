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

Under a mesh (`dist.collectives.on_mesh`, with the layer's specs) the
reference's explicit schedules run instead, with its conditions
(`moe_apply`):
  _moe_shard_map        training / prefill: ONE group of the rank's T_local
                        tokens at C = capacity(c, T_local) (not the
                        mesh-less path's dispatch groups: with dropped
                        tokens the two differ, as in the reference); the
                        rank's expert slice (E on "model"), its data-split
                        weights gathered over "data", then a reduce over
                        "model"
  _moe_shard_map_serve  decode (`serve_resident`): every token of the
                        batch, experts over "model" and d_ff over "data",
                        resident, then one reduce over ("model", "data"),
                        never over "pod"
The reference routes `dense_grouped`'s "auto" to its plain path under a
mesh, because a `pallas_call` on sharded arrays would make XLA gather
them; a torch rank's tensors are already its own, so here "auto" stays the
kernel on a CUDA tensor (`gpp_matmul_grouped` on the rank's E_local
experts) and the plain version on the CPU.  That changes no number.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.dist.collectives import (copy_to, current, gather_from,
                                          reduce_from, take)
from repro_torch.kernels.ops import dense, dense_grouped
from repro_torch.models.layers import Spec, mlp


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
    serve_resident: bool = False   # decode: resident E:model x d_ff:data
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


def _routed_local(p, c: MoeConfig, xt, C: int, n_local: int, r: int):
    """One group of tokens xt (T, D): dispatch, run model rank r's expert
    slice (E_local = n_local experts from r * n_local), combine; the
    result is the rank's partial, which the caller sums over "model"."""
    T, D = xt.shape
    buf, meta = _dispatch(p, c, xt[None], C)            # (1, E, C, D)
    lo = r * n_local
    out_e = _grouped_ffn(p["w_gate"], p["w_up"], p["w_down"],
                         buf[0, lo:lo + n_local], c.act, c.dense_kernel)
    E = c.num_experts
    # back into the full-E frame so the combine's gather stays as it is
    pad = (lambda n: out_e.new_zeros((n, *out_e.shape[1:])))
    out_buf = torch.cat([pad(lo), out_e, pad(E - lo - n_local)])
    return _combine(out_buf[None], meta, T, xt.dtype)[0]


def _moe_shard_map(p, c: MoeConfig, x: torch.Tensor, par, spec):
    """Routed experts on the rank's tokens (module docstring): x (B, S, D)
    the rank's rows; the expert stacks' pieces as `spec` names them
    (E on "model", and maybe d_model on "data"); the router whole."""
    B, S, D = x.shape
    C = capacity(c, B * S)
    n_local = c.num_experts // par.tp
    w = {"router": take(p["router"], spec["router"], None, par)}
    for n in ("w_gate", "w_up", "w_down"):
        # the "rewrite": this rank's expert slice gathered over "data"
        w[n] = take(p[n], spec[n], ("model", None, None), par)
    out = _routed_local(w, c, copy_to(x, par).reshape(-1, D), C, n_local,
                        par.rank("model"))
    return reduce_from(out, par).reshape(B, S, D)


def _moe_shard_map_serve(p, c: MoeConfig, x: torch.Tensor, par, spec):
    """Decode-time routed experts with RESIDENT weights: E over "model",
    d_ff over "data", no weight gathered; every token of the batch (tiny
    at decode, gathered over the dp axes when they split it) on every
    rank, each computing its (E_local x d_ff slice) partial, summed over
    "model" and "data", never "pod" (the weights are whole across
    pods)."""
    B, S, D = x.shape
    dp_ax = par.dp_axis
    split = par.batch_split and par.dp > 1
    xs = gather_from(x, 0, par, dp_ax) if split else x
    T = xs.shape[0] * S
    C = capacity(c, T)
    n_local = c.num_experts // par.tp
    ff = "data"
    # each data rank's work on the router is a part too (its d_ff slice)
    w = {"router": copy_to(take(p["router"], spec["router"], None, par),
                           par, ff),
         "w_gate": take(p["w_gate"], spec["w_gate"],
                        ("model", None, ff), par),
         "w_up": take(p["w_up"], spec["w_up"], ("model", None, ff), par),
         "w_down": take(p["w_down"], spec["w_down"],
                        ("model", ff, None), par)}
    out = _routed_local(w, c, copy_to(copy_to(xs, par), par, ff)
                        .reshape(T, D), C, n_local, par.rank("model"))
    out = reduce_from(reduce_from(out, par), par, ff).reshape(-1, S, D)
    if split:
        # each dp rank keeps its rows: their gradients sum over dp again
        out = copy_to(out, par, dp_ax).narrow(0, par.rank(dp_ax) * B, B)
    return out


def _mesh_dispatch(c: MoeConfig, T: int, par) -> "str | None":
    """The reference's choice (moe.py:279-300): the serve form for a
    decode-sized batch of resident experts, else the shard-map form, when
    the experts divide the model axis."""
    if par is None or c.num_experts % par.tp:
        return None
    T_all = T * par.dp if par.batch_split else T
    if c.serve_resident and T_all <= 4096:
        return "serve"
    return "shard_map"


def moe_apply(p, c: MoeConfig, x: torch.Tensor, spec=None) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D): grouped dispatch, the routed experts, the
    combine, plus the shared experts.  Under a mesh with the layer's
    `spec`, the routed experts take the mesh forms of the module
    docstring and the shared experts the MLP's tensor-parallel form."""
    B, S, D = x.shape
    T = B * S
    par = current() if spec is not None else None
    form = _mesh_dispatch(c, T, par)
    if form is not None:
        routed = (_moe_shard_map_serve if form == "serve"
                  else _moe_shard_map)(p, c, x, par, spec)
        if c.num_shared_experts:
            routed = routed + mlp(p["shared"], x.reshape(T, D), c.act,
                                  c.dense_kernel,
                                  spec=spec.get("shared")).reshape(B, S, D)
        return routed
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
