"""Shared layers: RMSNorm, RoPE, the MLP, embedding, the LM heads and the
cross-entropy loss.

Copies of `repro.models.layers` in torch, on plain dicts of tensors.  Norms
and rotary maths run in f32; RMSNorm goes through `kernels.ops.rmsnorm`
(the row-invariant CUDA kernel on the card) and every MLP projection
through `kernels.ops.dense` (the CUDA gpp_matmul on the card, silu fused
into the gate projection's epilogue).

Under a mesh whose model axis is larger than one rank (`dist.collectives.
tp_par`), `mlp`, `embed` and the heads take their tensor-parallel forms,
chosen from the leaf's spec (which dim it splits over "model"), never from
the config:
  mlp     gate / up column-parallel (d_ff on "model") with a copy at the
          region's entry, down row-parallel with a reduce at its exit;
          with d_ff whole, every model rank computes it all
  embed   the vocab on "model": a rank looks up the tokens in its vocab
          range, zeros for the rest, then a reduce; d_model on "model":
          the lookup, then a gather of the columns
  heads   the table's vocab on "model": local logits, then a gather along
          the vocab; its d_model on "model" (the untied head's spec): a
          rank's columns of x against its columns, then a reduce
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.collectives import (copy_to, gather_from,
                                          reduce_from, spec_dim, take,
                                          tp_par)
from repro_torch.dist.sharding import entry_axes
from repro_torch.kernels import ops
from repro_torch.kernels.ops import dense


class Spec(NamedTuple):
    """Shape and dtype of one parameter or pool leaf (the reference's
    `jax.ShapeDtypeStruct`)."""
    shape: tuple
    dtype: torch.dtype


def map_specs(fn, tree, path=()):
    """Apply fn(path, spec) to every Spec leaf of a nested dict/list."""
    if isinstance(tree, Spec):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, path + (k,)) for k, v in tree.items()}
    return [map_specs(fn, v, path + (i,)) for i, v in enumerate(tree)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts / lists (and of trees of the same
    structure in `rest`), keeping the structure (sequences become
    lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts / lists, in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def stack_specs(specs, n: int):
    """Prepend a stacking dim of size n to every leaf (one per layer)."""
    return map_specs(lambda _, s: Spec((n, *s.shape), s.dtype), specs)


def rmsnorm_specs(d: int, dtype) -> dict:
    return {"scale": Spec((d,), dtype)}


def mlp_specs(d: int, f: int, dtype, act: str) -> dict:
    if act == "swiglu":
        return {"w_gate": Spec((d, f), dtype), "w_up": Spec((d, f), dtype),
                "w_down": Spec((f, d), dtype)}
    return {"w_up": Spec((d, f), dtype), "w_down": Spec((f, d), dtype)}


def embed_specs(vocab: int, d: int, dtype) -> dict:
    return {"embedding": Spec((vocab, d), dtype)}


# elements drawn per slice: the f32 temporaries of one draw (uniforms,
# erfinv, the scaled copy) stay near 256 MB each
INIT_SLICE_ELEMS = 1 << 26


def _trunc_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (inverse-CDF sampling)."""
    lo, hi = (0.5 * (1.0 + torch.erf(torch.tensor(v / 2 ** 0.5)))
              for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, device=device)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * 2 ** 0.5
    return x.clamp_(-2.0, 2.0)


def _fill_trunc_normal(out: torch.Tensor, generator: torch.Generator,
                       scale: float) -> torch.Tensor:
    """Fill `out` (already in its target dtype) with truncated-normal *
    scale, drawn in slices of INIT_SLICE_ELEMS along its flattened leading
    dims, so a 4.8 G-element expert stack never has a whole-leaf f32
    temporary."""
    flat = out.view(-1)
    for i in range(0, flat.numel(), INIT_SLICE_ELEMS):
        n = min(INIT_SLICE_ELEMS, flat.numel() - i)
        flat[i:i + n] = _trunc_normal((n,), generator, out.device) * scale
    return out


def init_from_specs(specs, generator: torch.Generator, device,
                    scale: float = 0.02):
    """Materialize params from a spec tree with the reference's rule:
    ones for '*scale*' / '*norm_w*' leaves, zeros for '*bias*' or < 2-D
    leaves, truncated-normal(0, scale) otherwise.  The numbers are not the
    reference's (torch generator, not jax.random)."""
    def leaf(path, s: Spec):
        name = str(path[-1]) if path else ""
        if "scale" in name or "norm_w" in name:
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if "bias" in name or len(s.shape) < 2:
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        out = torch.empty(s.shape, dtype=s.dtype, device=device)
        return _fill_trunc_normal(out, generator, scale)
    return map_specs(leaf, specs)


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6,
            mode: str = "auto") -> torch.Tensor:
    """The reference's RMSNorm through `kernels.ops.rmsnorm`; `mode` is the
    model's `dense_kernel` (auto / kernel / ref)."""
    return ops.rmsnorm(p, x, eps, mode)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, split-half layout, f32 maths.
    x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    # log(theta) / half in f32 on the host: a Python scalar operand needs no
    # host-to-device copy (which would synchronise the stream every layer)
    step = float(np.float32(np.log(np.float32(theta))) / np.float32(half))
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) * step)
    ang = positions.float()[..., None] * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def model_only(spec) -> tuple:
    """A leaf's spec with every axis but "model" taken out."""
    return tuple("model" if "model" in entry_axes(e) else None
                 for e in (spec or ()))


def mlp(p: dict, x: torch.Tensor, act: str,
        dense_mode: str = "auto", spec: "dict | None" = None) -> torch.Tensor:
    par = tp_par()
    if par is not None and spec is not None:
        return _mlp_tp(p, x, act, dense_mode, spec, par)
    if act == "swiglu":
        h = (dense(x, p["w_gate"], activation="silu", mode=dense_mode)
             * dense(x, p["w_up"], mode=dense_mode))
    else:
        h = dense(x, p["w_up"], activation="gelu", mode=dense_mode)
    return dense(h, p["w_down"], mode=dense_mode)


def _mlp_tp(p, x, act, dense_mode, spec, par):
    ins = ("w_gate", "w_up") if act == "swiglu" else ("w_up",)
    if all(spec_dim(spec[n]) == 1 for n in ins) and \
            spec_dim(spec["w_down"]) == 0:
        w = {n: take(p[n], spec[n], (None, "model"), par) for n in ins}
        w["w_down"] = take(p["w_down"], spec["w_down"], ("model", None), par)
        return reduce_from(mlp(w, copy_to(x, par), act, dense_mode), par)
    w = {n: take(p[n], spec[n], None, par, partial=False)
         for n in ins + ("w_down",)}
    return mlp(w, x, act, dense_mode)


def embed(p: dict, tokens: torch.Tensor,
          spec: "dict | None" = None) -> torch.Tensor:
    par = tp_par()
    if par is None or spec is None:
        return p["embedding"][tokens]
    sp = spec["embedding"]
    md = spec_dim(sp)
    # whole on every model rank (md None): every rank looks up every row
    table = take(p["embedding"], sp, model_only(sp), par,
                 partial=md is not None)
    if md == 0:
        n = table.shape[0]
        local = tokens - par.rank("model") * n
        inside = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        rows = torch.where(inside[..., None], rows,
                           torch.zeros((), dtype=rows.dtype,
                                       device=rows.device))
        return reduce_from(rows, par)
    if md == 1:
        return gather_from(table[tokens], -1, par)
    return table[tokens]


def head_logits_tp(x: torch.Tensor, table: torch.Tensor, spec,
                   mode: str = "auto") -> torch.Tensor:
    """`head_logits` of x against a (vocab, d) table that may be split over
    the model axis (module docstring); whole f32 logits on every rank."""
    par = tp_par()
    if par is None or spec is None:
        return head_logits(x, table, None, mode)
    md = spec_dim(spec)
    table = take(table, spec, model_only(spec), par, partial=md is not None)
    if md == 0:
        return gather_from(head_logits(copy_to(x, par), table, None, mode),
                           -1, par)
    if md == 1:
        n = table.shape[1]
        xr = copy_to(x, par).narrow(-1, par.rank("model") * n, n)
        return reduce_from(head_logits(xr, table, None, mode), par)
    return head_logits(x, table, None, mode)


def head_logits(x: torch.Tensor, table: torch.Tensor,
                table_t: "torch.Tensor | None",
                mode: str = "auto") -> torch.Tensor:
    """f32 logits of x against a (vocab, d) table: f32 x through `dense`
    against `table_t`, the table's contiguous (d, vocab) copy in its stored
    dtype (`transformer.serving_params` makes it once), or, without one,
    the table transposed here.  On a CUDA tensor that is the FMA route of
    `gpp_matmul`, which widens W in registers and gives a row the same bits
    at any number of rows; under "ref" or on the CPU, `dense_ref`."""
    if table_t is None:
        table_t = table.t()
    return dense(x.float(), table_t, mode=mode)


def unembed(p: dict, x: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """Logits in f32 against the (vocab, d) embedding (`head_logits`, on
    the serving copy `embedding_t` when the caller made one)."""
    return head_logits(x, p["embedding"], p.get("embedding_t"), mode)


def lm_head(p: dict, x: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """f32 logits against the untied head's live (vocab, d) `w_out`, never
    its serving copy `w_out_t`: the training head, whose gradient must
    reach the table it reads."""
    return head_logits(x, p["w_out"], None, mode)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token NLL; logits f32 (B, S, V), labels int (B, S)."""
    return torch.mean(_token_nll(logits, labels))


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - ll


def _chunk_nll(head_fn, xc: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
    return torch.sum(_token_nll(head_fn(xc), lc))


def cross_entropy_chunked(head_fn, x: torch.Tensor, labels: torch.Tensor,
                          chunk: int = 512) -> torch.Tensor:
    """Mean token NLL without the whole (B, S, V) logits: the sequence in
    chunks of `chunk` positions, each projected to f32 logits by
    `head_fn`, reduced to its summed NLL and recomputed in the backward
    (`torch.utils.checkpoint`), so the peak holds one chunk's logits (the
    reference's `jax.checkpoint`-ed scan).  When S is not a whole number of
    chunks the sequence is one chunk, as in the reference."""
    B, S, _ = x.shape
    if S % chunk:
        chunk = S
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        total = total + checkpoint(_chunk_nll, head_fn, x[:, i:i + chunk],
                                   labels[:, i:i + chunk],
                                   use_reentrant=False)
    return total / (B * S)
