"""Shared layers: RMSNorm, RoPE, the MLP, embedding, the LM heads and the
cross-entropy loss.

Copies of `repro.models.layers` in torch, on plain dicts of tensors.  Norms
and rotary maths run in f32; RMSNorm goes through `kernels.ops.rmsnorm`
(the row-invariant CUDA kernel on the card) and every MLP projection
through `kernels.ops.dense` (the CUDA gpp_matmul on the card, silu fused
into the gate projection's epilogue).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

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


def mlp(p: dict, x: torch.Tensor, act: str,
        dense_mode: str = "auto") -> torch.Tensor:
    if act == "swiglu":
        h = (dense(x, p["w_gate"], activation="silu", mode=dense_mode)
             * dense(x, p["w_up"], mode=dense_mode))
    else:
        h = dense(x, p["w_up"], activation="gelu", mode=dense_mode)
    return dense(h, p["w_down"], mode=dense_mode)


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


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
