"""Shared layers: RMSNorm, RoPE, the MLP, embedding and the tied LM head.

Copies of `repro.models.layers` in torch, on plain dicts of tensors.  Norms
and rotary maths run in f32; every MLP projection goes through
`kernels.ops.dense` (the CUDA gpp_matmul on the card, silu fused into the
gate projection's epilogue).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

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


def _trunc_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (inverse-CDF sampling)."""
    lo, hi = (0.5 * (1.0 + torch.erf(torch.tensor(v / 2 ** 0.5)))
              for v in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, device=device)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * 2 ** 0.5
    return x.clamp_(-2.0, 2.0)


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
        w = _trunc_normal(s.shape, generator, device)
        return (w * scale).to(s.dtype)
    return map_specs(leaf, specs)


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


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


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32 against the (vocab, d) embedding.  Uses the f32 copy
    `embedding_f32` when the caller made one (`transformer.serving_params`
    does, once), so the 151936 x 1024 table is not re-cast every step."""
    table = p.get("embedding_f32")
    if table is None:
        table = p["embedding"].float()
    return x.float() @ table.t()
