"""Model-facing entry points for the kernels: `dense` and `paged_attn`.

Copies of `repro.kernels.ops.dense` (with its einsum-shaped `contract_dims`
adapter) and `repro.kernels.ops.paged_attn`, routed by mode:

  auto    the CUDA kernel for a CUDA tensor, the plain path for a CPU tensor
  kernel  the CUDA kernel; raises on a CPU tensor
  ref     the plain PyTorch path, for tests and kernel-vs-plain comparisons

The plain path of both is the kernel's plain version (`kernels.ref`):
`dense_ref` accumulates in f32 and runs the epilogue in f32, as the kernel
does.  (The reference's own CPU path, `_dense_ref_path`, multiplies in the
ambient dtype, so the two agree tightly at f32 and loosely at bf16.)  The
reference's 1 MiB size threshold is not copied: on a CUDA tensor every
projection runs the kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.gpp_matmul import gpp_matmul
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ref import ACTIVATIONS, dense_ref, paged_attn_ref

DENSE_MODES = ("auto", "ref", "kernel")


def resolve_mode(mode: str, t: torch.Tensor) -> str:
    """"kernel" or "ref" for a tensor on t's device (module docstring)."""
    if mode not in DENSE_MODES:
        raise ValueError(f"mode must be one of {DENSE_MODES}, got {mode!r}")
    if mode == "auto":
        return "kernel" if t.is_cuda else "ref"
    if mode == "kernel" and not t.is_cuda:
        raise ValueError("mode='kernel' launches a CUDA kernel and needs "
                         "CUDA tensors")
    return mode


def dense(x: torch.Tensor, w: torch.Tensor, *, bias=None, w_scale=None,
          activation: "str | None" = None, mode: str = "auto",
          contract_dims: int = 1) -> torch.Tensor:
    """act(x @ w [* w_scale] [+ bias]) over arbitrary leading dims of x.

    The last `contract_dims` dims of x contract against the first
    `contract_dims` dims of w; w's remaining dims shape the output — q-proj
    `bsd,dhk->bshk` is `dense(x, w_q)`, o-proj `bshk,hkd->bsd` is
    `dense(out, w_o, contract_dims=2)`.  bias matches w's output dims.
    """
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if not 1 <= contract_dims <= min(x.dim(), w.dim()):
        raise ValueError(f"contract_dims={contract_dims} invalid for "
                         f"x{tuple(x.shape)} @ w{tuple(w.shape)}")
    cshape = tuple(w.shape[:contract_dims])
    if tuple(x.shape[x.dim() - contract_dims:]) != cshape:
        raise ValueError(
            f"contraction mismatch: x{tuple(x.shape)} trailing dims vs "
            f"w{tuple(w.shape)} leading dims (contract_dims={contract_dims})")
    out_dims = tuple(w.shape[contract_dims:])
    Kf, Nf = math.prod(cshape), math.prod(out_dims)
    lead = tuple(x.shape[:x.dim() - contract_dims])
    x2 = x.reshape(-1, Kf)
    w2 = w.reshape(Kf, Nf)
    if bias is not None:
        bias = bias.reshape(Nf)
    if resolve_mode(mode, x) == "ref":
        y2 = dense_ref(x2, w2, bias=bias, w_scale=w_scale,
                       activation=activation)
    else:
        y2 = gpp_matmul(x2.contiguous(), w2, bias=bias, w_scale=w_scale,
                        activation=activation)
    return y2.reshape(*lead, *out_dims)


def paged_attn(q, pool_a, pool_b, tables, positions, *, num_kv_heads: int,
               scale: float, window: "int | None" = None, mode: str = "auto",
               num_bufs: "int | None" = None) -> torch.Tensor:
    """Paged attention over shared block pools, routed like `dense`.

    q: (B, S, H, hd); pools: (nb, bs, KVH, hd); tables: (B, MB) int32 block
    table (0 = null block); positions: (B,) int32 per-lane query start
    positions.  "ref" gathers through the tables and runs the exact
    `_sdpa` math (`kernels.ref.paged_attn_ref`).
    """
    if resolve_mode(mode, q) == "ref":
        return paged_attn_ref(q, pool_a, pool_b, tables, positions,
                              num_kv_heads=num_kv_heads, scale=scale,
                              window=window)
    return paged_attention(q, pool_a, pool_b, tables, positions,
                           num_kv_heads=num_kv_heads, scale=scale,
                           window=window, num_bufs=num_bufs)
