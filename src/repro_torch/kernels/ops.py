"""Model-facing entry points for the kernels: `dense`, `dense_grouped`,
`paged_attn` and `rmsnorm`; the paper's streamed workload,
`streamed_matmul` and `streamed_gemm_sequence`, with `plan_ring_depth`.

Copies of `repro.kernels.ops.dense` (with its einsum-shaped `contract_dims`
adapter), `dense_grouped` and `paged_attn` (GQA, window and MLA), and the
models' RMSNorm (which the reference leaves to XLA), routed by mode:

  auto    the CUDA kernel for a CUDA tensor, the plain path for a CPU tensor
  kernel  the CUDA kernel; raises on a CPU tensor
  ref     the plain PyTorch path, for tests and kernel-vs-plain comparisons

The plain path of each is the kernel's plain version (`kernels.ref`):
`dense_ref` / `dense_grouped_ref` accumulate in f32 and run the epilogue in
f32, as the kernels do.  (The reference's own CPU paths, `_dense_ref_path`
and `dense_grouped`'s einsum, multiply in the ambient dtype, so the two
agree tightly at f32 and loosely at bf16.)  The
reference's 1 MiB size threshold is not copied: on a CUDA tensor every
projection runs the kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.schedule import (H100_BF16_FLOPS, H100_F32_FLOPS,
                                       H100_HBM_BYTES_PER_S,
                                       TimingCache,
                                       get_default_timing_cache,
                                       plan_stream)
from repro_torch.kernels.gpp_matmul import gpp_matmul, gpp_matmul_grouped
from repro_torch.kernels import rmsnorm as rmsnorm_kernel
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ref import (ACTIVATIONS, dense_grouped_ref,
                                     dense_ref, paged_attn_ref, rmsnorm_ref)

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


def plan_ring_depth(M: int, K: int, block_n: int,
                    dtype: torch.dtype = torch.bfloat16, max_ring: int = 8,
                    timing: "TimingCache | None" = None) -> int:
    """Ring depth G = ceil(t_dma / t_compute) + 1 for one (K, block_n)
    weight tile against M rows (the reference's `plan_ring_depth`, at the
    H100's rates: 3.35e12 B/s and 989e12 bf16 / 67e12 f32 FLOP/s).  With
    `timing` (or a default cache installed by
    `core.schedule.set_default_timing_cache`) the median measured rates
    replace the data sheet's."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    timing = timing if timing is not None else get_default_timing_cache()
    if timing is not None and len(timing):
        flops_per_s, bytes_per_s = timing.effective_rates()
    else:
        flops_per_s = (H100_BF16_FLOPS if dtype == torch.bfloat16
                       else H100_F32_FLOPS)
        bytes_per_s = H100_HBM_BYTES_PER_S
    return plan_stream(block_bytes=K * block_n * itemsize,
                       compute_flops=2.0 * M * K * block_n,
                       flops_per_s=flops_per_s,
                       transfer_bytes_per_s=bytes_per_s,
                       max_ring=max_ring).ring_depth


def streamed_matmul(x: torch.Tensor, w: torch.Tensor, *, bias=None,
                    w_scale=None, activation: "str | None" = None,
                    num_bufs: "int | None" = None,
                    mode: str = "auto") -> torch.Tensor:
    """y = epilogue(x @ w) with the weights streamed through the GPP ring
    (the reference's `streamed_matmul`): `gpp_matmul` on a CUDA tensor,
    whose planner picks the tiles (the reference's block_m / block_n /
    block_k pins are TPU tiles and are not taken), its plain version on the
    CPU.  num_bufs pins the ring depth G."""
    if resolve_mode(mode, x) == "ref":
        return dense_ref(x, w, bias=bias, w_scale=w_scale,
                         activation=activation)
    return gpp_matmul(x, w, bias=bias, w_scale=w_scale,
                      activation=activation, num_bufs=num_bufs)


def fold_rounds(ws: torch.Tensor) -> torch.Tensor:
    """(R, K, N) round weights -> (K, R * N), round r in columns
    [r * N, (r + 1) * N): the reference's fold of the round dimension into
    the streamed tile stream."""
    R, K, N = ws.shape
    return ws.permute(1, 0, 2).reshape(K, R * N)


def streamed_gemm_sequence(x: torch.Tensor, ws: torch.Tensor, *,
                           num_bufs: "int | None" = None,
                           mode: str = "auto") -> torch.Tensor:
    """The paper's BLAS workload (the reference's `streamed_gemm_sequence`):
    consecutive GeMMs ys[r] = x @ ws[r] with every round's weights streamed
    from device memory.  The round dimension is folded into N
    (`fold_rounds`), so the ring pipelines across GeMMs as macros pipeline
    across consecutive layers; one `gpp_matmul` launch, its ring depth G
    pinned by num_bufs or, when None, its own planner's (the reference's
    block_n pin is a TPU tile and is not taken).  Returns (R, M, N)."""
    R, K, N = ws.shape
    M = x.shape[0]
    w_flat = fold_rounds(ws)
    if resolve_mode(mode, x) == "ref":
        y = dense_ref(x, w_flat)
    else:
        y = gpp_matmul(x, w_flat, num_bufs=num_bufs)
    return y.reshape(M, R, N).permute(1, 0, 2).contiguous()


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
        y2 = gpp_matmul(x2.contiguous(), w2.contiguous(), bias=bias,
                        w_scale=w_scale, activation=activation)
    return y2.reshape(*lead, *out_dims)


def dense_grouped(x: torch.Tensor, w: torch.Tensor, *, bias=None,
                  w_scale=None, activation: "str | None" = None,
                  mode: str = "auto") -> torch.Tensor:
    """Per-expert act(x[e] @ w[e] [* w_scale[e]] [+ bias[e]]):
    (E, C, D) @ (E, D, F) -> (E, C, F).  w_scale: scalar, (E,) or (E, F)
    (int8 dequant, applied to the f32 accumulator); bias: (E, F).  "kernel"
    launches the CUDA `gpp_matmul_grouped`, "ref" its plain version."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"dense_grouped wants (E,C,D) @ (E,D,F), got "
                         f"x{tuple(x.shape)} w{tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"grouped shape mismatch: x{tuple(x.shape)} @ "
                         f"w{tuple(w.shape)}")
    if resolve_mode(mode, x) == "ref":
        return dense_grouped_ref(x, w, bias=bias, w_scale=w_scale,
                                 activation=activation)
    return gpp_matmul_grouped(x.contiguous(), w, bias=bias, w_scale=w_scale,
                              activation=activation)


# the reference's name for the paged-attention resolver: the same rule as
# `dense` ("kernel" on a CUDA q, "ref", the gather + `_sdpa` math, on a CPU q)
resolve_paged_attn_mode = resolve_mode


def paged_attn(q, pool_a, pool_b, tables, positions, *, num_kv_heads: int,
               scale: float, window: "int | None" = None, mla: bool = False,
               mode: str = "auto",
               num_bufs: "int | None" = None) -> torch.Tensor:
    """Paged attention over shared block pools, routed like `dense`.

    q: (B, S, H, dk); tables: (B, MB) int32 block table (0 = null block);
    positions: (B,) int32 per-lane query start positions.  GQA: pools are
    k / v (nb, bs, KVH, hd).  MLA (`mla`): pools are c_kv / k_rope, q is
    already absorbed through w_uk (dk = kv_lora + rope) and the result is
    the latent output for the caller to up-project.  "ref" gathers through
    the tables and runs the exact `_sdpa` math (`kernels.ref.paged_attn_ref`).
    """
    if resolve_paged_attn_mode(mode, q) == "ref":
        return paged_attn_ref(q, pool_a, pool_b, tables, positions,
                              num_kv_heads=num_kv_heads, scale=scale,
                              window=window, mla=mla)
    return paged_attention(q, pool_a, pool_b, tables, positions,
                           num_kv_heads=num_kv_heads, scale=scale,
                           window=window, mla=mla, num_bufs=num_bufs)


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6,
            mode: str = "auto") -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * p["scale"] over x's last dim in f32,
    cast to x.dtype, routed like `dense`: "kernel" launches the CUDA
    `rmsnorm_kernel`, whose rows are the same bits whatever rows come with
    them, "ref" its plain version (`kernels.ref.rmsnorm_ref`)."""
    if resolve_mode(mode, x) == "ref":
        return rmsnorm_ref(x, p["scale"], eps)
    return rmsnorm_kernel.rmsnorm(x, p["scale"], eps)
