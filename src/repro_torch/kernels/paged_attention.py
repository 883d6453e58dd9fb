"""Paged attention over shared KV block pools on the H100 (GQA, window).

The port of `repro/kernels/paged_attention.py::paged_attention` (GQA and
sliding-window path).  On a CUDA tensor the wrapper pre-scales q in f32,
casts it to the KV dtype and lays it out as (B, KVH, rep*S, hd) — exactly
the reference's wrapper — then launches `csrc/paged_attention.cu`: one CTA
per (lane, KV head, row split) streams the lane's live K/V blocks through
two G-slot shared-memory rings on the chunk schedule and runs one
online-softmax step per block.  On a CPU tensor it computes the plain
version, `kernels.ref.paged_attn_ref`.  A CUDA tensor the kernel cannot take
raises.

Contract: table entries stay below the pool's block count (0 is the null
block), and the kernel only reads the pools — every write goes through
`models.attention._paged_write_*`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.schedule import paged_attn_row_bytes, plan_paged_attn_sm90
from repro_torch.kernels import build
from repro_torch.kernels.ref import paged_attn_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = build.LaunchCounter()


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [p, p, p, p, p, p] + [i] * 15 \
            + [p]
        lib.paged_attention_launch.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def paged_attention(q: torch.Tensor, pool_a: torch.Tensor,
                    pool_b: torch.Tensor, tables: torch.Tensor,
                    positions: torch.Tensor, *, num_kv_heads: int,
                    scale: float, window: "int | None" = None,
                    num_bufs: "int | None" = None) -> torch.Tensor:
    """Block-table paged attention.

    q: (B, S, H, hd) — decode S == 1 with per-lane positions; a prefill
    chunk B == 1 with any start position; verify S = draft_len + 1.
    pool_a / pool_b: k / v pools (nb, bs, KVH, hd).  tables: (B, MB) int32
    (0 = null block).  positions: (B,) int32 first query position per lane.
    window: sliding-window size.  num_bufs pins the ring depth G.
    Returns (B, S, H, hd) in q.dtype.
    """
    B, S, H, dk = q.shape
    if tables.dim() != 2 or tables.shape[0] != B \
            or tuple(positions.shape) != (B,):
        raise ValueError(f"tables {tuple(tables.shape)} / positions "
                         f"{tuple(positions.shape)} do not match batch {B}")
    if pool_a.shape != pool_b.shape or pool_a.dim() != 4:
        raise ValueError(f"pools must both be (nb, bs, KVH, hd), got "
                         f"{tuple(pool_a.shape)} / {tuple(pool_b.shape)}")
    kvh = num_kv_heads
    if H % kvh or pool_a.shape[2] != kvh or pool_a.shape[3] != dk:
        raise ValueError(f"{H} heads x {dk} do not fit pools "
                         f"{tuple(pool_a.shape)} with {kvh} kv heads")
    if not q.is_cuda:
        return paged_attn_ref(q, pool_a, pool_b, tables, positions,
                              num_kv_heads=kvh, scale=scale, window=window)
    dev = q.device
    for name, t in (("pool_a", pool_a), ("pool_b", pool_b),
                    ("tables", tables), ("positions", positions)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("tables and positions must be int32")
    kd = pool_a.dtype
    if kd not in DTYPES or q.dtype != kd or pool_b.dtype != kd:
        raise TypeError(f"q {q.dtype} and pools {kd}/{pool_b.dtype} must "
                        "share one dtype (float32 or bfloat16)")
    bs = pool_a.shape[1]
    MB = tables.shape[1]
    rep = H // kvh
    rS = rep * S
    # pre-scale in f32, cast to the KV dtype, (B, KVH, rep*S, hd) rows
    qr = (q.float() * scale).to(kd)
    q2 = (qr.reshape(B, S, kvh, rep, dk).permute(0, 2, 3, 1, 4)
          .reshape(B, kvh, rS, dk).contiguous())
    es = pool_a.element_size()
    plan = plan_paged_attn_sm90(rows=rS, block_size=bs, head_dim=dk,
                                kv_itemsize=es, max_blocks=MB,
                                num_bufs=num_bufs)
    out = torch.empty((B, kvh, rS, dk), dtype=kd, device=dev)
    vec = build.copy_width(dk * es, pool_a.data_ptr(), pool_b.data_ptr())
    lib = _lib()
    err = lib.paged_attention_launch(
        q2.data_ptr(), pool_a.data_ptr(), pool_b.data_ptr(),
        tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, MB, bs, kvh, dk, S, rS, plan.rows_per_cta, plan.row_splits,
        plan.num_bufs, plan.chunks, window if window else 0, vec,
        paged_attn_row_bytes(dk, es), DTYPES[kd],
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(lib, err, "paged_attention")
    launches.n += 1
    return (out.reshape(B, kvh, rep, S, dk).permute(0, 3, 1, 2, 4)
            .reshape(B, S, H, dk))
