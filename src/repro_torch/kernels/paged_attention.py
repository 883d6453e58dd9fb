"""Paged attention over shared KV block pools on the H100 (GQA, window, MLA).

The port of `repro/kernels/paged_attention.py::paged_attention`, both its
GQA / sliding-window path and its `mla=True` path.  The wrapper pre-scales
q in f32, casts it to the KV dtype and lays it out as (B, KVH, rep*S, dk) —
exactly the reference's wrapper — then launches `csrc/paged_attention.cu`:
one CTA per (lane, KV head, row split) streams the lane's live blocks of
both pools through two G-slot shared-memory rings on the chunk schedule and
runs one online-softmax step per block.  MLA is latent MQA: one shared KV
head whose key is concat(c_kv, k_rope) and whose value is the c_kv row.

CUDA tensors only: a CPU tensor, or a CUDA tensor the kernel cannot take,
raises (the plain version is `kernels.ref.paged_attn_ref`, which
`kernels.ops.paged_attn` runs on the CPU).  The GQA and MLA forms keep
separate launch counts.

Contract: table entries stay below the pool's block count (0 is the null
block), and the kernel only reads the pools — every write goes through
`models.attention._paged_write_*`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.schedule import paged_attn_row_bytes, plan_paged_attn_sm90
from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = build.LaunchCounter()       # GQA / window form
launches_mla = build.LaunchCounter()   # MLA form


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [p] * 6 + [i] * 18 + [p]
        lib.paged_attention_launch.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def paged_attention(q: torch.Tensor, pool_a: torch.Tensor,
                    pool_b: torch.Tensor, tables: torch.Tensor,
                    positions: torch.Tensor, *, num_kv_heads: int,
                    scale: float, window: "int | None" = None,
                    mla: bool = False,
                    num_bufs: "int | None" = None) -> torch.Tensor:
    """Block-table paged attention.

    q: (B, S, H, dk) — decode S == 1 with per-lane positions; a prefill
    chunk B == 1 with any start position; verify S = draft_len + 1.
    GQA: pool_a / pool_b are the k / v pools (nb, bs, KVH, hd).  MLA
    (`mla`): c_kv (nb, bs, kv_lora) / k_rope (nb, bs, rope), q already
    absorbed through w_uk (dk = kv_lora + rope), num_kv_heads ignored (one
    shared head).  tables: (B, MB) int32 (0 = null block).  positions: (B,)
    int32 first query position per lane.  window: sliding-window size.
    num_bufs pins the ring depth G.  Returns (B, S, H, dv) in q.dtype (dv =
    hd, or kv_lora under `mla`).
    """
    B, S, H, dk = q.shape
    if tables.dim() != 2 or tables.shape[0] != B \
            or tuple(positions.shape) != (B,):
        raise ValueError(f"tables {tuple(tables.shape)} / positions "
                         f"{tuple(positions.shape)} do not match batch {B}")
    if mla:
        if pool_a.dim() != 3 or pool_b.dim() != 3 \
                or pool_a.shape[:2] != pool_b.shape[:2]:
            raise ValueError(f"MLA pools must be (nb, bs, kv_lora) and "
                             f"(nb, bs, rope), got {tuple(pool_a.shape)} / "
                             f"{tuple(pool_b.shape)}")
        kvh, da, db = 1, pool_a.shape[2], pool_b.shape[2]
        if dk != da + db:
            raise ValueError(f"mla q dk={dk} != kv_lora {da} + rope {db}")
    else:
        if pool_a.shape != pool_b.shape or pool_a.dim() != 4:
            raise ValueError(f"pools must both be (nb, bs, KVH, hd), got "
                             f"{tuple(pool_a.shape)} / {tuple(pool_b.shape)}")
        kvh = num_kv_heads
        if H % kvh or pool_a.shape[2] != kvh or pool_a.shape[3] != dk:
            raise ValueError(f"{H} heads x {dk} do not fit pools "
                             f"{tuple(pool_a.shape)} with {kvh} kv heads")
        da = db = dk
    if not q.is_cuda:
        raise ValueError(f"paged_attention launches a CUDA kernel and needs "
                         f"CUDA tensors, got q on {q.device} (the plain "
                         "version is kernels.ref.paged_attn_ref; "
                         "kernels.ops.paged_attn routes by device)")
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
    dv = da if mla else db
    # pre-scale in f32, cast to the KV dtype, (B, KVH, rep*S, dk) rows
    qr = (q.float() * scale).to(kd)
    q2 = (qr.reshape(B, S, kvh, rep, dk).permute(0, 2, 3, 1, 4)
          .reshape(B, kvh, rS, dk).contiguous())
    es = pool_a.element_size()
    plan = plan_paged_attn_sm90(rows=rS, block_size=bs, head_dim=da,
                                rope_dim=db if mla else 0, kv_itemsize=es,
                                max_blocks=MB, num_bufs=num_bufs)
    out = torch.empty((B, kvh, rS, dv), dtype=kd, device=dev)
    vec = min(build.copy_width(da * es, pool_a.data_ptr()),
              build.copy_width(db * es, pool_b.data_ptr()))
    lib = _lib()
    err = lib.paged_attention_launch(
        q2.data_ptr(), pool_a.data_ptr(), pool_b.data_ptr(),
        tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, MB, bs, kvh, da, db, int(mla), S, rS, plan.rows_per_cta,
        plan.row_splits, plan.num_bufs, plan.chunks, window if window else 0,
        vec, paged_attn_row_bytes(da, es), paged_attn_row_bytes(db, es),
        DTYPES[kd], torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(lib, err, "paged_attention")
    (launches_mla if mla else launches).n += 1
    return (out.reshape(B, kvh, rep, S, dv).permute(0, 3, 1, 2, 4)
            .reshape(B, S, H, dv))
