"""Paged attention over shared KV block pools on the H100 (GQA, window, MLA).

The port of `repro/kernels/paged_attention.py::paged_attention`, both its
GQA / sliding-window path and its `mla=True` path.  The wrapper pre-scales
q in f32, casts it to the KV dtype and lays it out as (B, KVH, rep*S, dk) —
exactly the reference's wrapper — then launches one of the kernels of
`csrc/paged_attention.cu`, routed by form and dtype (`attention_route`):

  * "gqa": `paged_attention_kernel` (f32 / bf16): one CTA per (lane, KV
    head, row split) streams the lane's live K and V blocks through two
    G-slot shared-memory rings on the chunk schedule and runs one
    online-softmax step per block;
  * "mla": `paged_attention_mla_kernel` (f32 MLA, and bf16 MLA at block
    sizes the tensor-core kernel does not take, such as 8 or 128), the
    same walk over the latent pools: latent MQA, one shared KV head whose
    key is concat(c_kv, k_rope) and whose value is the c_kv row;
  * "mla_tc": `paged_attention_mla_tc_kernel` (bf16 MLA at block sizes 16,
    32, 48 and 64): the same function on the tensor cores with the KV walk
    split over CTAs (runs of logical blocks,
    `core.schedule.plan_paged_attn_mla_tc_sm90`), then, with more than one
    run, `paged_attention_mla_merge_kernel` merges the runs' partials into
    the output.

CUDA tensors only: a CPU tensor, or a CUDA tensor the kernel cannot take,
raises (the plain version is `kernels.ref.paged_attn_ref`, which
`kernels.ops.paged_attn` runs on the CPU).  Each kernel keeps its own
launch count.

Contract: table entries stay below the pool's block count (0 is the null
block), and the kernels only read the pools — every write goes through
`models.attention._paged_write_*`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.schedule import (MlaTcPlan, mla_fma_takes,
                                      mla_tc_takes, paged_attn_row_bytes,
                                      plan_paged_attn_mla_tc_sm90,
                                      plan_paged_attn_sm90)
from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = build.LaunchCounter()            # GQA / window form
launches_mla = build.LaunchCounter()        # MLA form, f32 (FMA kernel)
launches_mla_bf16 = build.LaunchCounter()   # MLA form, bf16 (FMA kernel)
launches_mla_tc = build.LaunchCounter()     # MLA form, bf16 (tensor cores)
launches_mla_merge = build.LaunchCounter()  # its merge of split partials


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [p] * 6 + [i] * 18 + [p]
        lib.paged_attention_launch.restype = i
        lib.paged_attention_mla_tc_launch.argtypes = [p] * 8 + [i] * 14 + [p]
        lib.paged_attention_mla_tc_launch.restype = i
        lib.paged_attention_mla_merge_launch.argtypes = [p] * 2 + [i] * 5 + [p]
        lib.paged_attention_mla_merge_launch.restype = i
        lib.paged_attention_mla_tc_ctas_per_sm.argtypes = [i] * 5
        lib.paged_attention_mla_tc_ctas_per_sm.restype = i
        lib.paged_attention_error_string.argtypes = [i]
        lib.paged_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def attention_route(dtype: torch.dtype, mla: bool, block_size: int,
                    latent: int, rope: int) -> str:
    """Which kernel `paged_attention` launches, from the form, the dtype
    and the pool shape alone: "gqa" (the GQA / window kernel; the widths
    are not read), "mla_tc" (bf16 MLA on the tensor cores, where that
    kernel takes the shape: `core.schedule.mla_tc_takes`) or "mla" (the
    FMA MLA kernel: f32, and bf16 at other block sizes).  Raises on an MLA
    shape neither MLA kernel's shared memory holds (block size 256)."""
    if not mla:
        return "gqa"
    if dtype == torch.bfloat16 and mla_tc_takes(block_size, latent, rope):
        return "mla_tc"
    if not mla_fma_takes(block_size, latent, rope, dtype.itemsize):
        raise ValueError(
            f"no MLA kernel takes {dtype} pools of {block_size}-token blocks "
            f"at latent {latent} + rope {rope}: the tensor-core kernel "
            f"(bf16) takes blocks of 16, 32, 48 or 64 tokens, and the FMA "
            f"kernel's in-situ ring of one block does not fit the shared "
            f"memory")
    return "mla"


def paged_attention(q: torch.Tensor, pool_a: torch.Tensor,
                    pool_b: torch.Tensor, tables: torch.Tensor,
                    positions: torch.Tensor, *, num_kv_heads: int,
                    scale: float, window: "int | None" = None,
                    mla: bool = False,
                    num_bufs: "int | None" = None,
                    kv_splits: "int | None" = None) -> torch.Tensor:
    """Block-table paged attention.

    q: (B, S, H, dk) — decode S == 1 with per-lane positions; a prefill
    chunk B == 1 with any start position; verify S = draft_len + 1.
    GQA: pool_a / pool_b are the k / v pools (nb, bs, KVH, hd).  MLA
    (`mla`): c_kv (nb, bs, kv_lora) / k_rope (nb, bs, rope), q already
    absorbed through w_uk (dk = kv_lora + rope), num_kv_heads ignored (one
    shared head).  tables: (B, MB) int32 (0 = null block).  positions: (B,)
    int32 first query position per lane.  window: sliding-window size.
    num_bufs pins the ring depth G.  kv_splits pins the number of runs the
    bf16 MLA kernel cuts each lane's blocks into (1 .. MB; None plans it;
    any other route raises).  Returns (B, S, H, dv) in q.dtype (dv = hd, or
    kv_lora under `mla`).
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
    route = attention_route(kd, mla, bs, da, db)
    if kv_splits is not None and route != "mla_tc":
        raise ValueError(f"kv_splits applies to the bf16 MLA kernel only, "
                         f"not the {route!r} route")
    q2 = _q_rows(q, scale, kvh, kd)
    if route == "mla_tc":
        plan = plan_paged_attn_mla_tc_sm90(
            batch=B, rows=rS, block_size=bs, max_blocks=MB, latent=da,
            rope=db, num_bufs=num_bufs, kv_splits=kv_splits)
        out = _launch_mla_tc(q2, pool_a, pool_b, tables, positions, plan,
                             S=S, window=window)
    else:
        es = pool_a.element_size()
        plan = plan_paged_attn_sm90(rows=rS, block_size=bs, head_dim=da,
                                    rope_dim=db if mla else 0,
                                    kv_itemsize=es, max_blocks=MB,
                                    num_bufs=num_bufs)
        out = torch.empty((B, kvh, rS, dv), dtype=kd, device=dev)
        vec = min(build.copy_width(da * es, pool_a.data_ptr()),
                  build.copy_width(db * es, pool_b.data_ptr()))
        lib = _lib()
        err = lib.paged_attention_launch(
            q2.data_ptr(), pool_a.data_ptr(), pool_b.data_ptr(),
            tables.data_ptr(), positions.data_ptr(), out.data_ptr(),
            B, MB, bs, kvh, da, db, int(mla), S, rS, plan.rows_per_cta,
            plan.row_splits, plan.num_bufs, plan.chunks,
            window if window else 0, vec, paged_attn_row_bytes(da, es),
            paged_attn_row_bytes(db, es), DTYPES[kd],
            torch.cuda.current_stream(dev).cuda_stream)
        build.check_launch(lib, err, "paged_attention")
        if not mla:
            launches.n += 1
        elif kd == torch.bfloat16:
            launches_mla_bf16.n += 1
        else:
            launches_mla.n += 1
    return (out.reshape(B, kvh, rep, S, dv).permute(0, 3, 1, 2, 4)
            .reshape(B, S, H, dv))


def _q_rows(q: torch.Tensor, scale: float, kvh: int,
            kd: torch.dtype) -> torch.Tensor:
    """q pre-scaled in f32, cast to the KV dtype, as (B, KVH, rep*S, dk)
    rows, head-major (row = r * S + s): the reference wrapper's layout."""
    B, S, H, dk = q.shape
    qr = (q.float() * scale).to(kd)
    return (qr.reshape(B, S, kvh, H // kvh, dk).permute(0, 2, 3, 1, 4)
            .reshape(B, kvh, H // kvh * S, dk).contiguous())


def _launch_mla_tc(q2: torch.Tensor, c_kv: torch.Tensor,
                   k_rope: torch.Tensor, tables: torch.Tensor,
                   positions: torch.Tensor, plan: MlaTcPlan, *, S: int,
                   window: "int | None",
                   record: "torch.Tensor | None" = None,
                   rec_cta: int = -1) -> torch.Tensor:
    """The bf16 MLA route on pre-scaled rows q2 (B, 1, rS, da + db): the
    tensor-core kernel, then the merge kernel when the plan splits the
    blocks; returns the latent output (B, 1, rS, da).  The partials'
    workspace comes from the caching allocator; nothing syncs."""
    B, _, rS, _ = q2.shape
    da = c_kv.shape[2]
    out = torch.empty((B, 1, rS, da), dtype=torch.bfloat16, device=q2.device)
    ws = None
    if plan.kv_splits > 1:
        ws = torch.empty(plan.workspace_floats(da), dtype=torch.float32,
                         device=q2.device)
    _launch_mla_split(q2, c_kv, k_rope, tables, positions, plan, out, ws,
                      S=S, window=window, record=record, rec_cta=rec_cta)
    if ws is not None:
        _launch_mla_merge(ws, out, plan, da)
    return out


def _launch_mla_split(q2: torch.Tensor, c_kv: torch.Tensor,
                      k_rope: torch.Tensor, tables: torch.Tensor,
                      positions: torch.Tensor, plan: MlaTcPlan,
                      out: torch.Tensor, ws: "torch.Tensor | None", *,
                      S: int, window: "int | None",
                      record: "torch.Tensor | None" = None,
                      rec_cta: int = -1) -> None:
    """Launch `paged_attention_mla_tc_kernel` alone: with kv_splits == 1
    it writes `out`, else the runs' partials into `ws`
    (`plan.workspace_floats(latent)` f32)."""
    B, _, rS, _ = q2.shape
    da, db = c_kv.shape[2], k_rope.shape[2]
    for name, t in (("q", q2), ("c_kv", c_kv), ("k_rope", k_rope)):
        if t.data_ptr() % 16:
            raise ValueError(f"the tensor-core MLA kernel copies 16-byte "
                             f"pieces: {name} must be 16-byte aligned")
    lib = _lib()
    err = lib.paged_attention_mla_tc_launch(
        q2.data_ptr(), c_kv.data_ptr(), k_rope.data_ptr(), tables.data_ptr(),
        positions.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if record is None else record.data_ptr(),
        B, plan.max_blocks, plan.block_size, da, db, S, rS, plan.row_tiles,
        plan.kv_splits, plan.num_bufs, plan.chunks, window if window else 0,
        plan.warps, rec_cta, torch.cuda.current_stream(q2.device).cuda_stream)
    build.check_launch(lib, err, "paged_attention")
    launches_mla_tc.n += 1


def _launch_mla_merge(ws: torch.Tensor, out: torch.Tensor, plan: MlaTcPlan,
                      latent: int) -> None:
    """Merge the partials the tensor-core MLA kernel left in `ws` into
    `out` (B, 1, rows, latent) bf16 (plain version:
    `kernels.ref.mla_merge_ref`)."""
    lib = _lib()
    err = lib.paged_attention_mla_merge_launch(
        ws.data_ptr(), out.data_ptr(), plan.batch, plan.row_tiles,
        plan.kv_splits, latent, plan.rows,
        torch.cuda.current_stream(ws.device).cuda_stream)
    build.check_launch(lib, err, "paged_attention")
    launches_mla_merge.n += 1


def mla_tc_ctas_per_sm(plan: MlaTcPlan, latent: int, rope: int) -> int:
    """CTAs of the tensor-core MLA kernel an SM of this card holds at
    `plan`'s block size, ring and warps (the planner assumed
    `ctas_per_sm`)."""
    lib = _lib()
    n = lib.paged_attention_mla_tc_ctas_per_sm(
        plan.block_size, latent, rope, plan.num_bufs, plan.warps)
    if n < 0:
        build.check_launch(lib, -n, "paged_attention")
    return n


def mla_live_blocks(plan: MlaTcPlan, positions: "list[int]",
                    S: int) -> "list[list[list[int]]]":
    """[lane][split] -> the logical blocks of that run the kernel walks: the
    ones holding a key at or before the lane's last query position (the
    kernel's live predicate with no window), host-side, for the issue-order
    check."""
    bs = plan.block_size
    return [[[j for j in plan.run(s) if j * bs <= p + S - 1]
             for s in range(plan.kv_splits)] for p in positions]


def issue_order_mla(q: torch.Tensor, c_kv: torch.Tensor,
                    k_rope: torch.Tensor, tables: torch.Tensor,
                    positions: torch.Tensor, *, scale: float,
                    num_bufs: "int | None", kv_splits: "int | None"):
    """Run the bf16 MLA kernel once with the issue-order record on, for the
    first CTA (lane-major, then row tile, then split) whose run holds at
    least 4 live blocks.  Returns ({(step, chunk):
    [issue_steps]}, steps, G, C, cta): `chunk_issue_schedule(steps, G, C)`
    is the order it should equal (the steps are the run's live blocks).
    A check, not the main path: it reads positions on the host."""
    B, S, H, _ = q.shape
    plan = plan_paged_attn_mla_tc_sm90(
        batch=B, rows=H * S, block_size=c_kv.shape[1],
        max_blocks=tables.shape[1], latent=c_kv.shape[2],
        rope=k_rope.shape[2], num_bufs=num_bufs, kv_splits=kv_splits)
    runs = mla_live_blocks(plan, positions.tolist(), S)
    lane, split = next(((b, s) for b in range(B)
                        for s in range(plan.kv_splits)
                        if len(runs[b][s]) >= 4), (None, None))
    if lane is None:
        raise ValueError("no run holds 4 live blocks")
    steps = len(runs[lane][split])
    rec = torch.full((3 * steps * plan.chunks,), -1, dtype=torch.int32,
                     device=q.device)
    cta = plan.cta(lane, 0, split)
    _launch_mla_tc(_q_rows(q, scale, 1, torch.bfloat16), c_kv, k_rope,
                   tables, positions, plan, S=S, window=None, record=rec,
                   rec_cta=cta)
    return (build.read_issue_record(rec), steps, plan.num_bufs, plan.chunks,
            cta)
