#!/usr/bin/env python3
"""Split, ring and warp sweep of the tensor-core MLA paged-attention kernel
on one NVIDIA GPU: the measurements behind `plan_paged_attn_mla_tc_sm90`.

    python3 scripts/mla_tc_sweep.py [--ablate] [--json-out PATH]

At the deepseek-v2-lite-16b path's MLA shapes in bf16 (16 heads, latent
512 + rope 64, 8 blocks of 16 tokens a lane; decode B=4 S=1 at positions
[5, 17, 40, 100], prefill B=1 S=32 from 37, verify B=4 S=5 at [3, 30, 64,
90]) it launches `paged_attention_mla_tc_kernel` through its C entry at
every kv_splits in {1, 2, 4, 8, planned}, ring depth G in {1, 2, 4,
planned} (clamped to the longest run, as the planner does) and 4 or 8
warps, and prints the time per launch: CUDA events around the replay of a
CUDA graph of 50 launches whose inputs rotate through copies larger than
the L2 cache (a launch takes a few microseconds, less than the host's cost
of issuing one from Python), with the merge kernel after it where the
blocks are split, and each of the two alone.  Each configuration's output
is held against `kernels.ref.paged_attn_ref` (bf16 tolerance 2e-2).
`--ablate` also builds copies of the kernel sources with the tensor-core
products compiled out and with the KV copies compiled out, and times them
at the planned configuration.  `--phases` builds a copy that stamps
%globaltimer (ns) at each phase of one CTA (lane 3 at position 100: its
7 live blocks) and prints where a run's time goes — prologue, each step's
copy issue and wait, q.k, softmax, p.v, the partial's store — at
kv_splits 8 (one block a run, as planned) and 1 (all 7 blocks in one run)
for G in {1, 2, 8}, the L2 flushed before each of 3 repeats.  Without
CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

H, R, RR, BS, MB, SLOTS = 16, 512, 64, 16, 8, 4
SHAPES = {"decode": (SLOTS, 1, [5, 17, 40, 100]),
          "prefill": (1, 32, [37]),
          "verify": (SLOTS, 5, [3, 30, 64, 90])}
L2_BYTES = 50 * 1024 * 1024
# %globaltimer stamps (thread 0 of CTA rec_cta, into the record buffer)
_STAMP = ('  { long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : '
          '"=l"(t_)); if (threadIdx.x == 0 && cta == a.rec_cta && a.rec) '
          'reinterpret_cast<long long*>(a.rec)[stamps++] = t_; }\n')
PHASES = ["prologue", "issue+wait", "q.k", "softmax", "p.v"]
PHASE_EDITS = [("paged_attention.cu", old, new) for old, new in (
    ("    if (recorder) {\n      a.rec[3 * rec_n + 0] = step;",
     "    if (false) {\n      a.rec[3 * rec_n + 0] = step;"),
    ("  const int cta = (b * a.row_tiles + tile) * a.kv_splits + split;\n"
     "  const bool recorder", "  const bool recorder"),
    ("  const int* trow = a.tables + (size_t)b * a.MB;\n  const int j_lo",
     "  int stamps = 0;\n  const int cta = (b * a.row_tiles + tile) * "
     "a.kv_splits + split;\n" + _STAMP + "  const int* trow = a.tables + "
     "(size_t)b * a.MB;\n  const int j_lo"),
    ("  if (n == 0) {  // no block", _STAMP + "  if (n == 0) {  // no block"),
    ("      gpp::run_chunk_schedule(s, n, a.G, a.C, issue);\n",
     "      gpp::run_chunk_schedule(s, n, a.G, a.C, issue);\n" + _STAMP),
    ("      // softmax step, every warp", _STAMP + "      // softmax step, "
     "every warp"),
    ("      // acc = acc * corr + bf16(p)", _STAMP + "      // acc = acc * "
     "corr + bf16(p)"),
    ("      __syncthreads();  // the ring slot and the partial logits are "
     "free\n", "      __syncthreads();  // the ring slot and the partial "
     "logits are free\n" + _STAMP),
    ("  if (warp == 0 && q4 == 0) {\n    float2* ml",
     _STAMP + "  if (warp == 0 && q4 == 0) {\n    float2* ml"))]
ABLATIONS = {
    # copies, waits, ldmatrix, softmax and merge; no tensor-core product
    "no_mma": [("mma.cuh", '  asm volatile(\n      "mma.sync',
                '  if (false) asm volatile(\n      "mma.sync')],
    # the q tile still loads; the KV blocks do not
    "no_copy": [("paged_attention.cu",
                 "      gpp::cp_async<16>(dst + t * RB + swizzle(t, j * 16),",
                 "      if (false) gpp::cp_async<16>(dst + t * RB + "
                 "swizzle(t, j * 16),")],
}


def launcher(lib_path: Path):
    """(the tensor-core kernel's C entry, the merge's) of a library."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.paged_attention_mla_tc_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 14 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    merge = lib.paged_attention_merge_launch
    merge.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    merge.restype = ctypes.c_int
    return fn, merge


def inputs(B, S, positions, seed):
    """chip_smoke.py's MLA inputs, plus q in the kernel's pre-scaled row
    layout: (q, q rows, c_kv, k_rope, tables, positions)."""
    from chip_smoke import mla_inputs
    from repro_torch.kernels.paged_attention import _q_rows
    q, ckv, kr, tables, pos = mla_inputs(B, S, positions, "bfloat16",
                                         nb=SLOTS * MB + 1, seed=seed)
    return (q, _q_rows(q, 1 / math.sqrt(128 + RR), 1, q.dtype), ckv, kr,
            tables, pos)


def phases(fn) -> "list[dict]":
    """Where one CTA's time goes (module docstring): decode-shaped inputs
    with every lane at position 100, CTA (lane 3, tile 0, split 0)."""
    import torch
    from repro_torch.core import schedule as sched
    from repro_torch.kernels.paged_attention import _q_rows
    B, nb = SLOTS, 200
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(B, 1, H, R + RR, generator=g, device="cuda").bfloat16()
    ckv = (torch.randn(nb, BS, R, generator=g, device="cuda")
           * 0.5).bfloat16()
    kr = (torch.randn(nb, BS, RR, generator=g, device="cuda")
          * 0.5).bfloat16()
    tables = (torch.randperm(nb - 1, generator=g, device="cuda")[:B * MB]
              + 1).int().reshape(B, MB).contiguous()
    pos = torch.full((B,), 100, dtype=torch.int32, device="cuda")
    q2 = _q_rows(q, 1 / math.sqrt(128 + RR), 1, q.dtype)
    out = torch.empty((B, 1, H, R), dtype=torch.bfloat16, device="cuda")
    rows = []
    for ks, G in ((8, 1), (1, 1), (1, 2), (1, 8)):
        plan = sched.plan_paged_attn_mla_tc_sm90(
            batch=B, rows=H, block_size=BS, max_blocks=MB, latent=R,
            rope=RR, num_bufs=G, kv_splits=ks)
        ws = torch.empty(max(1, plan.workspace_floats(R)), device="cuda")
        for rep in range(3):
            rec = torch.zeros(256, dtype=torch.int64, device="cuda")
            torch.empty(2 * L2_BYTES, dtype=torch.uint8,
                        device="cuda").zero_()     # flush the L2
            torch.cuda.synchronize()
            err = fn(q2.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
                     tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
                     ws.data_ptr(), rec.data_ptr(), B, MB, BS, R, RR, 1, H,
                     plan.row_tiles, plan.kv_splits, plan.num_bufs,
                     plan.chunks, 0, plan.warps, plan.cta(3, 0, 0),
                     torch.cuda.current_stream().cuda_stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"launch refused: {err}")
            t = [x for x in rec.tolist() if x]
            d = [t[i + 1] - t[i] for i in range(len(t) - 1)]
            steps = [dict(zip(PHASES[1:], d[1 + 4 * s:5 + 4 * s]))
                     for s in range((len(d) - 1) // 4)]
            row = {"kv_splits": ks, "G": plan.num_bufs, "rep": rep,
                   "total_ns": t[-1] - t[0], "prologue_ns": d[0],
                   "steps_ns": steps}
            rows.append(row)
            print(f"phases kv_splits={ks} G={plan.num_bufs} rep={rep}: "
                  f"total {row['total_ns']} ns, prologue {d[0]}, steps "
                  + "; ".join("/".join(str(v) for v in st.values())
                              for st in steps)
                  + " (issue+wait/q.k/softmax/p.v ns)", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mla_tc_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import schedule as sched
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import paged_attn_ref
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    build.build_all(("paged_attention",))
    fns = {"kernel": launcher(build.library_path("paged_attention"))}
    variants = dict(ABLATIONS) if args.ablate else {}
    if args.phases:
        variants["phases"] = PHASE_EDITS
    built = build.build_variants("paged_attention", variants) \
        if variants else {}
    fns.update({n: launcher(p) for n, p in built.items() if n != "phases"})
    stamped = phases(launcher(built["phases"])[0]) if args.phases else []
    side = torch.cuda.Stream()
    rows = []
    for name, (B, S, positions) in SHAPES.items():
        planned = sched.plan_paged_attn_mla_tc_sm90(
            batch=B, rows=H * S, block_size=BS, max_blocks=MB, latent=R,
            rope=RR)
        n = max(2, math.ceil(2 * L2_BYTES / ((SLOTS * MB + 1) * BS
                                             * (R + RR) * 2)))
        sets = [inputs(B, S, positions, i) for i in range(n)]
        kw = dict(num_kv_heads=1, scale=1 / math.sqrt(128 + RR), mla=True)
        ref = paged_attn_ref(sets[0][0], *sets[0][2:], **kw).float()
        out = torch.empty((B, 1, H * S, R), dtype=torch.bfloat16,
                          device="cuda")
        print(f"{name} B={B} S={S} positions={positions}: planned "
              f"kv_splits={planned.kv_splits} G={planned.num_bufs} "
              f"warps={planned.warps} ctas={planned.ctas}", flush=True)
        splits = sorted({1, 2, 4, 8, planned.kv_splits})
        for ks in splits:
            for G in sorted({1, 2, 4, planned.num_bufs}):
                for warps in (4, 8):
                    plan = sched.plan_paged_attn_mla_tc_sm90(
                        batch=B, rows=H * S, block_size=BS, max_blocks=MB,
                        latent=R, rope=RR, num_bufs=G, kv_splits=ks,
                        warps=warps)
                    if plan.num_bufs != G and G != planned.num_bufs:
                        continue          # clamped to the run: a repeat
                    ws = torch.empty(max(1, plan.workspace_floats(R)),
                                     dtype=torch.float32, device="cuda")

                    def call(fns_, q2, c, k, t, p, plan=plan, ws=ws,
                             main=True, merge=True):
                        fn, mfn = fns_
                        st = torch.cuda.current_stream().cuda_stream
                        err = 0
                        if main:
                            err = fn(q2.data_ptr(), c.data_ptr(),
                                     k.data_ptr(), t.data_ptr(),
                                     p.data_ptr(), out.data_ptr(),
                                     ws.data_ptr(), None, B, MB, BS, R, RR,
                                     S, H * S, plan.row_tiles,
                                     plan.kv_splits, plan.num_bufs,
                                     plan.chunks, 0, plan.warps, -1, st)
                        if merge and not err and plan.kv_splits > 1:
                            err = mfn(ws.data_ptr(), out.data_ptr(),
                                      B * plan.row_tiles,
                                      plan.row_tiles, plan.kv_splits, R,
                                      H * S, st)
                        if err:
                            raise RuntimeError(f"launch refused: {err}")

                    with torch.cuda.stream(side):
                        call(fns["kernel"], *sets[0][1:])
                    torch.cuda.synchronize()
                    got = out.reshape(B, H, S, R).permute(0, 2, 1, 3)
                    max_err = float((got.float() - ref).abs().max())
                    if max_err > 2e-2:
                        raise AssertionError(f"{name} ks={ks} G={G} "
                                             f"warps={warps}: max err "
                                             f"{max_err}")
                    is_plan = (ks, plan.num_bufs, warps) == (
                        planned.kv_splits, planned.num_bufs, planned.warps)
                    row = {"shape": name, "B": B, "S": S,
                           "kv_splits": ks, "G": plan.num_bufs,
                           "warps": warps, "ctas": plan.ctas,
                           "smem": plan.smem_bytes, "max_abs_err": max_err,
                           "planned": is_plan}
                    args_ = [s_[1:] for s_ in sets]
                    row["ms"] = graph_ms(
                        lambda *a: call(fns["kernel"], *a), args_, side)
                    if plan.kv_splits > 1:   # each of the two alone
                        row["kernel_ms"] = graph_ms(
                            lambda *a: call(fns["kernel"], *a, merge=False),
                            args_, side)
                        row["merge_ms"] = graph_ms(
                            lambda *a: call(fns["kernel"], *a, main=False),
                            args_, side)
                    for tag, fn in fns.items():
                        if tag != "kernel" and is_plan:
                            row[f"{tag}_ms"] = graph_ms(
                                lambda *a, fn=fn: call(fn, *a), args_, side)
                    rows.append(row)
                    extra = "".join(f" {t}={row[t + '_ms']:.4f}"
                                    for t in ("kernel", "merge", *ABLATIONS)
                                    if t + "_ms" in row)
                    print(f"  kv_splits={ks} G={plan.num_bufs} "
                          f"warps={warps} ctas={plan.ctas} "
                          f"smem={plan.smem_bytes} ms={row['ms']:.4f} "
                          f"err={max_err:.3g}"
                          + (" (planned)" if is_plan else "") + extra,
                          flush=True)
    if args.json_out:
        out_path = Path(args.json_out)
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps({"card": card, "rows": rows,
                                        "phases": stamped}, indent=1))
    return 0


def graph_ms(call, argsets, side, iters=50) -> float:
    """ms per launch: CUDA events around replays of a CUDA graph of
    `iters` launches cycling through `argsets`."""
    import torch
    with torch.cuda.stream(side):
        for a in argsets:
            call(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            call(*argsets[i % len(argsets)])
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(4):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (4 * iters)


if __name__ == "__main__":
    sys.exit(main())
