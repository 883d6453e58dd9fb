#!/usr/bin/env python3
"""Piece, split and ring sweep of the FMA paged-attention kernels on one
NVIDIA GPU: the measurements behind `plan_paged_attn_fma_sm90`'s rule.

    python3 scripts/fma_attn_sweep.py [--ablate] [--json-out PATH]

At the decode shape of the two serving paths (4 lanes at positions 5, 17,
40 and 100, max_len 128, or 256 for 256-token blocks) it launches the FMA
route — `paged_attention_mla_kernel` on deepseek-v2-lite-16b's latent
pools (16 heads, 512 + 64) in f32 at 16-, 128- and 256-token blocks and in
bf16 at 8- and 128-token blocks, `paged_attention_kernel` on
qwen1.5-0.5b's K / V (16 KV heads x 64) in f32 at 16-token blocks — at
every piece P (a power of two dividing the block, 4-32), kv_splits in {1,
2, 4, 8, 16, one run a piece} and G in {1, 2}, and prints the time per
call of the kernel and its merge: CUDA events around the replay of a
CUDA graph of 40 calls whose inputs rotate through copies larger than the
L2 cache (a call takes a few microseconds, about the host's cost of
issuing one from Python).  Each configuration's output is held against
`kernels.ref.paged_attn_ref` (f32 2e-4, bf16 2e-2), and the planned one
is marked.  `--ablate` instead builds copies of the kernel source with
q . k, p . v or the piece copies compiled out (`build.build_variants`) and
times each beside the full kernel at the planned split and at kv_splits 1
(one CTA a lane walks all its live pieces).  Without CUDA, or outside a
checkout of the repo, it exits 2.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

POSITIONS = [5, 17, 40, 100]
ABLATIONS = {
    "no_qk": [("paged_attention.cu",
               "for (int ch = ks; ch < nch; ch += NKS) {",
               "for (int ch = ks; ch < 0; ch += NKS) {")],
    "no_pv": [("paged_attention.cu", "for (int t = 0; t < a.P; ++t) {",
               "for (int t = 0; t < 0; ++t) {")],
    "no_copy": [("paged_attention.cu",
                 "    gpp::copy_rows_vec(a.vec, kd, RB, lo, hi,",
                 "    if (false) gpp::copy_rows_vec(a.vec, kd, RB, lo, hi,"),
                ("paged_attention.cu",
                 "    gpp::copy_rows_vec(a.vec, MLA ? kd + a.da_p * ES",
                 "    if (false) gpp::copy_rows_vec(a.vec, MLA ? kd + "
                 "a.da_p * ES")],
}
# (name, form, dtype, block size)
CASES = [("mla f32 16", "mla", "float32", 16),
         ("mla f32 128", "mla", "float32", 128),
         ("mla f32 256", "mla", "float32", 256),
         ("mla bf16 8", "mla", "bfloat16", 8),
         ("mla bf16 128", "mla", "bfloat16", 128),
         ("gqa f32 16", "gqa", "float32", 16)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fma_attn_sweep: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("fma_attn_sweep: run it from a checkout of the repo",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import schedule as sched
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attn_ref

    resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    build.build_all(("paged_attention",))
    libs = {"full": build.load("paged_attention")}
    if args.ablate:
        for tag, path in build.build_variants("paged_attention",
                                              ABLATIONS).items():
            libs[tag] = ctypes.CDLL(str(path))
    rows = []
    for name, form, dtype, bs in CASES:
        mb = max(cs.MAX_LEN, bs) // bs
        nb = cs.SLOTS * mb + 1
        if form == "mla":
            kvh, width, rope = 1, cs.DS_R, cs.DS_RR
            make = lambda seed: cs.mla_inputs(cs.SLOTS, 1, POSITIONS, dtype,
                                              nb=nb, seed=seed, bs=bs)
        else:
            kvh, width, rope = cs.H, cs.HD, 0
            make = lambda seed: cs.pa_inputs(cs.SLOTS, 1, POSITIONS, dtype,
                                             nb=nb, seed=seed)
        q, a, b, tables, pos = make(0)
        es = a.element_size()
        n = cs.copies_for(a.numel() * es + b.numel() * es)
        sets = [make(i) for i in range(n)]
        scale = 1.0 / (width + rope) ** 0.5
        kw = dict(num_kv_heads=kvh, scale=scale, mla=form == "mla")
        ref = paged_attn_ref(q, a, b, tables, pos, **kw)
        tol = 2e-4 if dtype == "float32" else 2e-2
        H = q.shape[2]
        q_sets = [(pa._q_rows(q_, scale, kvh, q_.dtype), a_, b_, t_, p_)
                  for q_, a_, b_, t_, p_ in sets]

        def plan_of(**pins):
            return sched.plan_paged_attn_fma_sm90(
                batch=cs.SLOTS, kv_heads=kvh, rows=H // kvh, block_size=bs,
                max_blocks=mb, width=width, rope=rope, mla=form == "mla",
                kv_itemsize=es, **pins)

        planned = plan_of()
        print(f"{name}: planned P={planned.piece} kv_splits="
              f"{planned.kv_splits} G={planned.num_bufs} grid="
              f"{planned.grid}", flush=True)
        if args.ablate:
            for ks in sorted({planned.kv_splits, 1}):
                p = plan_of(kv_splits=ks)
                for tag, lib in libs.items():
                    build._LIBS["paged_attention"] = lib   # pa._lib() types
                    ms = cs.graph_ms(
                        lambda q2, a_, b_, t_, p_, p=p: pa._launch_fma(
                            q2, a_, b_, t_, p_, p, S=1, window=None),
                        q_sets, iters=40)
                    rows.append({"case": name, "variant": tag,
                                 "piece": p.piece, "kv_splits": ks,
                                 "G": p.num_bufs, "ms": ms})
                    print(f"  {tag:8s} P={p.piece} kv_splits={ks} G="
                          f"{p.num_bufs} ms={ms:.4f}", flush=True)
            build._LIBS["paged_attention"] = libs["full"]
            del sets, q_sets
            torch.cuda.empty_cache()
            continue
        times = {}
        for P in [p for p in (4, 8, 16, 32) if bs % p == 0]:
            pieces = mb * bs // P
            for ks in sorted({k for k in (1, 2, 4, 8, 16, pieces)
                              if k <= pieces}):
                for G in (1, 2):
                    try:
                        p = plan_of(piece=P, kv_splits=ks, num_bufs=G)
                    except ValueError:
                        continue            # the ring does not fit

                    def call(q2, a_, b_, t_, p_, p=p):
                        return pa._launch_fma(q2, a_, b_, t_, p_, p, S=1,
                                              window=None)

                    out = call(*q_sets[0])
                    out = out.reshape(cs.SLOTS, kvh, H // kvh, 1, width) \
                        .permute(0, 3, 1, 2, 4).reshape(ref.shape)
                    err = float((out.float() - ref.float()).abs().max())
                    if err > tol:
                        raise AssertionError(f"{name} P={P} ks={ks} G={G}: "
                                             f"err {err}")
                    ms = cs.graph_ms(call, q_sets, iters=40)
                    key = (P, ks, G)
                    is_plan = key == (planned.piece, planned.kv_splits,
                                      planned.num_bufs)
                    times[key] = ms
                    rows.append({"case": name, "piece": P, "kv_splits": ks,
                                 "G": G, "ctas": p.ctas, "ms": ms,
                                 "max_abs_err": err, "planned": is_plan})
                    print(f"  P={P} kv_splits={ks} G={G} ctas={p.ctas} "
                          f"ms={ms:.4f} err={err:.3g}"
                          + (" (planned)" if is_plan else ""), flush=True)
        key = (planned.piece, planned.kv_splits, planned.num_bufs)
        best = min(times, key=times.get)
        print(f"  planned {key} {times.get(key, float('nan')):.4f} ms, "
              f"best {best} {times[best]:.4f} ms", flush=True)
        del sets, q_sets
        torch.cuda.empty_cache()
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
