#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--json-out PATH]

In order, it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per source, started together) and prints the build seconds;
  3. holds each kernel against its plain PyTorch version on the card, at
     every shape the two serving paths give it (gpp_matmul at both models'
     projection shapes: bf16 x and W on its tensor-core kernel, with G in
     {None, 1, 2, 3, 4} and the FMA kernel pinned beside it, deepseek's f32
     router on the FMA kernel; gpp_matmul_grouped on both routes, bf16 x
     and W on its tensor-core kernel, f32 and int8 on its FMA kernel), and
     prints the largest error beside its tolerance, then the kernel's
     time (for bf16 gpp_matmul also the pinned FMA kernel's), the plain
     version's time, a library yardstick's time (`torch.matmul` /
     `torch.bmm`; `scaled_dot_product_attention` on gathered K/V or latent
     rows) and the bound (the larger of bytes / 3.35e12 B/s and operations
     / the peak rate of their type); it checks that the tensor-core
     gpp_matmul repeats bit for bit, reads the issue-order records of
     gpp_matmul (FMA: one tile's k-steps; tensor cores: CTA 0's run across
     a tile boundary and a k-split) and gpp_matmul_grouped back (the
     tensor-core route at deepseek's decode shape, across n-tiles, and at
     one n-tile an expert, across experts; the FMA route at the decode
     shape in f32, 5 experts a CTA) and compares them with
     `chunk_issue_schedule` for G in {1, 2, 4} (3 too on the tensor-core
     gpp_matmul) and the planned G, checks that the card holds the CTAs an
     SM the tensor-core plans assume, and runs one full-width deepseek MoE
     layer in bf16 with the kernels against the plain versions (decode and
     prefill inputs, relative error <= 1e-2); MLA paged attention runs its
     tensor-core kernel in bf16 (split-KV, kv_splits planned, 1, 2, 8) and
     its FMA kernel in f32, is timed in both at decode (bf16 also at
     prefill and verify, and by CUDA events over a CUDA graph of launches),
     and the tensor-core kernel's issue-order record and occupancy are
     checked; bf16 MLA at 8- and 128-token blocks (the FMA kernel's bf16
     instance) is held against the plain version at the three shapes and
     timed at decode;
  4. serves full-width qwen1.5-0.5b (random weights from a seed) through
     `repro_torch.serving.ServingEngine`: a warm-up run on random prompts,
     whose greedy continuations are then appended to the prompts (so the
     n-gram drafter finds drafts), bf16 with speculation off and on (tok/s,
     launch counts, which must be > 0 for the path's kernels and 0 for the
     others: bf16 projections on the tensor-core gpp_matmul, the FMA one
     only for deepseek's f32 router, one a MoE layer), one profiled run
     (device time by kernel, again only under the path's kernels, busy
     share, the time under gpp_matmul), then float32 with the kernels and
     with their plain versions, whose greedy streams must be equal;
  5. the same for deepseek-v2-lite-16b (MLA + MoE) at full width and full
     depth in bf16 (~31 GB of weights); its float32 kernel-vs-plain stream
     check runs at full width with 4 of its 27 layers (1 dense + 3 MoE),
     since full depth in f32 is 62.8 GB of weights; then, at 4 layers, it
     serves bf16 with 8- and 128-token KV blocks (the FMA MLA kernel's
     bf16 instance, counted on its own) and f32 with 8-token blocks, whose
     greedy streams must equal the plain run's;
  6. prints {"kernels": [...]} and, last, the device line.

Any failed check raises, so the exit code is not 0.  Without CUDA, or
outside a checkout of the repo (no `src/repro_torch` beside it), it exits
with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

H100_HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, per type
L2_BYTES = 50 * 1024 * 1024
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}   # (atol, rtol)

D, F, H, HD = 1024, 2816, 16, 64      # qwen1.5-0.5b widths
DS_D, DS_F, DS_E, DS_H = 2048, 1408, 64, 16      # deepseek-v2-lite widths
DS_R, DS_RR, DS_NOPE, DS_F0 = 512, 64, 128, 10944  # kv_lora, rope, layer 0
SLOTS, MAX_LEN, BS, CHUNK, DRAFT = 4, 128, 16, 32, 4
PHASE_M = {"decode": SLOTS, "prefill": CHUNK, "verify": SLOTS * (DRAFT + 1)}
BOTH = ("bfloat16", "float32")
# gpp_matmul's (K, N, dtypes) on each serving path.  deepseek: MLA q, the
# kv down-projection (latent + rope), o; the router, f32 in every model
# dtype; the 2 shared experts (2 x 1408 wide); layer 0's dense MLP.
GPP_SHAPES = {
    "qwen1.5-0.5b": {"qkvo": (D, D, BOTH), "gate_up": (D, F, BOTH),
                     "down": (F, D, BOTH)},
    "deepseek-v2-lite-16b": {
        "q": (DS_D, DS_H * (DS_NOPE + DS_RR), BOTH),
        "dkv": (DS_D, DS_R + DS_RR, BOTH),
        "o": (DS_H * DS_NOPE, DS_D, BOTH),
        "router": (DS_D, DS_E, ("float32",)),
        "shared_gate_up": (DS_D, 2 * DS_F, BOTH),
        "shared_down": (2 * DS_F, DS_D, BOTH),
        "dense_gate_up": (DS_D, DS_F0, BOTH),
        "dense_down": (DS_F0, DS_D, BOTH)},
}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, argsets, iters: int = 100) -> float:
    """Mean ms per call, cycling through `argsets` (distinct buffers whose
    total exceeds the L2 cache, so each call finds its inputs cold, as a
    layer of the real path does)."""
    import torch
    for a in argsets:
        fn(*a)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, argsets, name=None, iters: int = 50):
    """Device time per call: the summed duration of the kernels the calls
    ran (only those whose name contains `name`, or one of the names of a
    tuple, if given), from a torch.profiler (CUPTI) trace.  None when the
    trace holds no device events; the caller then keeps the CUDA-event
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
        torch.cuda.synchronize()
    names = (name,) if isinstance(name, str) else name
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (names is None or any(n in e.name for n in names)))
    return us / iters / 1e3 if us > 0 else None


def measure(fn, argsets, name=None) -> "tuple[float, float]":
    """(device ms, wall ms) per call.  The wall time (CUDA events around
    back-to-back calls) includes the host's launch cost where that is the
    larger; the device time is what the card spent."""
    wall = time_ms(fn, argsets)
    dev = device_ms(fn, argsets, name)
    return (dev if dev is not None else wall), wall


def graph_ms(fn, argsets, iters: int = 50) -> float:
    """Mean ms per call from CUDA events around the replay of a CUDA graph
    of `iters` calls: the card's time for the calls and the gaps between
    them, without the host's launch cost (which, for a kernel of a few
    microseconds, is what back-to-back calls from Python measure)."""
    import torch
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):       # warm-up: attributes, scratch
        for a in argsets:
            fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
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


def copies_for(nbytes: int) -> int:
    return max(1, min(64, math.ceil(2 * L2_BYTES / max(1, nbytes))))


def bound(nbytes: float, ops: float, dtype: str) -> "tuple[float, str]":
    t_b = nbytes / H100_HBM_BYTES_PER_S
    t_o = ops / PEAK_OPS[dtype]
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------
# kernel 1: gpp_matmul
# ---------------------------------------------------------------------------

def gpp_case(M, K, N, dtype, *, act=None, bias=False, w_int8=False, G=None,
             route=None, seed=0):
    """One gpp_matmul comparison on the card; returns the max abs error.
    bf16 x and W must launch the tensor-core kernel (unless `route` pins
    the FMA one), anything else the FMA kernel."""
    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import dense_ref
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda").to(dt)
    if w_int8:
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        scale = torch.rand(N, generator=g, device="cuda") * 2e-3
    else:
        w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).to(dt)
        scale = None
    b = (torch.randn(N, generator=g, device="cuda") * 0.1).to(dt) \
        if bias else None
    want = route or gm.gpp_route(x.dtype, w.dtype)
    before = (gm.launches_tc.n, gm.launches.n)
    y = gm.gpp_matmul(x, w, bias=b, w_scale=scale, activation=act,
                      num_bufs=G, route=route)
    ran = (gm.launches_tc.n - before[0], gm.launches.n - before[1])
    check(ran == ((1, 0) if want == "tc" else (0, 1)),
          f"gpp_matmul {dtype} x {w.dtype} W took the wrong kernel {ran}")
    ref = dense_ref(x, w, bias=b, w_scale=scale, activation=act)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs()
    atol, rtol = TOL[dtype]
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    check(bool(torch.isfinite(y.float()).all()), "gpp_matmul non-finite")
    check(ok, f"gpp_matmul {M}x{K}x{N} {dtype} act={act} bias={bias} "
              f"int8={w_int8} G={G} route={want}: max err "
              f"{float(err.max())}")
    return float(err.max())


def gpp_time(M, K, N, dtype):
    """Kernel / plain / torch.matmul times of an (M,K)@(K,N) product with
    no bias or activation (the up projection), and its bound.  bf16 times
    the tensor-core route and, in the same call, the FMA route pinned;
    f32 the FMA route."""
    import torch
    from repro_torch.kernels.gpp_matmul import gpp_matmul
    from repro_torch.kernels.ref import dense_ref
    dt = getattr(torch, dtype)
    es = torch.tensor([], dtype=dt).element_size()
    n = copies_for(K * N * es)
    g = torch.Generator(device="cuda").manual_seed(1)
    sets = [((torch.randn(M, K, generator=g, device="cuda")).to(dt),
             (torch.randn(K, N, generator=g, device="cuda") * 0.02).to(dt))
            for _ in range(n)]
    out = {}
    if dtype == "bfloat16":
        out["ms"], out["wall_ms"] = measure(
            lambda x, w: gpp_matmul(x, w), sets,
            KERNEL_NAMES["gpp_matmul_tc"])
        out["fma_ms"], out["fma_wall_ms"] = measure(
            lambda x, w: gpp_matmul(x, w, route="fma"), sets,
            KERNEL_NAMES["gpp_matmul"])
    else:
        out["ms"], out["wall_ms"] = measure(
            lambda x, w: gpp_matmul(x, w), sets, KERNEL_NAMES["gpp_matmul"])
    out["plain_ms"], out["plain_wall_ms"] = measure(
        lambda x, w: dense_ref(x, w), sets)
    out["library_ms"], out["library_wall_ms"] = measure(
        lambda x, w: torch.matmul(x, w), sets)
    out["bound_ms"], out["bound_by"] = bound((M * K + K * N + M * N) * es,
                                             2.0 * M * K * N, dtype)
    return out


def check_gpp(report):
    import torch
    from repro_torch.core.schedule import plan_matmul_tc_sm90
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import ACTIVATION_IDS, chunk_issue_schedule
    rows = []
    for path, shapes in GPP_SHAPES.items():
        for phase, M in PHASE_M.items():
            for name, (K, N, dtypes) in shapes.items():
                for dtype in dtypes:
                    bf16 = dtype == "bfloat16"
                    err = max(gpp_case(M, K, N, dtype, G=G)
                              for G in ((None, 1, 2, 3, 4) if bf16
                                        else (None, 1, 2, 4)))
                    row = {"path": path, "phase": phase, "proj": name,
                           "M": M, "K": K, "N": N, "dtype": dtype,
                           "max_abs_err": err, "tol": TOL[dtype],
                           "route": "tc" if bf16 else "fma"}
                    if bf16:    # the FMA route still takes bf16 (pinned)
                        row["fma_max_abs_err"] = gpp_case(M, K, N, dtype,
                                                          route="fma")
                        plan = plan_matmul_tc_sm90(M, K, N)
                        row["plan"] = {
                            "block_m": plan.block_m,
                            "block_k": plan.block_k,
                            "num_bufs": plan.num_bufs, "grid": plan.grid,
                            "max_segs": plan.max_segs}
                        row["ctas_per_sm"] = gm.tc_ctas_per_sm(plan)
                        check(row["ctas_per_sm"] == plan.ctas_per_sm,
                              f"gpp_matmul_tc {M}x{K}x{N}: the card holds "
                              f"{row['ctas_per_sm']} CTAs an SM, planned "
                              f"{plan.ctas_per_sm}")
                    if dtype == dtypes[0]:       # the path's own dtype
                        row.update(gpp_time(M, K, N, dtype))
                    rows.append(row)
                    print(f"gpp_matmul {path} {phase:7s} {name:14s} "
                          f"{M}x{K}x{N} {dtype} ({row['route']}): "
                          f"max_abs_err={err:.3g} (atol,rtol)={TOL[dtype]}"
                          + (f" ms={row['ms']:.4f}"
                             + (f" fma_ms={row['fma_ms']:.4f}" if bf16
                                else "")
                             + f" plain_ms={row['plain_ms']:.4f} library_ms="
                             f"{row['library_ms']:.4f} bound_ms="
                             f"{row['bound_ms']:.4f} ({row['bound_by']})"
                             f" wall_ms={row['wall_ms']:.4f}"
                             if "ms" in row else "")
                          + (f" plan={row['plan']}" if bf16 else ""),
                          flush=True)
    # epilogue variants at the paths' projection shapes, by route (bf16 x
    # and W: tensor cores; f32, or int8 W: FMA)
    extra = {"tc": [], "fma": []}
    for act in ACTIVATION_IDS:
        if act is None:
            continue
        for dtype in BOTH:
            r = "tc" if dtype == "bfloat16" else "fma"
            extra[r].append(gpp_case(SLOTS, D, F, dtype, act=act, bias=True))
            extra[r].append(gpp_case(CHUNK, DS_F0, DS_D, dtype, act=act,
                                     bias=True))
    for dtype in BOTH:
        r = "tc" if dtype == "bfloat16" else "fma"
        extra[r].append(gpp_case(SLOTS, DS_D, DS_F0, dtype, act="silu"))
        extra["fma"].append(gpp_case(CHUNK, D, D, dtype, w_int8=True,
                                     act="silu"))
        extra["fma"].append(gpp_case(SLOTS, F, D, dtype, w_int8=True, G=1))
        # ragged M/K/N: 2002-byte bf16 rows take the narrower copies
        extra[r].append(gpp_case(7, 1000, 1001, dtype, bias=True,
                                 act="gelu"))
        extra[r].append(gpp_case(37, 333, 130, dtype, G=4))
        extra[r].append(gpp_case(200, 1000, 1001, dtype, G=3, act="tanh"))
    print("gpp_matmul epilogue/int8/ragged cases: "
          + ", ".join(f"{r} {len(v)} ok, max_abs_err={max(v):.3g}"
                      for r, v in extra.items()))
    # split tiles are summed in a fixed order: bf16 repeats bit for bit
    g = torch.Generator(device="cuda").manual_seed(9)
    for M, K, N in ((SLOTS, F, D), (CHUNK, DS_F0, DS_D)):
        x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).bfloat16()
        first = gm.gpp_matmul(x, w, activation="silu")
        check(all(torch.equal(gm.gpp_matmul(x, w, activation="silu"), first)
                  for _ in range(3)),
              f"gpp_matmul_tc {M}x{K}x{N} is not bitwise repeatable")
    print("gpp_matmul_tc bitwise repeatable over 4 runs at "
          f"{SLOTS}x{F}x{D} and {CHUNK}x{DS_F0}x{DS_D}")
    # the generalized ping-pong issue order survived the port: the FMA
    # route (pinned) at one tile's k-steps, the tensor-core route over CTA
    # 0's run across a tile boundary (5 CTAs pinned) and a k-split (layer
    # 0's down projection as planned)
    orders = 0
    x = torch.randn(SLOTS, D, device="cuda").bfloat16()
    w = (torch.randn(D, D, device="cuda") * 0.02).bfloat16()
    for G in (1, 2, 4):
        got, num_k, g_used, C = gm.issue_order(x, w, G, route="fma")
        check(g_used == G, f"ring depth {g_used} != {G}")
        check(got == chunk_issue_schedule(num_k, G, C),
              f"fma issue order differs at G={G}")
        orders += 1
        print(f"gpp_matmul (fma) issue order G={G} C={C} steps={num_k}: "
              f"{sum(len(v) for v in got.values())} chunk issues == "
              "chunk_issue_schedule")
    for (M, K, N), grid in (((SLOTS, 2048, 1024), 5),
                            ((SLOTS, DS_F0, DS_D), None)):
        x = torch.randn(M, K, device="cuda").bfloat16()
        w = (torch.randn(K, N, device="cuda") * 0.02).bfloat16()
        for G in (None, 1, 2, 3, 4):
            got, steps, g_used, C = gm.issue_order(x, w, G, grid=grid)
            plan = plan_matmul_tc_sm90(M, K, N, num_bufs=G, grid=grid)
            tiles = {plan.unit(u)[0] for u in plan.cta_units(0)}
            check(steps >= 5 and len(plan.segments(max(tiles))) > 1
                  and len(tiles) == (2 if grid else 1),
                  "the tc record's run crosses no tile or split boundary")
            check(G is None or g_used == G, f"ring depth {g_used} != {G}")
            check(got == chunk_issue_schedule(steps, g_used, C),
                  f"tc issue order differs at {M}x{K}x{N} G={G}")
            orders += 1
            print(f"gpp_matmul_tc issue order {M}x{K}x{N} grid={plan.grid} "
                  f"G={g_used} (asked {G}) C={C} steps={steps} over tiles "
                  f"{sorted(tiles)}: {sum(len(v) for v in got.values())} "
                  "chunk issues == chunk_issue_schedule")
    err = {r: max(v + [row["max_abs_err"] for row in rows
                       if row["route"] == r]) for r, v in extra.items()}
    report["gpp_matmul"] = {"shapes": rows,
                            "extra_cases": sum(map(len, extra.values())),
                            "max_abs_err_by_route": err,
                            "issue_orders": orders}
    return rows, err


# ---------------------------------------------------------------------------
# kernel 2: paged attention
# ---------------------------------------------------------------------------

def pa_inputs(B, S, positions, dtype, *, nb, seed=0):
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    mb = MAX_LEN // BS
    q = torch.randn(B, S, H, HD, generator=g, device="cuda").to(dt)
    k = (torch.randn(nb, BS, H, HD, generator=g, device="cuda") * 0.5).to(dt)
    v = (torch.randn(nb, BS, H, HD, generator=g, device="cuda") * 0.5).to(dt)
    perm = torch.randperm(nb - 1, generator=g, device="cuda") + 1
    tables = torch.zeros(B, mb, dtype=torch.int32, device="cuda")
    used = 0
    for b, p in enumerate(positions):
        nblk = (p + S - 1) // BS + 1
        tables[b, :nblk] = perm[used:used + nblk].int()
        used += nblk
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, k, v, tables, pos


def pa_work(positions, S, window, es):
    """(bytes, operations) this call's data needs: each visible K/V row
    read once, q / tables / positions read and the output written once;
    2 * hd operations per (query row, visible key) for q.k and again for
    p.v."""
    keys = set()
    pairs = 0
    for b, p in enumerate(positions):
        for s in range(S):
            lo = 0 if window is None else max(0, p + s - window + 1)
            pairs += p + s - lo + 1
            keys.update((b, t) for t in range(lo, p + s + 1))
    B = len(positions)
    nbytes = (2 * len(keys) * H * HD * es + 2 * B * S * H * HD * es
              + B * (MAX_LEN // BS) * 4 + B * 4)
    return nbytes, 4.0 * pairs * H * HD


def pa_case(name, B, S, positions, dtype, *, window=None, timed=False):
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.ref import paged_attn_ref
    nb = SLOTS * (MAX_LEN // BS) + 1
    q, k, v, tables, pos = pa_inputs(B, S, positions, dtype, nb=nb)
    kw = dict(num_kv_heads=H, scale=1.0 / math.sqrt(HD), window=window)
    ref = paged_attn_ref(q, k, v, tables, pos, **kw)
    errs = []
    for G in (None, 1, 2, 4):
        out = paged_attention(q, k, v, tables, pos, num_bufs=G, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()), f"{name}: non-finite")
        errs.append(float((out.float() - ref.float()).abs().max()))
    err = max(errs)
    atol, _ = TOL[dtype]
    check(err <= atol, f"paged_attention {name} {dtype}: max err {err}")
    row = {"case": name, "B": B, "S": S, "positions": positions,
           "window": window, "dtype": dtype, "max_abs_err": err,
           "tol": atol}
    if timed:
        es = q.element_size()
        n = copies_for(2 * k.numel() * es)
        sets = [pa_inputs(B, S, positions, dtype, nb=nb, seed=i)
                for i in range(n)]
        row["ms"], row["wall_ms"] = measure(
            lambda q, k, v, t, p: paged_attention(q, k, v, t, p, **kw), sets,
            "paged_attention_kernel")
        row["plain_ms"], row["plain_wall_ms"] = measure(
            lambda q, k, v, t, p: paged_attn_ref(q, k, v, t, p, **kw), sets)
        # yardstick: SDPA over K/V gathered through the tables beforehand
        T = MAX_LEN
        kpos = torch.arange(T, device="cuda")
        lib_sets = []
        for q_, k_, v_, t_, p_ in sets:
            kseq = k_[t_.long()].reshape(B, T, H, HD).transpose(1, 2)
            vseq = v_[t_.long()].reshape(B, T, H, HD).transpose(1, 2)
            qpos = p_.long()[:, None] + torch.arange(S, device="cuda")[None]
            m = kpos[None, None, :] <= qpos[:, :, None]
            if window is not None:
                m &= kpos[None, None, :] > qpos[:, :, None] - window
            lib_sets.append((q_.transpose(1, 2), kseq, vseq, m[:, None]))
        row["library_ms"], row["library_wall_ms"] = measure(
            lambda q, k, v, m: Fn.scaled_dot_product_attention(
                q, k, v, attn_mask=m, scale=kw["scale"]), lib_sets)
        nbytes, ops = pa_work(positions, S, window, es)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dtype)
    print(f"paged_attention {name:14s} {dtype}: max_abs_err={err:.3g} "
          f"atol={atol}" + (
              f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms="
              f"{row['bound_ms']:.5f} ({row['bound_by']}) "
              f"wall_ms={row['wall_ms']:.4f}"
              if timed else ""))
    return row


def check_paged(report):
    cases = [
        ("decode", SLOTS, 1, [5, 17, 40, 100]),
        ("prefill", 1, CHUNK, [37]),             # unaligned chunk start
        ("verify", SLOTS, DRAFT + 1, [3, 30, 64, 90]),
    ]
    rows = []
    for name, B, S, positions in cases:
        for dtype in ("bfloat16", "float32"):
            rows.append(pa_case(name, B, S, positions, dtype,
                                timed=dtype == "bfloat16"))
        rows.append(pa_case(name + "+window", B, S, positions, "bfloat16",
                            window=32))
    report["paged_attention"] = {"shapes": rows}
    return rows


# ---------------------------------------------------------------------------
# kernel 2: gpp_matmul_grouped (deepseek-v2-lite-16b routed experts)
# ---------------------------------------------------------------------------

# rows per expert = dispatch groups x capacity (models.moe) at each phase
DS_ROWS = {"decode": 32, "prefill": 128, "verify": 32}
DS_PROJ = {"gate_up": (DS_D, DS_F), "down": (DS_F, DS_D)}


def grouped_inputs(M, K, N, dtype, *, seed=0, int8=False):
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(DS_E, M, K, generator=g, device="cuda").to(dt)
    if int8:
        w = torch.randint(-127, 128, (DS_E, K, N), generator=g,
                          device="cuda", dtype=torch.int8)
    else:
        w = (torch.randn(DS_E, K, N, generator=g, device="cuda")
             * 0.02).to(dt)
    return x, w


def grouped_case(M, K, N, dtype, *, G=None, act=None, bias=False,
                 scale=None, seed=0):
    """One gpp_matmul_grouped comparison on the card; max abs error.  bf16
    x and W must launch the tensor-core kernel, anything else the FMA
    kernel."""
    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import dense_grouped_ref
    x, w = grouped_inputs(M, K, N, dtype, seed=seed, int8=scale is not None)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    sc = None
    if scale is not None:
        shape = {"scalar": (), "expert": (DS_E,), "column": (DS_E, N)}[scale]
        sc = torch.rand(shape, generator=g, device="cuda") * 2e-3
    b = (torch.randn(DS_E, N, generator=g, device="cuda") * 0.1).to(x.dtype) \
        if bias else None
    route = gm.grouped_route(x.dtype, w.dtype)
    before = (gm.launches_grouped_tc.n, gm.launches_grouped.n)
    y = gm.gpp_matmul_grouped(x, w, bias=b, w_scale=sc, activation=act,
                              num_bufs=G)
    ran = (gm.launches_grouped_tc.n - before[0],
           gm.launches_grouped.n - before[1])
    check(ran == ((1, 0) if route == "tc" else (0, 1)),
          f"gpp_matmul_grouped {dtype} x {w.dtype} W took the wrong kernel")
    ref = dense_grouped_ref(x, w, bias=b, w_scale=sc, activation=act)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y.float()).all()), "gpp_matmul_grouped "
          "non-finite")
    err = (y.float() - ref.float()).abs()
    atol, rtol = TOL[dtype]
    check(bool((err <= atol + rtol * ref.float().abs()).all()),
          f"gpp_matmul_grouped {DS_E}x{M}x{K}x{N} {dtype} G={G} act={act} "
          f"scale={scale}: max err {float(err.max())}")
    return float(err.max())


def grouped_time(M, K, N, dtype):
    """Kernel / plain / torch.bmm times of one (E, M, K) @ (E, K, N) launch
    at the path's shape, and its bound (every expert's W read once).  bf16
    times the tensor-core kernel, f32 the FMA kernel."""
    import torch
    from repro_torch.kernels.gpp_matmul import gpp_matmul_grouped
    from repro_torch.kernels.ref import dense_grouped_ref
    es = 2 if dtype == "bfloat16" else 4
    sets = [grouped_inputs(M, K, N, dtype, seed=i)
            for i in range(copies_for(DS_E * K * N * es))]
    name = KERNEL_NAMES["gpp_matmul_grouped_tc" if dtype == "bfloat16"
                        else "gpp_matmul_grouped"]
    ms, wall = measure(lambda x, w: gpp_matmul_grouped(x, w), sets, name)
    plain, plain_wall = measure(lambda x, w: dense_grouped_ref(x, w), sets)
    lib, lib_wall = measure(lambda x, w: torch.bmm(x, w), sets)
    b_ms, by = bound(DS_E * (M * K + K * N + M * N) * es,
                     2.0 * DS_E * M * K * N, dtype)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": by, "wall_ms": wall, "plain_wall_ms": plain_wall,
            "library_wall_ms": lib_wall, "kernel": name}


def grouped_issue_order(x, w, G, what):
    """Read the first CTA's issue-order record back and compare it with
    `chunk_issue_schedule`; returns (G used, work items in the run)."""
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import chunk_issue_schedule
    got, steps, g_used, C, items = gm.issue_order_grouped(x, w, G)
    check(G is None or g_used == G, f"{what}: ring depth {g_used} != {G}")
    check(items > 1, f"{what}: the first CTA's run holds {items} item(s)")
    check(got == chunk_issue_schedule(steps, g_used, C),
          f"{what}: issue order differs at G={G}")
    print(f"gpp_matmul_grouped issue order {what} G={g_used} (asked {G}) "
          f"C={C} steps={steps} over {items} work items: "
          f"{sum(len(v) for v in got.values())} chunk issues == "
          "chunk_issue_schedule")
    return g_used, items


def check_grouped(report):
    import torch
    from repro_torch.core.schedule import plan_grouped_tc_sm90
    from repro_torch.kernels import gpp_matmul as gm
    rows = []
    timed = {}
    for phase, M in DS_ROWS.items():
        for name, (K, N) in DS_PROJ.items():
            for dtype in ("bfloat16", "float32"):
                err = max(grouped_case(M, K, N, dtype, G=G,
                                       act="silu" if name == "gate_up"
                                       else None)
                          for G in (None, 1, 2, 4))
                row = {"phase": phase, "proj": name, "E": DS_E, "M": M,
                       "K": K, "N": N, "dtype": dtype, "max_abs_err": err,
                       "tol": TOL[dtype],
                       "route": "tc" if dtype == "bfloat16" else "fma"}
                key = (M, K, N, dtype)       # verify's shape is decode's
                if dtype == "bfloat16" or (phase, name) == ("decode",
                                                            "gate_up"):
                    if key not in timed:
                        timed[key] = grouped_time(M, K, N, dtype)
                    row.update(timed[key])
                if dtype == "bfloat16":      # the card holds the plan
                    plan = plan_grouped_tc_sm90(DS_E, M, K, N)
                    row["ctas_per_sm"] = gm.grouped_tc_ctas_per_sm(plan)
                    check(row["ctas_per_sm"] == plan.ctas_per_sm,
                          f"{row['ctas_per_sm']} CTAs an SM, planned "
                          f"{plan.ctas_per_sm}")
                    row["plan"] = {"block_m": plan.block_m,
                                   "block_k": plan.block_k,
                                   "num_bufs": plan.num_bufs,
                                   "grid": plan.grid}
                rows.append(row)
                print(f"gpp_matmul_grouped {phase:7s} {name:7s} "
                      f"{DS_E}x{M}x{K}x{N} {dtype} ({row['route']}): "
                      f"max_abs_err={err:.3g} (atol,rtol)={TOL[dtype]}"
                      + (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f}"
                         f" library_ms={row['library_ms']:.4f} bound_ms="
                         f"{row['bound_ms']:.4f} ({row['bound_by']})"
                         f" wall_ms={row['wall_ms']:.4f}"
                         if "ms" in row else "")
                      + (f" plan={row['plan']} ctas/SM="
                         f"{row['ctas_per_sm']}" if "plan" in row else ""))
    extra = {"tc": [], "fma": []}
    for dtype in ("bfloat16", "float32"):      # int8 W: the FMA route
        for scale in ("scalar", "expert", "column"):
            extra["fma"].append(grouped_case(DS_ROWS["decode"], DS_D, DS_F,
                                             dtype, scale=scale, act="silu"))
    for G in (None, 1, 2, 4):                  # ragged M, K, N
        extra["tc"].append(grouped_case(7, 300, 130, "bfloat16", bias=True,
                                        act="gelu", G=G))
    extra["fma"].append(grouped_case(7, 300, 130, "float32", bias=True,
                                     act="gelu", G=4))
    print("gpp_matmul_grouped int8/bias/ragged cases: "
          + ", ".join(f"{r} {len(v)} ok, max_abs_err={max(v):.3g}"
                      for r, v in extra.items()))
    # the ring runs across work boundaries in the issue order of the
    # generalized ping-pong schedule: the tensor-core route at the path's
    # decode gate/up shape (n-tile boundaries) and at one n-tile an expert
    # (expert boundaries), the FMA route at the decode shape in f32
    orders = []
    x, w = grouped_inputs(DS_ROWS["decode"], DS_D, DS_F, "bfloat16")
    for G in (None, 1, 2, 4):
        orders.append(grouped_issue_order(x, w, G, "tc 64x32x2048x1408"))
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(600, 16, 512, generator=g, device="cuda").bfloat16()
    w = (torch.randn(600, 512, 64, generator=g, device="cuda")
         * 0.02).bfloat16()
    plan = plan_grouped_tc_sm90(600, 16, 512, 64)
    check([plan.unit(u)[0] for u in plan.cta_units(0)] == [0, 1],
          "the first CTA's run does not cross an expert boundary")
    for G in (None, 1, 2, 4):
        orders.append(grouped_issue_order(x, w, G, "tc 600x16x512x64"))
    x, w = grouped_inputs(DS_ROWS["decode"], DS_D, DS_F, "float32")
    for G in (None, 1, 2, 4):
        orders.append(grouped_issue_order(x, w, G, "fma f32 64x32x2048x1408"))
    del x, w
    torch.cuda.empty_cache()
    err = {r: max(v + [row["max_abs_err"] for row in rows
                       if row["route"] == r]) for r, v in extra.items()}
    report["gpp_matmul_grouped"] = {
        "shapes": rows, "extra_cases": sum(map(len, extra.values())),
        "max_abs_err_by_route": err, "issue_orders": len(orders)}
    return rows, err


def check_moe_layer(report):
    """One full-width deepseek-v2-lite-16b MoE layer in bf16 (random
    weights from a seed), decode inputs (4 tokens) and prefill inputs (32):
    mode "auto" (the routed experts on the tensor-core kernel) against mode
    "ref" (the plain versions), relative error of the layer's output."""
    import dataclasses

    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import init_from_specs
    cfg = registry.get_config("deepseek-v2-lite-16b").with_(dtype="bfloat16")
    mc = tf._moe_cfg(cfg)
    gen = torch.Generator(device="cuda").manual_seed(6)
    params = init_from_specs(moe_mod.moe_specs(mc), gen,
                             torch.device("cuda"))
    out = {}
    for phase, (B, S) in (("decode", (SLOTS, 1)), ("prefill", (1, CHUNK))):
        x = torch.randn(B, S, DS_D, generator=gen, device="cuda").bfloat16()
        tc = gm.launches_grouped_tc.n
        auto = moe_mod.moe_apply(params, mc, x)
        ran = gm.launches_grouped_tc.n - tc
        ref = moe_mod.moe_apply(
            params, dataclasses.replace(mc, dense_kernel="ref"), x)
        torch.cuda.synchronize()
        check(tuple(auto.shape) == (B, S, DS_D)
              and bool(torch.isfinite(auto.float()).all()),
              f"MoE layer {phase}: shape or non-finite")
        rel = float((auto.float() - ref.float()).norm()
                    / ref.float().norm())
        check(ran == 3, f"MoE layer {phase}: {ran} tensor-core launches")
        check(rel <= 1e-2, f"MoE layer {phase}: |auto - ref| / |ref| = "
                           f"{rel:.3g} > 1e-2")
        out[phase] = {"tokens": B * S, "rel_err": rel, "tc_launches": ran}
        print(f"MoE layer {phase} ({B * S} tokens, deepseek widths, bf16): "
              f"|auto - ref| / |ref| = {rel:.3g} (limit 1e-2), {ran} "
              "tensor-core launches")
    del params
    torch.cuda.empty_cache()
    report["moe_layer"] = out
    return out


# ---------------------------------------------------------------------------
# kernel 3b: MLA paged attention (deepseek-v2-lite-16b latent pools)
# ---------------------------------------------------------------------------

def mla_inputs(B, S, positions, dtype, *, nb, seed=0, bs=BS):
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    mb = MAX_LEN // bs
    q = torch.randn(B, S, DS_H, DS_R + DS_RR, generator=g,
                    device="cuda").to(dt)
    ckv = (torch.randn(nb, bs, DS_R, generator=g, device="cuda") * 0.5
           ).to(dt)
    kr = (torch.randn(nb, bs, DS_RR, generator=g, device="cuda") * 0.5
          ).to(dt)
    perm = torch.randperm(nb - 1, generator=g, device="cuda") + 1
    tables = torch.zeros(B, mb, dtype=torch.int32, device="cuda")
    used = 0
    for b, p in enumerate(positions):
        nblk = (p + S - 1) // bs + 1
        tables[b, :nblk] = perm[used:used + nblk].int()
        used += nblk
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, ckv, kr, tables, pos


def mla_work(positions, S, es, bs=BS):
    """(bytes, operations) this call's data needs: each visible latent row
    (c_kv + k_rope) read once, q / tables / positions read and the latent
    output written once; per (query row, visible key) 2 * 576 operations
    for q.k and 2 * 512 for p.v, for each of the 16 heads."""
    keys = set()
    pairs = 0
    for b, p in enumerate(positions):
        for s in range(S):
            pairs += p + s + 1
            keys.update((b, t) for t in range(p + s + 1))
    B = len(positions)
    nbytes = (len(keys) * (DS_R + DS_RR) * es
              + B * S * DS_H * (DS_R + DS_RR + DS_R) * es
              + B * (MAX_LEN // bs) * 4 + B * 4)
    return nbytes, 2.0 * pairs * DS_H * (DS_R + DS_RR + DS_R)


def mla_case(name, B, S, positions, dtype, *, timed=False, bs=BS):
    """One MLA comparison on the card, at every ring depth (and, on the
    tensor-core kernel, kv_splits planned, 1, 2 and 8): bf16 at `bs`-token
    blocks of 16-64 must launch the tensor-core kernel, bf16 at other
    block sizes the FMA kernel's bf16 instance, f32 the FMA kernel.
    `timed` adds the kernel's device time (its merge included), the plain
    version's, SDPA's on gathered rows, the bound and, on the tensor-core
    kernel, the CUDA-event time of a graph of launches."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.core.schedule import plan_paged_attn_mla_tc_sm90
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attn_ref
    mb = MAX_LEN // bs
    nb = SLOTS * mb + 1
    q, ckv, kr, tables, pos = mla_inputs(B, S, positions, dtype, nb=nb,
                                         bs=bs)
    kw = dict(num_kv_heads=1, scale=1.0 / math.sqrt(128 + DS_RR), mla=True)
    ref = paged_attn_ref(q, ckv, kr, tables, pos, **kw)
    route = pa.attention_route(q.dtype, True, bs, DS_R, DS_RR)
    tc = route == "mla_tc"
    counts = (pa.launches_mla_tc, pa.launches_mla, pa.launches_mla_bf16)
    want = (1, 0, 0) if tc else (0, 0, 1) if dtype == "bfloat16" \
        else (0, 1, 0)
    errs = []
    for G in ((None, 1, 2, 4) if bs == BS else (None, 1, 2)):
        for ks in ((None, 1, 2, mb) if tc else (None,)):
            before = [c.n for c in counts]
            out = pa.paged_attention(q, ckv, kr, tables, pos, num_bufs=G,
                                     kv_splits=ks, **kw)
            torch.cuda.synchronize()
            ran = tuple(c.n - n for c, n in zip(counts, before))
            check(ran == want, f"mla {name} {dtype} block {bs} took the "
                               f"wrong kernel: {ran}")
            if tc and ks is None and G is None:   # the partials' merge
                merge_err = mla_merge_case(q, ckv, kr, tables, pos, kw)
            check(tuple(out.shape) == (B, S, DS_H, DS_R), f"{name}: shape")
            check(bool(torch.isfinite(out.float()).all()),
                  f"{name}: non-finite")
            errs.append(float((out.float() - ref.float()).abs().max()))
    err = max(errs)
    atol, _ = TOL[dtype]
    check(err <= atol, f"paged_attention mla {name} {dtype} block {bs}: "
                       f"max err {err}")
    row = {"case": name, "B": B, "S": S, "positions": positions,
           "dtype": dtype, "block_size": bs, "route": route,
           "max_abs_err": err, "tol": atol,
           "kernel": (KERNEL_NAMES["paged_attention_mla_tc"],
                      KERNEL_NAMES["paged_attention_mla_merge"]) if tc
           else KERNEL_NAMES["paged_attention_mla"]}
    if tc:
        row["merge_max_abs_err"] = merge_err
    if tc:
        plan = plan_paged_attn_mla_tc_sm90(
            batch=B, rows=DS_H * S, block_size=BS, max_blocks=MAX_LEN // BS,
            latent=DS_R, rope=DS_RR)
        row["plan"] = {"kv_splits": plan.kv_splits, "num_bufs":
                       plan.num_bufs, "ctas": plan.ctas,
                       "ctas_per_sm": plan.ctas_per_sm}
        row["ctas_per_sm"] = pa.mla_tc_ctas_per_sm(plan, DS_R, DS_RR)
        check(row["ctas_per_sm"] >= plan.ctas_per_sm,
              f"mla {name}: the card holds {row['ctas_per_sm']} CTAs an SM, "
              f"planned {plan.ctas_per_sm}")
    if timed:
        es = q.element_size()
        n = copies_for(ckv.numel() * es + kr.numel() * es)
        sets = [mla_inputs(B, S, positions, dtype, nb=nb, seed=i, bs=bs)
                for i in range(n)]
        # (bf16: the tensor-core kernel and its merge, summed)
        row["ms"], row["wall_ms"] = measure(
            lambda q, c, k, t, p: pa.paged_attention(q, c, k, t, p, **kw),
            sets, row["kernel"])
        if tc:
            row["kernel_ms"] = device_ms(
                lambda q, c, k, t, p: pa.paged_attention(q, c, k, t, p, **kw),
                sets, KERNEL_NAMES["paged_attention_mla_tc"])
            row["merge_ms"] = device_ms(
                lambda q, c, k, t, p: pa.paged_attention(q, c, k, t, p, **kw),
                sets, KERNEL_NAMES["paged_attention_mla_merge"])
            # the launches alone, on pre-scaled q rows
            row["graph_ms"] = graph_ms(
                lambda q2, c, k, t, p: pa._launch_mla_tc(
                    q2, c, k, t, p, plan, S=S, window=None),
                [(pa._q_rows(q_, kw["scale"], 1, q_.dtype), c_, k_, t_, p_)
                 for q_, c_, k_, t_, p_ in sets])
        row["plain_ms"], row["plain_wall_ms"] = measure(
            lambda q, c, k, t, p: paged_attn_ref(q, c, k, t, p, **kw), sets)
        # yardstick: SDPA over latent rows gathered beforehand, the key
        # concat(c_kv, k_rope) and the value c_kv broadcast over 16 heads
        T = MAX_LEN
        kpos = torch.arange(T, device="cuda")
        lib_sets = []
        for q_, c_, k_, t_, p_ in sets:
            cseq = c_[t_.long()].reshape(B, 1, T, DS_R)
            kseq = torch.cat([cseq, k_[t_.long()].reshape(B, 1, T, DS_RR)],
                             dim=-1)
            qpos = p_.long()[:, None] + torch.arange(S, device="cuda")[None]
            m = kpos[None, None, :] <= qpos[:, :, None]
            lib_sets.append((q_.transpose(1, 2),
                             kseq.expand(B, DS_H, T, DS_R + DS_RR),
                             cseq.expand(B, DS_H, T, DS_R), m[:, None]))
        row["library_ms"], row["library_wall_ms"] = measure(
            lambda q, k, v, m: Fn.scaled_dot_product_attention(
                q, k, v, attn_mask=m, scale=kw["scale"]), lib_sets)
        nbytes, ops = mla_work(positions, S, es, bs)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dtype)
    print(f"paged_attention mla {name:8s} {dtype} block {bs} ({route}): "
          f"max_abs_err={err:.3g} "
          f"atol={atol}" + (
              f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms="
              f"{row['bound_ms']:.5f} ({row['bound_by']}) "
              f"wall_ms={row['wall_ms']:.4f}"
              + (f" graph_ms={row['graph_ms']:.4f} (kernel "
                 f"{row['kernel_ms']:.4f} + merge {row['merge_ms']:.4f})"
                 if tc else "")
              if timed else "")
          + (f" plan={row['plan']} ctas/SM={row['ctas_per_sm']}"
             if tc else ""))
    return row


def mla_merge_case(q, ckv, kr, tables, pos, kw):
    """The merge kernel against its plain version on the partials the
    tensor-core kernel leaves at these inputs (as planned: kv_splits > 1 at
    every path shape); max abs error (bf16 output, f32 plain)."""
    import torch
    from repro_torch.core.schedule import plan_paged_attn_mla_tc_sm90
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import mla_merge_ref
    B, S = q.shape[:2]
    plan = plan_paged_attn_mla_tc_sm90(
        batch=B, rows=DS_H * S, block_size=BS, max_blocks=MAX_LEN // BS,
        latent=DS_R, rope=DS_RR)
    check(plan.kv_splits > 1, "the planned MLA call does not split")
    ws = torch.empty(plan.workspace_floats(DS_R), device="cuda")
    out = torch.empty((B, 1, DS_H * S, DS_R), dtype=torch.bfloat16,
                      device="cuda")
    pa._launch_mla_split(pa._q_rows(q, kw["scale"], 1, q.dtype), ckv, kr,
                         tables, pos, plan, out, ws, S=S, window=None)
    merged = pa.launches_mla_merge.n
    pa._launch_mla_merge(ws, out, plan, DS_R)
    check(pa.launches_mla_merge.n == merged + 1, "the merge did not count")
    ref = mla_merge_ref(ws, batch=B, row_tiles=plan.row_tiles,
                        kv_splits=plan.kv_splits, latent=DS_R,
                        rows=DS_H * S)
    torch.cuda.synchronize()
    e = float((out.reshape(B, -1, DS_R).float() - ref).abs().max())
    check(e <= TOL["bfloat16"][0], f"mla merge: max err {e}")
    return e


def mla_issue_order(report):
    """The tensor-core MLA kernel's issue-order record against
    `chunk_issue_schedule`, for the first run of >= 4 live blocks at the
    decode inputs: kv_splits 1 (lane 3's 7 live blocks in one run) and 2
    (its first run, 4 live blocks)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import chunk_issue_schedule
    nb = SLOTS * (MAX_LEN // BS) + 1
    q, ckv, kr, tables, pos = mla_inputs(SLOTS, 1, [5, 17, 40, 100],
                                         "bfloat16", nb=nb)
    n = 0
    for ks in (1, 2):
        for G in (None, 1, 2, 4):
            got, steps, g_used, C, cta = pa.issue_order_mla(
                q, ckv, kr, tables, pos, scale=0.05, num_bufs=G,
                kv_splits=ks)
            check(steps >= 4, f"mla issue order: {steps} steps recorded")
            check(G is None or g_used == G,
                  f"mla ring depth {g_used} != {G}")
            check(got == chunk_issue_schedule(steps, g_used, C),
                  f"mla issue order differs at G={G} kv_splits={ks}")
            n += 1
            print(f"paged_attention_mla_tc issue order kv_splits={ks} "
                  f"G={g_used} (asked {G}) C={C} CTA {cta} steps={steps}: "
                  f"{sum(len(v) for v in got.values())} chunk issues == "
                  "chunk_issue_schedule")
    report["paged_attention_mla_issue_orders"] = n


def check_mla(report):
    cases = [
        ("decode", SLOTS, 1, [5, 17, 40, 100]),
        ("prefill", 1, CHUNK, [37]),             # unaligned chunk start
        ("verify", SLOTS, DRAFT + 1, [3, 30, 64, 90]),
    ]
    rows = []
    for name, B, S, positions in cases:
        for dtype in ("bfloat16", "float32"):
            rows.append(mla_case(name, B, S, positions, dtype,
                                 timed=dtype == "bfloat16"
                                 or name == "decode"))
    mla_issue_order(report)
    report["paged_attention_mla"] = {"shapes": rows}
    return rows


def check_mla_blocks(report):
    """bf16 MLA at the 8- and 128-token KV blocks the block-size serving
    phase runs (`check_mla_block_sizes`), which the tensor-core kernel does
    not take: the FMA kernel's bf16 instance at the decode, prefill (a
    chunk of max(32, block size) tokens, as the engine cuts it) and verify
    shapes, held against the plain version (bf16 tolerance), each call
    counted on `launches_mla_bf16` alone; timed at decode."""
    rows = []
    for bs in (8, 128):
        chunk = max(CHUNK, bs)
        for name, B, S, positions in (
                ("decode", SLOTS, 1, [5, 17, 40, 100]),
                ("prefill", 1, chunk, [37] if 37 + chunk <= MAX_LEN
                 else [0]),
                ("verify", SLOTS, DRAFT + 1, [3, 30, 64, 90])):
            rows.append(mla_case(name, B, S, positions, "bfloat16",
                                 timed=name == "decode", bs=bs))
    report["paged_attention_mla_bf16"] = {"shapes": rows}
    return rows


def mla_merge_time(row):
    """The merge kernel alone at the decode shape (its inputs, the
    partials, are L2-hot on the path: the tensor-core kernel has just
    written them), beside its plain version and its bound (the live
    partials' acc and every (m, l) read once, the output written once).
    No one PyTorch call merges split-softmax partials: library_ms null."""
    import torch
    from repro_torch.core.schedule import plan_paged_attn_mla_tc_sm90
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import mla_merge_ref
    B, S, positions = row["B"], row["S"], row["positions"]
    plan = plan_paged_attn_mla_tc_sm90(
        batch=B, rows=DS_H * S, block_size=BS, max_blocks=MAX_LEN // BS,
        latent=DS_R, rope=DS_RR)
    g = torch.Generator(device="cuda").manual_seed(7)
    ws = torch.randn(plan.workspace_floats(DS_R), generator=g,
                     device="cuda")
    ml = ws[plan.ctas * 16 * DS_R:].view(B, plan.row_tiles,
                                         plan.kv_splits, 16, 2)
    ml[..., 1].abs_().add_(1.0)            # l > 0
    live_runs = 0
    for b, p in enumerate(positions):      # empty runs: m = -inf, l = 0
        for s_ in range(plan.kv_splits):
            if not any(j * BS <= p + S - 1 for j in plan.run(s_)):
                ml[b, :, s_, :, 0] = float("-inf")
                ml[b, :, s_, :, 1] = 0.0
            else:
                live_runs += plan.row_tiles
    out = torch.empty((B, 1, DS_H * S, DS_R), dtype=torch.bfloat16,
                      device="cuda")
    kw = dict(batch=B, row_tiles=plan.row_tiles, kv_splits=plan.kv_splits,
              latent=DS_R, rows=DS_H * S)
    ms, wall = measure(lambda w: pa._launch_mla_merge(w, out, plan, DS_R),
                       [(ws,)], KERNEL_NAMES["paged_attention_mla_merge"])
    plain, plain_wall = measure(lambda w: mla_merge_ref(w, **kw), [(ws,)])
    nbytes = (live_runs * 16 * DS_R * 4 + plan.ctas * 16 * 8
              + B * DS_H * S * DS_R * 2)
    b_ms, by = bound(nbytes, 3.0 * live_runs * 16 * DS_R, "float32")
    return {"ms": ms, "wall_ms": wall, "plain_ms": plain,
            "plain_wall_ms": plain_wall, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "kv_splits": plan.kv_splits}


# ---------------------------------------------------------------------------
# the main paths: full-width models through the serving engine
# ---------------------------------------------------------------------------

# kernel counter -> profiler kernel name
KERNEL_NAMES = {"gpp_matmul": "gpp_matmul_kernel",
                "gpp_matmul_tc": "gpp_matmul_tc_kernel",
                "gpp_matmul_grouped": "gpp_matmul_grouped_kernel",
                "gpp_matmul_grouped_tc": "gpp_matmul_grouped_tc_kernel",
                "paged_attention": "paged_attention_kernel",
                "paged_attention_mla": "paged_attention_mla_kernel",
                "paged_attention_mla_tc": "paged_attention_mla_tc_kernel",
                "paged_attention_mla_merge":
                    "paged_attention_mla_merge_kernel"}


def counters():
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels import paged_attention as pa
    return {"gpp_matmul": gm.launches, "gpp_matmul_tc": gm.launches_tc,
            "gpp_matmul_grouped": gm.launches_grouped,
            "gpp_matmul_grouped_tc": gm.launches_grouped_tc,
            "paged_attention": pa.launches,
            "paged_attention_mla": pa.launches_mla,
            "paged_attention_mla_bf16": pa.launches_mla_bf16,
            "paged_attention_mla_tc": pa.launches_mla_tc,
            "paged_attention_mla_merge": pa.launches_mla_merge}


def random_prompts(vocab: int, requests: int = 4):
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=rng.integers(4, 13)).tolist()
            for _ in range(requests)]


def serve(cfg, params, prompts, *, speculation: bool, mode: str,
          profile=False, max_new: int = 16, block_size: int = BS):
    import torch
    from repro_torch.serving.engine import ServeConfig, make_engine

    engine = make_engine(cfg, params, ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, block_size=block_size,
        prefill_chunk=max(CHUNK, block_size),   # a whole number of blocks
        speculation=speculation, draft_len=DRAFT, dense_kernel=mode,
        paged_attn_kernel=mode))
    torch.cuda.synchronize()
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    for c in counters().values():
        c.n = 0
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    results = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: c.n for k, c in counters().items()}
    if profile:
        prof.stop()
        busy = dict.fromkeys([*KERNEL_NAMES, "other"], 0.0)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = next((k for k, v in KERNEL_NAMES.items()
                            if v in e.name), "other")
                busy[key] += e.time_range.elapsed_us() / 1e6
    streams = [results[r] for r in rids]
    ntok = sum(len(s) for s in streams)
    check(all(len(s) == max_new for s in streams), "a request did not finish")
    check(all(0 <= t < cfg.vocab_size for s in streams for t in s),
          "token out of range")
    shapes = engine.trace_counts
    # one shape per step function (with every lane drafting, decode-phase
    # steps all ride verify, so a speculating run may show no decode shape)
    check(shapes["prefill_chunk"] == 1 and shapes["decode"] <= 1
          and shapes["verify"] <= int(speculation), f"step shapes {shapes}")
    info = {"model": cfg.name, "num_layers": cfg.num_layers,
            "dtype": cfg.dtype, "speculation": speculation, "mode": mode,
            "block_size": block_size,
            "tokens": ntok, "seconds": dt, "tok_s": ntok / dt,
            "steps": len(engine.metrics), "launches": counts,
            "shapes": shapes, "acceptance_rate": engine.acceptance_rate()}
    if profile:
        info["device_busy_s"] = busy
    print(f"serve {cfg.name} ({cfg.num_layers} layers) {cfg.dtype} "
          f"spec={speculation} mode={mode} block={block_size}: {ntok} "
          f"tokens in {dt:.3f}s = "
          f"{ntok / dt:.1f} tok/s, {len(engine.metrics)} steps, launches "
          f"{counts}, shapes {shapes}, acceptance "
          f"{engine.acceptance_rate():.2f}")
    del engine
    torch.cuda.empty_cache()
    return streams, info


def check_serving(report, arch: str, path_kernels, f32_kernels,
                  f32_layers=None):
    """bf16 serve (spec off, on, profiled) at full width and depth, then
    f32 kernel vs plain greedy streams (at `f32_layers` layers if set).
    Every kernel in `path_kernels` must launch in the bf16 runs and no
    other (with device time under the path's names only); every kernel in
    `f32_kernels` must launch in the f32 kernel run."""
    import torch
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf

    def model(dtype, num_layers=None):
        cfg = registry.get_config(arch).with_(dtype=dtype)
        if num_layers:
            cfg = cfg.with_(num_layers=num_layers)
        gen = torch.Generator(device="cuda").manual_seed(0)
        return cfg, tf.init_params(cfg, gen, "cuda")

    runs = {}
    cfg, params = model("bfloat16")
    torch.cuda.reset_peak_memory_stats()
    # a warm-up run on random prompts (library loading, kernel attributes
    # and the caching allocator's first blocks are not the main path's
    # cost); the measured prompts then hold each one's greedy continuation,
    # so the n-gram drafter has drafts and speculation runs verify steps
    base = random_prompts(cfg.vocab_size)
    first, _ = serve(cfg, params, base, speculation=False, mode="auto")
    prompts = [p + s + p[-3:] for p, s in zip(base, first)]
    plain, runs["bf16"] = serve(cfg, params, prompts, speculation=False,
                                mode="auto")
    spec, runs["bf16_spec"] = serve(cfg, params, prompts, speculation=True,
                                    mode="auto")
    for key in ("bf16", "bf16_spec"):
        counts = runs[key]["launches"]
        for k, n in counts.items():
            check((n > 0) == (k in path_kernels),
                  f"{k} launched {n} times on the {arch} path ({key})")
        # bf16 projections run the tensor-core gpp_matmul; the FMA one runs
        # only deepseek's f32 router, one a MoE layer (three grouped
        # launches)
        check(counts["gpp_matmul"] * 3 == counts["gpp_matmul_grouped_tc"],
              f"{arch} ({key}): {counts['gpp_matmul']} FMA gpp_matmul "
              f"launches for {counts['gpp_matmul_grouped_tc']} grouped ones")
    check(runs["bf16"]["shapes"]["decode"] == 1
          and runs["bf16_spec"]["shapes"]["verify"] == 1,
          f"{arch}: the decode or the verify shape did not run")
    print(f"{arch} bf16 greedy streams spec on == off: {plain == spec}")
    # the same bf16 run again under torch.profiler: device time by kernel,
    # over the wall time of the unprofiled run (same work, same shapes)
    again, prof = serve(cfg, params, prompts, speculation=False,
                        mode="auto", profile=True)
    check(again == plain, f"{arch}: the profiled run's streams differ")
    busy = prof["device_busy_s"]
    for k in KERNEL_NAMES:
        check((busy[k] > 0) == (k in path_kernels),
              f"{arch}: {busy[k]} s of device time under {KERNEL_NAMES[k]}")
    share = sum(busy.values()) / runs["bf16"]["seconds"]
    runs["bf16"]["device_busy_s"] = busy
    runs["bf16"]["gpp_matmul_device_s"] = busy["gpp_matmul"] + \
        busy["gpp_matmul_tc"]
    runs["bf16"]["device_busy_share"] = share
    runs["bf16"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    runs["bf16"]["total_params"] = cfg.total_params()
    print(f"{arch} bf16 decode run device time: {busy} s; under gpp_matmul "
          f"{runs['bf16']['gpp_matmul_device_s']:.4f} s; busy share "
          f"{share:.3f} of {runs['bf16']['seconds']:.3f}s wall; peak memory "
          f"{runs['bf16']['peak_mem_gb']:.1f} GB")
    del params
    torch.cuda.empty_cache()

    cfg, params = model("float32", f32_layers)
    f32_kernel, runs["f32_kernel"] = serve(cfg, params, prompts,
                                           speculation=False, mode="auto")
    f32_ref, runs["f32_ref"] = serve(cfg, params, prompts,
                                     speculation=False, mode="ref")
    check(not any(runs["f32_ref"]["launches"].values()),
          "the plain run launched a kernel")
    for k in f32_kernels:
        check(runs["f32_kernel"]["launches"][k] > 0,
              f"{k} never launched on the {arch} f32 kernel run")
    check(f32_kernel == f32_ref,
          f"{arch} f32 greedy streams differ: kernel {f32_kernel} ref "
          f"{f32_ref}")
    print(f"{arch} f32 greedy streams kernel == plain: True "
          f"({cfg.num_layers} layers)")
    del params
    torch.cuda.empty_cache()
    report.setdefault("serving", {})[arch] = runs
    report.setdefault("bf16_spec_equal", {})[arch] = plain == spec
    return runs


def check_mla_block_sizes(report):
    """deepseek-v2-lite-16b at full width, 4 of its 27 layers (1 dense + 3
    MoE), served with 8- and 128-token KV blocks, which the tensor-core MLA
    kernel does not take: bf16 must run the FMA MLA kernel's bf16 instance
    (its own count) and neither tensor-core MLA kernel; f32 at 8-token
    blocks (its ring of one 128-token block does not fit the shared
    memory) must give the plain run's greedy streams.  The bf16 streams
    are set beside the plain bf16 run's, not gated (bf16 rounds
    differently in the two)."""
    import torch
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    arch = "deepseek-v2-lite-16b"
    out = {}
    for dtype, sizes in (("bfloat16", (8, 128)), ("float32", (8,))):
        cfg = registry.get_config(arch).with_(dtype=dtype, num_layers=4)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tf.init_params(cfg, gen, "cuda")
        prompts = random_prompts(cfg.vocab_size)
        mla = ("paged_attention_mla_bf16" if dtype == "bfloat16"
               else "paged_attention_mla")
        for bs in sizes:
            streams, info = serve(cfg, params, prompts, speculation=False,
                                  mode="auto", block_size=bs)
            c = info["launches"]
            check(c[mla] > 0 and all(
                c[k] == 0 for k in ("paged_attention_mla_tc",
                                    "paged_attention_mla_merge",
                                    "paged_attention_mla",
                                    "paged_attention_mla_bf16") if k != mla),
                  f"{arch} {dtype} block {bs}: MLA launches {c}")
            plain, _ = serve(cfg, params, prompts, speculation=False,
                             mode="ref", block_size=bs)
            equal = streams == plain
            if dtype == "float32":
                check(equal, f"{arch} f32 block {bs}: kernel streams "
                             f"{streams} differ from plain {plain}")
            out[f"{dtype} block {bs}"] = {
                "launches": c, "tok_s": info["tok_s"],
                "streams_equal_plain": equal}
            print(f"{arch} (4 layers) {dtype} block {bs}: {c[mla]} {mla} "
                  f"launches, greedy streams == plain: {equal}"
                  + ("" if dtype == "float32" else " (bf16: not gated)"))
        del params
        torch.cuda.empty_cache()
    report["mla_block_sizes"] = out
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    resolve_device("cuda")                  # also turns TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    per = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f}s ({per})")
    report = {"card": smi, "build_s": build_s}

    gpp_rows, gpp_err = check_gpp(report)
    pa_rows = check_paged(report)
    grouped_rows, grouped_err = check_grouped(report)
    check_moe_layer(report)
    mla_rows = check_mla(report)
    mla_bf16_rows = check_mla_blocks(report)
    qwen = check_serving(report, "qwen1.5-0.5b",
                         ("gpp_matmul_tc", "paged_attention"),
                         ("gpp_matmul", "paged_attention"))
    deepseek = check_serving(report, "deepseek-v2-lite-16b",
                             ("gpp_matmul_tc", "gpp_matmul",
                              "gpp_matmul_grouped_tc",
                              "paged_attention_mla_tc",
                              "paged_attention_mla_merge"),
                             ("gpp_matmul", "gpp_matmul_grouped",
                              "paged_attention_mla"), f32_layers=4)
    blocks = check_mla_block_sizes(report)

    g = next(r for r in gpp_rows if r["path"] == "qwen1.5-0.5b"
             and r["phase"] == "decode" and r["proj"] == "gate_up"
             and r["dtype"] == "bfloat16")
    gr = next(r for r in gpp_rows if r["proj"] == "router"
              and r["phase"] == "decode")
    p = next(r for r in pa_rows if r["case"] == "decode"
             and r["dtype"] == "bfloat16")
    gg = next(r for r in grouped_rows if r["phase"] == "decode"
              and r["proj"] == "gate_up" and r["dtype"] == "bfloat16")
    gf = next(r for r in grouped_rows if r["phase"] == "decode"
              and r["proj"] == "gate_up" and r["dtype"] == "float32")
    m = next(r for r in mla_rows if r["case"] == "decode"
             and r["dtype"] == "bfloat16")
    mf = next(r for r in mla_rows if r["case"] == "decode"
              and r["dtype"] == "float32")
    mb8 = next(r for r in mla_bf16_rows if r["case"] == "decode"
               and r["block_size"] == 8)
    mm = mla_merge_time(m)
    report["paged_attention_mla_merge"] = mm
    print(f"paged_attention_mla_merge decode (kv_splits {mm['kv_splits']}):"
          f" ms={mm['ms']:.4f} plain_ms={mm['plain_ms']:.4f} bound_ms="
          f"{mm['bound_ms']:.5f} ({mm['bound_by']}) wall_ms="
          f"{mm['wall_ms']:.4f}")
    numbers = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    tc_by_path = {
        "qwen1.5-0.5b": qwen["bf16"]["launches"]["gpp_matmul_tc"],
        "deepseek-v2-lite-16b": deepseek["bf16"]["launches"]["gpp_matmul_tc"]}
    fma_by_path = {
        "deepseek-v2-lite-16b (f32 router)":
            deepseek["bf16"]["launches"]["gpp_matmul"],
        "qwen1.5-0.5b in f32": qwen["f32_kernel"]["launches"]["gpp_matmul"],
        "deepseek-v2-lite-16b in f32 (4 layers)":
            deepseek["f32_kernel"]["launches"]["gpp_matmul"]}
    kernels = [
        {"name": "gpp_matmul_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul.cu",
         "replaces": "src/repro/kernels/gpp_matmul.py:408",
         "kernel": "gpp_matmul_tc_kernel (bf16 x and W; stream-K, split "
                   "tiles summed by their last CTA)",
         "path": "qwen1.5-0.5b, deepseek-v2-lite-16b",
         "launches": sum(tc_by_path.values()),
         "launches_by_path": tc_by_path,
         "max_abs_err": gpp_err["tc"],
         "tol": "atol 2e-2 + rtol 2e-2 x |plain| (bf16)",
         "shape": f"qwen decode up-projection {g['M']}x{g['K']}x{g['N']} "
                  "bf16 (every shape of both paths: --json-out)",
         "fma_ms": g["fma_ms"],
         **{k: g[k] for k in numbers}},
        {"name": "gpp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul.cu",
         "replaces": "src/repro/kernels/gpp_matmul.py:408",
         "kernel": "gpp_matmul_kernel (f32 x, or f32 / int8 W; FMA)",
         "path": "deepseek-v2-lite-16b (its f32 router); f32 runs",
         "launches": deepseek["bf16"]["launches"]["gpp_matmul"],
         "launches_by_path": fma_by_path,
         "max_abs_err": gpp_err["fma"],
         "tol": "atol 2e-4 + rtol 2e-4 x |plain| (f32); bf16 and int8 W as "
                "bf16",
         "shape": f"deepseek decode router {gr['M']}x{gr['K']}x{gr['N']} "
                  "f32",
         **{k: gr[k] for k in numbers}},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341",
         "path": "qwen1.5-0.5b",
         "launches": qwen["bf16"]["launches"]["paged_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in pa_rows),
         "shape": f"decode B={SLOTS} H={H} hd={HD} positions "
                  f"{p['positions']} bf16",
         **{k: p[k] for k in numbers}},
        {"name": "gpp_matmul_grouped", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul_grouped.cu",
         "replaces": "src/repro/kernels/gpp_matmul.py:606",
         "kernel": "gpp_matmul_grouped_tc_kernel (bf16 x and W)",
         "path": "deepseek-v2-lite-16b",
         "launches": deepseek["bf16"]["launches"]["gpp_matmul_grouped_tc"],
         "max_abs_err": grouped_err["tc"],
         "shape": f"decode gate/up {gg['E']}x{gg['M']}x{gg['K']}x{gg['N']} "
                  "bf16",
         **{k: gg[k] for k in numbers}},
        {"name": "gpp_matmul_grouped_fma", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul_grouped.cu",
         "replaces": "src/repro/kernels/gpp_matmul.py:606",
         "kernel": "gpp_matmul_grouped_kernel (f32 x, or f32 / int8 W)",
         "path": "deepseek-v2-lite-16b in f32 "
                 f"({deepseek['f32_kernel']['num_layers']} layers)",
         "launches":
             deepseek["f32_kernel"]["launches"]["gpp_matmul_grouped"],
         "max_abs_err": grouped_err["fma"],
         "shape": f"decode gate/up {gf['E']}x{gf['M']}x{gf['K']}x{gf['N']} "
                  "f32",
         **{k: gf[k] for k in numbers}},
        {"name": "paged_attention_mla_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (mla=True, "
                     ":173-177)",
         "kernel": "paged_attention_mla_tc_kernel (bf16, split-KV; ms "
                   "includes its merge kernel's)",
         "path": "deepseek-v2-lite-16b",
         "launches": deepseek["bf16"]["launches"]["paged_attention_mla_tc"],
         "max_abs_err": max(r["max_abs_err"] for r in mla_rows
                            if r["dtype"] == "bfloat16"),
         "shape": f"decode B={SLOTS} H={DS_H} latent {DS_R}+{DS_RR} "
                  f"positions {m['positions']} bf16",
         **{k: m[k] for k in numbers}},
        {"name": "paged_attention_mla_merge", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (mla=True, "
                     ":173-177; the split walk's merge)",
         "kernel": "paged_attention_mla_merge_kernel (f32 partials -> bf16)",
         "path": "deepseek-v2-lite-16b",
         "launches":
             deepseek["bf16"]["launches"]["paged_attention_mla_merge"],
         "max_abs_err": max(r["merge_max_abs_err"] for r in mla_rows
                            if r["dtype"] == "bfloat16"),
         "shape": f"decode B={SLOTS} H={DS_H} latent {DS_R}, "
                  f"{mm['kv_splits']} partials a row (alone; its time is "
                  "also inside paged_attention_mla_tc's)",
         **{k: mm[k] for k in numbers}},
        {"name": "paged_attention_mla", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (mla=True, "
                     ":173-177)",
         "kernel": "paged_attention_mla_kernel (f32, FMA)",
         "path": "deepseek-v2-lite-16b in f32 "
                 f"({deepseek['f32_kernel']['num_layers']} layers)",
         "launches": deepseek["f32_kernel"]["launches"]["paged_attention_mla"],
         "max_abs_err": max(r["max_abs_err"] for r in mla_rows
                            if r["dtype"] == "float32"),
         "shape": f"decode B={SLOTS} H={DS_H} latent {DS_R}+{DS_RR} "
                  f"positions {mf['positions']} f32",
         **{k: mf[k] for k in numbers}},
        {"name": "paged_attention_mla_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (mla=True, "
                     ":173-177)",
         "kernel": "paged_attention_mla_kernel, bf16 instance (FMA; bf16 "
                   "MLA at block sizes the tensor-core kernel does not "
                   "take)",
         "path": "deepseek-v2-lite-16b (4 layers) at 8- and 128-token KV "
                 "blocks",
         "launches": sum(v["launches"]["paged_attention_mla_bf16"]
                         for k, v in blocks.items()
                         if k.startswith("bfloat16")),
         "launches_by_block": {
             k: v["launches"]["paged_attention_mla_bf16"]
             for k, v in blocks.items() if k.startswith("bfloat16")},
         "max_abs_err": max(r["max_abs_err"] for r in mla_bf16_rows),
         "tol": "atol 2e-2 (bf16), decode / prefill / verify at blocks of "
                "8 and 128",
         "shape": f"decode B={SLOTS} H={DS_H} latent {DS_R}+{DS_RR} "
                  f"positions {mb8['positions']} bf16, 8-token blocks",
         **{k: mb8[k] for k in numbers}},
    ]
    report["kernels"] = kernels
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
