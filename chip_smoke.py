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
     router and every f32 shape on the split-K FMA kernel, timed at the
     router's three shapes and every f32 decode shape; both models' f32
     logits heads, f32 x against the bf16 (d, vocab) table on the FMA
     kernel, timed at the three step shapes beside the `torch.matmul` on
     the f32 table it replaced; gpp_matmul_grouped on both routes, bf16 x
     and W on its tensor-core kernel, f32 and int8 on its split-K FMA
     kernel, both timed at every phase and projection), and prints the
     largest error beside its tolerance, then the kernel's
     time (for bf16 gpp_matmul also the pinned FMA kernel's), the plain
     version's time, a library yardstick's time (`torch.matmul` /
     `torch.bmm`, f32 with TF32 off; `scaled_dot_product_attention` on
     gathered K/V or latent rows; `F.rms_norm`) and the bound (the larger
     of bytes / 3.35e12 B/s and operations / the peak rate of their type);
     it checks that the gpp_matmul repeats bit for bit on both routes and
     the grouped FMA kernel too, that a tensor-core row is the same bits
     at 4, 20 and 32 rows at every bf16 projection, the router's at 1, 4,
     20 and 32 rows, a logits row at 1, 4, 20 and 32 rows on both models'
     tables and a grouped FMA row at 8, 32 and 128 rows an expert, reads
     the issue-order records of gpp_matmul (the FMA route's CTA 0 across a
     tile boundary and a k-split; the tensor-core route's rank 0 over a
     k-slice of several steps), gpp_matmul_grouped (the tensor-core route
     at deepseek's decode shape, across n-tiles, and at one n-tile an
     expert, across experts; the FMA route at the decode shape in f32,
     across tiles and k-splits, and at one n-tile an expert, across three
     experts) and both tensor-core attention kernels
     back and compares them with `chunk_issue_schedule` for G in {1, 2, 4}
     (3 too on the tensor-core gpp_matmul) and the planned G, checks that
     the card holds the CTAs an SM the plans assume (both grouped routes;
     for the tensor-core gpp_matmul: every planned cluster at once, by
     cudaOccupancyMaxActiveClusters), and runs
     one full-width deepseek MoE layer in bf16 with the kernels against
     the plain versions (decode and prefill inputs, relative error <=
     1e-2); GQA / window paged attention runs its tensor-core kernel in
     bf16 (split-KV, kv_splits planned, 1, 2; head_dim 64 at qwen's three
     shapes with and without a 32-token window, 128 and 256 at decode and
     verify), the FMA kernel's bf16 instance pinned, and its FMA kernel in
     f32 (split-KV over fixed runs of pieces, kv_splits planned, 1, 2 and
     one run a piece, with its merge), timed at every bf16 shape (also by
     CUDA events over CUDA graphs at kv_splits 1, 2, 4 and planned) and at
     f32 decode (with its plan: P, kv_splits, grid); MLA paged attention
     runs its tensor-core kernel in bf16 (split-KV, kv_splits planned, 1,
     2, 8) and its FMA kernel in f32 (likewise split), is timed in both at
     decode (bf16 also at prefill and verify; both also by CUDA events over
     a CUDA graph of launches); the merge kernel they share is held against
     its plain version on the tensor-core kernels' partials and timed in
     bf16 and f32; MLA on the FMA kernel at the block sizes the
     tensor-core kernel does not take (bf16 at 8, 128 and 256 tokens, f32
     at 128 and 256; max_len 256 for 256) is held against the plain
     version at the three shapes and timed at decode; the FMA kernel's
     issue order (MLA f32 / bf16, GQA f32) is read beside the tensor-core
     kernels'; RMSNorm runs
     its row-invariant kernel at the paths' widths (512-2048, f32 and bf16,
     1-32 rows, strided rows), whose rows must be the same bits at 1, 5 and
     32 rows, at any place in the batch and at decode and verify layouts;
  4. serves full-width qwen1.5-0.5b (random weights from a seed) through
     `repro_torch.serving.ServingEngine`: a warm-up run on random prompts,
     whose greedy continuations are then appended to the prompts (so the
     n-gram drafter finds drafts), bf16 with speculation off and on at
     three prompt seeds, whose greedy streams must be equal (tok/s and
     launch counts from seed 0, which must be > 0 for the path's kernels
     and 0 for the others: bf16 projections on the tensor-core gpp_matmul,
     the FMA one for the f32 logits head, one a step-function call, and
     deepseek's f32 router, one a MoE layer; GQA on the tensor-core kernel
     and its merge; RMSNorm on its kernel), one
     profiled run (device time by kernel, again only under the path's
     kernels, busy share, the time under gpp_matmul and paged attention),
     then float32 with the kernels and with their plain versions, whose
     greedy streams must be equal;
  5. the same for deepseek-v2-lite-16b (MLA + MoE) at full width and full
     depth in bf16 (~31 GB of weights); its float32 kernel-vs-plain stream
     check runs at full width with 4 of its 27 layers (1 dense + 3 MoE),
     since full depth in f32 is 62.8 GB of weights; then, at 4 layers, it
     serves bf16 with 8- and 128-token KV blocks (the FMA MLA kernel's
     bf16 instance, counted on its own, and its merge) and f32 with 8- and
     128-token blocks, whose greedy streams must equal the plain run's;
  6. for the paged token archs of slice 11, at their published widths,
     with step 3's checks: every projection shape of qwen2-7b,
     h2o-danube-1.8b, gemma3-12b and kimi-k2 on both gpp_matmul routes
     (bf16 at the three step shapes, a row's bits equal at 4 / 20 / 32
     rows; f32 at decode; kimi's f32 router's bits at 1 / 4 / 20 / 32
     rows), their f32 logits heads, GQA attention at their heads (query
     groups 2, 4, 7 and 8; head_dim 256 with gemma3's 1024-token window
     past it at max_len 1280; danube's head_dim 80 on the FMA kernel's
     bf16 instance), the grouped kernel at kimi's 384 experts and one
     full-width kimi MoE layer (auto vs plain within 1e-2, the experts
     given no routed row); and, after step 5, it serves qwen2-7b and
     danube at full width and depth (f32 too), gemma3-12b at full width
     and depth in bf16 and 12 layers in f32, each also with a 1,200-token
     request past its window (bf16 spec on == off, the window group's
     blocks plateau, f32 kernel == plain), and kimi-k2 at full width with
     2 of its 61 layers in bf16 (its f32 parity stands on the CPU at
     SMOKE: 2 layers in f32 are 80 GB), each launching exactly its path's
     kernels, bf16 spec on == off at three prompt seeds (prompts of one
     token repeated, so the drafter drafts; some seed must accept drafts),
     the f32 streams on random prompts, and every f32 run's logits rows,
     one an emitted token, within LOGITS_RTOL of the plain run's;
  7. with step 3's checks, the paper's workload,
     `kernels.ops.streamed_gemm_sequence`: 8 rounds of 4096 x 4096 bf16
     weights (256 MB) at 8 and 128 rows, at G = 1, 2, 3, 4 and the planned
     G (gpp_matmul's planner, unpinned), against the plain version, timed beside the copied simulator's
     prediction, with measured tile times fed to a `TimingCache`;
  8. prints {"kernels": [...]} and, last, the device line.

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
# the paged token archs ported in slice 11, at their published widths
# (configs/): (d_model, heads, kv heads, head_dim, d_ff, vocab)
NEW_ARCHS = {"qwen2-7b": (3584, 28, 4, 128, 18944, 152064),
             "h2o-danube-1.8b": (2560, 32, 8, 80, 6912, 32000),
             "gemma3-12b": (3840, 16, 8, 256, 15360, 262144),
             "kimi-k2-1t-a32b": (7168, 64, 8, 128, 18432, 163840)}
KIMI_E, KIMI_F = 384, 2048          # kimi-k2's routed experts and their d_ff
# their gpp_matmul shapes: q, k / v, o, the MLP (kimi: layer 0's dense MLP,
# the shared expert, the f32 router); f32 at decode only (the f32 serving
# runs then hold every shape, stream against stream)
GPP_SHAPES.update({
    arch: {"q": (d, h * hd, BOTH), "kv": (d, kv * hd, BOTH),
           "o": (h * hd, d, BOTH), "gate_up": (d, f, BOTH),
           "down": (f, d, BOTH)}
    for arch, (d, h, kv, hd, f, _) in NEW_ARCHS.items()})
GPP_SHAPES["kimi-k2-1t-a32b"].update({
    "shared_gate_up": (7168, KIMI_F, BOTH),
    "shared_down": (KIMI_F, 7168, BOTH),
    "router": (7168, KIMI_E, ("float32",))})


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
    f32 the split-K FMA route, also by CUDA events over a CUDA graph of
    launches (`graph_ms`, with torch.matmul's beside it): a launch of a few
    microseconds is shorter than the host's cost of issuing one."""
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
        out["graph_ms"] = graph_ms(lambda x, w: gpp_matmul(x, w), sets)
        out["library_graph_ms"] = graph_ms(torch.matmul, sets)
    out["plain_ms"], out["plain_wall_ms"] = measure(
        lambda x, w: dense_ref(x, w), sets)
    out["library_ms"], out["library_wall_ms"] = measure(
        lambda x, w: torch.matmul(x, w), sets)
    out["bound_ms"], out["bound_by"] = bound((M * K + K * N + M * N) * es,
                                             2.0 * M * K * N, dtype)
    return out


# the f32 logits heads: (d_model, vocab) of each model's table, and the
# rows a step function's head takes (prefill: its chunk's last row)
HEADS = {"qwen1.5-0.5b": (D, 151936), "deepseek-v2-lite-16b": (DS_D, 102400),
         **{arch: (w[0], w[5]) for arch, w in NEW_ARCHS.items()}}
HEAD_M = {"prefill": 1, "decode": SLOTS, "verify": SLOTS * (DRAFT + 1)}


def head_time(M, K, N):
    """The f32 logits head at one step shape: f32 x (M, K) against the
    bf16 (K, N) serving copy of the table on the FMA route of gpp_matmul
    (`kernels.ops.dense`), against what it replaced, `torch.matmul` of f32
    x and the f32 table's transpose (the cached f32 copy), and the plain
    version; the bound reads the bf16 table once."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import dense_ref
    g = torch.Generator(device="cuda").manual_seed(2)
    sets = []
    for _ in range(copies_for(K * N * 2)):
        table = (torch.randn(N, K, generator=g, device="cuda")
                 * 0.02).bfloat16()
        sets.append((torch.randn(M, K, generator=g, device="cuda"),
                     table.t().contiguous(), table.float()))
    out = {}
    out["ms"], out["wall_ms"] = measure(lambda x, wt, _: ops.dense(x, wt),
                                        sets, KERNEL_NAMES["gpp_matmul"])
    out["library_ms"], out["library_wall_ms"] = measure(
        lambda x, _, t32: x @ t32.t(), sets)
    out["plain_ms"], _ = measure(lambda x, wt, _: dense_ref(x, wt), sets)
    out["bound_ms"], out["bound_by"] = bound(
        M * K * 4 + K * N * 2 + M * N * 4, 2.0 * M * K * N, "float32")
    del sets
    torch.cuda.empty_cache()
    return out


def check_head(report):
    """The f32 logits head of both models on the FMA route: a row's bits
    equal at 1, 4, 20 and 32 rows (and against the f32 table), within 2e-4
    of the plain version; timed at the three step shapes beside the
    `torch.matmul` it replaced."""
    import torch
    from repro_torch.core.schedule import plan_matmul_fma_sm90
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import dense_ref
    rows = []
    for arch, (K, N) in HEADS.items():
        g = torch.Generator(device="cuda").manual_seed(3)
        table = (torch.randn(N, K, generator=g, device="cuda")
                 * 0.02).bfloat16()
        table_t = table.t().contiguous()
        x = torch.randn(32, K, generator=g, device="cuda")
        fma = gm.launches.n
        y = ops.dense(x, table_t)
        check(gm.launches.n == fma + 1, f"{arch} head: not the FMA route")
        ref = dense_ref(x, table_t)
        err = float((y - ref).abs().max())
        check(bool(torch.isfinite(y).all())
              and bool(((y - ref).abs() <= 2e-4 + 2e-4 * ref.abs()).all()),
              f"{arch} head: max err {err}")
        by_m = {M: ops.dense(x[:M], table_t) for M in (1, SLOTS,
                                                       HEAD_M["verify"])}
        check(all(torch.equal(v, y[:M]) for M, v in by_m.items()),
              f"{arch} head: a logits row's bits depend on the batch")
        check(torch.equal(ops.dense(x[:SLOTS], table.float().t()
                                    .contiguous()), y[:SLOTS]),
              f"{arch} head: the bf16 table does not give its f32 copy's "
              "bits")
        del table, table_t
        torch.cuda.empty_cache()
        print(f"logits head {arch} {K}x{N}: a row's bits equal at "
              f"{sorted(by_m) + [32]} rows; bf16 table == its f32 copy; "
              f"max_abs_err={err:.3g}", flush=True)
        for phase, M in HEAD_M.items():
            plan = plan_matmul_fma_sm90(M, K, N, w_itemsize=2)
            row = {"arch": arch, "phase": phase, "M": M, "K": K, "N": N,
                   "max_abs_err": err,
                   "plan": {"block_m": plan.block_m,
                            "block_k": plan.block_k,
                            "num_bufs": plan.num_bufs, "grid": plan.grid,
                            "max_segs": plan.max_segs},
                   **head_time(M, K, N)}
            rows.append(row)
            print(f"logits head {arch} {phase:7s} {M}x{K}x{N} (f32 x, bf16 "
                  f"table): ms={row['ms']:.4f} torch.matmul (f32 table) "
                  f"library_ms={row['library_ms']:.4f} plain_ms="
                  f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) wall_ms={row['wall_ms']:.4f} "
                  f"plan={row['plan']}", flush=True)
    report["logits_head"] = rows
    return rows


def check_gpp(report):
    import torch
    from repro_torch.core.schedule import (plan_matmul_fma_sm90,
                                           plan_matmul_tc_sm90)
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import ACTIVATION_IDS, chunk_issue_schedule
    rows = []
    for path, shapes in GPP_SHAPES.items():
        new = path in NEW_ARCHS
        for phase, M in PHASE_M.items():
            for name, (K, N, dtypes) in shapes.items():
                for dtype in dtypes:
                    bf16 = dtype == "bfloat16"
                    # slice 11's archs: f32 projections at decode, planned
                    # G (their f32 serving runs hold the rest); timed at
                    # decode in the path's own dtype
                    if new and not bf16 and phase != "decode" \
                            and name != "router":
                        continue
                    err = max(gpp_case(M, K, N, dtype, G=G)
                              for G in ((None, 1, 2, 3, 4) if bf16
                                        else (None,) if new
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
                            "block_n": plan.block_n,
                            "block_k": plan.block_k,
                            "cluster": plan.cluster,
                            "num_bufs": plan.num_bufs, "ctas": plan.ctas,
                            "steps": max(plan.cta_steps(r)
                                         for r in range(plan.cluster))}
                        # every planned cluster resident at once
                        row["max_clusters"] = gm.tc_max_clusters(plan)
                        check(row["max_clusters"] >= plan.tiles,
                              f"gpp_matmul_tc {M}x{K}x{N}: the card holds "
                              f"{row['max_clusters']} clusters of "
                              f"{plan.cluster}, planned {plan.tiles}")
                    else:
                        plan = plan_matmul_fma_sm90(M, K, N, w_itemsize=4)
                        row["plan"] = {
                            "block_m": plan.block_m,
                            "block_k": plan.block_k,
                            "num_bufs": plan.num_bufs, "grid": plan.grid,
                            "max_segs": plan.max_segs}
                    # the path's own dtype, and every f32 decode shape
                    if (phase == "decode" and dtype == dtypes[0] if new
                            else dtype == dtypes[0] or phase == "decode"):
                        row.update(gpp_time(M, K, N, dtype))
                    rows.append(row)
                    print(f"gpp_matmul {path} {phase:7s} {name:14s} "
                          f"{M}x{K}x{N} {dtype} ({row['route']}): "
                          f"max_abs_err={err:.3g} (atol,rtol)={TOL[dtype]}"
                          + (f" ms={row['ms']:.4f}"
                             + (f" fma_ms={row['fma_ms']:.4f}" if bf16
                                else f" graph_ms kernel / matmul="
                                f"{row['graph_ms']:.4f} / "
                                f"{row['library_graph_ms']:.4f}")
                             + f" plain_ms={row['plain_ms']:.4f} library_ms="
                             f"{row['library_ms']:.4f} bound_ms="
                             f"{row['bound_ms']:.4f} ({row['bound_by']})"
                             f" wall_ms={row['wall_ms']:.4f}"
                             if "ms" in row else "")
                          + f" plan={row['plan']}", flush=True)
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
    # split tiles are summed in a fixed order: bf16 (tensor cores) and f32
    # (FMA: the router, a wide projection) repeat bit for bit
    g = torch.Generator(device="cuda").manual_seed(9)
    for M, K, N, dt in ((SLOTS, F, D, torch.bfloat16),
                        (CHUNK, DS_F0, DS_D, torch.bfloat16),
                        (SLOTS, DS_D, DS_E, torch.float32),
                        (CHUNK, DS_F0, DS_D, torch.float32)):
        x = torch.randn(M, K, generator=g, device="cuda").to(dt)
        w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).to(dt)
        first = gm.gpp_matmul(x, w, activation="silu")
        check(all(torch.equal(gm.gpp_matmul(x, w, activation="silu"), first)
                  for _ in range(3)),
              f"gpp_matmul {M}x{K}x{N} {dt} is not bitwise repeatable")
    print("gpp_matmul bitwise repeatable over 4 runs at "
          f"{SLOTS}x{F}x{D} and {CHUNK}x{DS_F0}x{DS_D} (bf16, tensor cores), "
          f"{SLOTS}x{DS_D}x{DS_E} and {CHUNK}x{DS_F0}x{DS_D} (f32, FMA)")
    # a row's bits do not depend on the batch it rides in: a tensor-core
    # row at 4 (decode), 20 (verify) and 32 (prefill) rows at every bf16
    # projection of both paths (the k-slices and k-groups come from K and
    # N alone), then the router at 1,
    # 4 (decode), 20 (verify) and 32 (prefill) rows, its weight as stored
    # (bf16, widened in the kernel) and as its f32 copy, which must agree
    tc_proj = sorted({(K, N) for shapes in GPP_SHAPES.values()
                      for K, N, dtypes in shapes.values()
                      if "bfloat16" in dtypes})
    for K, N in tc_proj:
        x = torch.randn(CHUNK, K, generator=g, device="cuda").bfloat16()
        w = (torch.randn(K, N, generator=g, device="cuda")
             * 0.02).bfloat16()
        y = gm.gpp_matmul(x, w, activation="silu")
        check(all(torch.equal(gm.gpp_matmul(x[:M], w, activation="silu"),
                              y[:M]) for M in (SLOTS, PHASE_M["verify"])),
              f"gpp_matmul_tc {K}x{N}: a row's bits depend on the batch")
    print(f"gpp_matmul_tc: a row's bits equal at {SLOTS} / "
          f"{PHASE_M['verify']} / {CHUNK} rows at all {len(tc_proj)} bf16 "
          "projections")
    for K, N in ((DS_D, DS_E), (7168, KIMI_E)):     # deepseek's, kimi's
        x = torch.randn(CHUNK, K, generator=g, device="cuda")
        w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).bfloat16()
        rows_by_m = {M: gm.gpp_matmul(x[:M], w) for M in (1, SLOTS,
                                                          PHASE_M["verify"],
                                                          CHUNK)}
        check(all(torch.equal(rows_by_m[CHUNK][:M], y)
                  for M, y in rows_by_m.items()),
              f"the router {K}x{N}: a row's bits depend on the batch")
        check(torch.equal(gm.gpp_matmul(x, w.float()), rows_by_m[CHUNK]),
              f"the router {K}x{N}: the bf16 weight does not give its f32 "
              "copy's bits")
        print(f"gpp_matmul router {K}x{N}: a row's bits equal at "
              f"{sorted(rows_by_m)} rows; bf16 W == its f32 copy")
    # the generalized ping-pong issue order survived the port: the FMA
    # route (pinned on bf16) over CTA 0's planned run, and over a run
    # across a tile boundary (2 CTAs pinned) and at the router's k-split;
    # the tensor-core route over rank 0's k-slice of several steps, which
    # rank 1 continues (a cluster of 2 at 128-row steps pinned: 8 steps;
    # layer 0's down projection as planned)
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
    for (M, K, N), grid in (((SLOTS, 512, 192), 2), ((SLOTS, DS_D, DS_E),
                                                      None)):
        x = torch.randn(M, K, device="cuda")
        w = torch.randn(K, N, device="cuda") * 0.02
        for G in (None, 1, 2, 4):
            got, steps, g_used, C = gm.issue_order(x, w, G, grid=grid)
            plan = plan_matmul_fma_sm90(M, K, N, w_itemsize=4, num_bufs=G,
                                        grid=grid)
            tiles = {plan.unit(u)[0] for u in plan.cta_units(0)}
            check(len(plan.segments(max(tiles))) > 1
                  and len(tiles) == (2 if grid else 1),
                  "the fma record's run crosses no tile or split boundary")
            check(G is None or g_used == G, f"ring depth {g_used} != {G}")
            check(got == chunk_issue_schedule(steps, g_used, C),
                  f"fma issue order differs at {M}x{K}x{N} G={G}")
            orders += 1
            print(f"gpp_matmul (fma) issue order {M}x{K}x{N} grid="
                  f"{plan.grid} G={g_used} (asked {G}) C={C} steps={steps} "
                  f"over tiles {sorted(tiles)}, tile {max(tiles)} in "
                  f"{len(plan.segments(max(tiles)))} segments: "
                  f"{sum(len(v) for v in got.values())} chunk issues == "
                  "chunk_issue_schedule")
    for (M, K, N), pins in (((SLOTS, 2048, 1024),
                             dict(cluster=2, block_k=128)),
                            ((SLOTS, DS_F0, DS_D), {})):
        x = torch.randn(M, K, device="cuda").bfloat16()
        w = (torch.randn(K, N, device="cuda") * 0.02).bfloat16()
        for G in (None, 1, 2, 3, 4):
            got, steps, g_used, C = gm.issue_order(x, w, G, **pins)
            plan = plan_matmul_tc_sm90(M, K, N, num_bufs=G, **pins)
            check(steps == plan.cta_steps(0) >= 5 and plan.cluster > 1,
                  "the tc record's k-slice is short or unsplit")
            check(G is None or g_used == G, f"ring depth {g_used} != {G}")
            check(got == chunk_issue_schedule(steps, g_used, C),
                  f"tc issue order differs at {M}x{K}x{N} G={G}")
            orders += 1
            print(f"gpp_matmul_tc issue order {M}x{K}x{N} cluster="
                  f"{plan.cluster} block_k={plan.block_k} G={g_used} (asked "
                  f"{G}) C={C} steps={steps} of {plan.num_k}: "
                  f"{sum(len(v) for v in got.values())} chunk issues == "
                  "chunk_issue_schedule")
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

def pa_inputs(B, S, positions, dtype, *, nb, seed=0, hd=HD, kvh=H, heads=H,
              max_len=MAX_LEN):
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    mb = max_len // BS
    q = torch.randn(B, S, heads, hd, generator=g, device="cuda").to(dt)
    k = (torch.randn(nb, BS, kvh, hd, generator=g, device="cuda") * 0.5
         ).to(dt)
    v = (torch.randn(nb, BS, kvh, hd, generator=g, device="cuda") * 0.5
         ).to(dt)
    perm = torch.randperm(nb - 1, generator=g, device="cuda") + 1
    tables = torch.zeros(B, mb, dtype=torch.int32, device="cuda")
    used = 0
    for b, p in enumerate(positions):
        nblk = (p + S - 1) // BS + 1
        tables[b, :nblk] = perm[used:used + nblk].int()
        used += nblk
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, k, v, tables, pos


def pa_work(positions, S, window, es, *, heads=H, kvh=H, hd=HD,
            max_len=MAX_LEN):
    """(bytes, operations) this call's data needs: each visible K/V row
    (kvh heads) read once, q / tables / positions read and the output
    written once; 2 * hd operations per (query head row, visible key) for
    q.k and again for p.v."""
    keys = set()
    pairs = 0
    for b, p in enumerate(positions):
        for s in range(S):
            lo = 0 if window is None else max(0, p + s - window + 1)
            pairs += p + s - lo + 1
            keys.update((b, t) for t in range(lo, p + s + 1))
    B = len(positions)
    nbytes = (2 * len(keys) * kvh * hd * es + 2 * B * S * heads * hd * es
              + B * (max_len // BS) * 4 + B * 4)
    return nbytes, 4.0 * pairs * heads * hd


PA_CASES = [
    ("decode", SLOTS, 1, [5, 17, 40, 100]),
    ("prefill", 1, CHUNK, [37]),             # unaligned chunk start
    ("verify", SLOTS, DRAFT + 1, [3, 30, 64, 90]),
]


# slice 11's GQA shapes: heads, kv heads, head_dim, window, max_len and
# step cases.  gemma3-12b's window layers serve a 1,200-token request
# (max_len 1280: 80 blocks, 8 runs of 10), so its cases sit past the
# 1024-token window, whose first runs are then wholly behind it; its
# global layers (no window) read the same pools.  danube's 4096-token
# window does not bind under 128 tokens: a 32-token window stands in.
LONG_CASES = [("decode", SLOTS, 1, [5, 300, 1100, 1250]),
              ("prefill", 1, CHUNK, [1100]),
              ("verify", SLOTS, DRAFT + 1, [3, 600, 1030, 1240])]
NEW_PA = {"qwen2-7b": (28, 4, 128, None, MAX_LEN, PA_CASES),
          "kimi-k2-1t-a32b": (64, 8, 128, None, MAX_LEN, PA_CASES),
          "gemma3-12b": (16, 8, 256, 1024, 1280, LONG_CASES),
          "gemma3-12b global": (16, 8, 256, None, 1280, LONG_CASES[:1]),
          "h2o-danube-1.8b": (32, 8, 80, 4096, MAX_LEN, PA_CASES),
          "h2o-danube-1.8b +window": (32, 8, 80, 32, MAX_LEN, PA_CASES)}


def fma_times(row, fn, sets, name, plan, launch, q2_sets):
    """The FMA route's times into `row`: the profiler's device time of the
    kernel and its merge (summed, then each alone), the CUDA-event time of
    a graph of launches (`launch` on pre-scaled q rows) and the plan (P,
    kv_splits, the grid, the ring, the shared memory)."""
    names = (name, KERNEL_NAMES["paged_attention_merge"])
    row["ms"], row["wall_ms"] = measure(fn, sets, names)
    row["kernel_ms"] = device_ms(fn, sets, name)
    row["merge_ms"] = (device_ms(fn, sets, names[1])
                       if plan.kv_splits > 1 else 0.0)
    row["graph_ms"] = graph_ms(launch, q2_sets)
    row["plan"] = {"piece": plan.piece, "kv_splits": plan.kv_splits,
                   "grid": list(plan.grid), "ctas": plan.ctas,
                   "num_bufs": plan.num_bufs, "smem_bytes": plan.smem_bytes}


def pa_case(name, B, S, positions, dtype, *, window=None, timed=False,
            hd=HD, kvh=H, heads=H, max_len=MAX_LEN):
    """One GQA / window comparison on the card, at every ring depth: bf16
    must launch the tensor-core kernel (kv_splits planned, 1 and 2; its
    merge with more than one run), f32 the FMA kernel (kv_splits planned,
    1, 2 and one run a piece; its merge likewise); bf16 also holds the FMA
    kernel's bf16 instance (pinned) and the merge kernel alone against
    their plain versions.  `timed` adds the kernel's device time (with its
    merge; bf16 also the FMA kernel pinned beside it), the plain
    version's, SDPA's on gathered K/V, the bound and the CUDA-event time of
    a graph of launches (tensor cores: at kv_splits 1, 2, 4 and planned).
    A bf16 head_dim the tensor-core plan does not take (80) must launch
    the FMA kernel's bf16 instance, at the same splits as f32."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.core.schedule import (plan_paged_attn_fma_sm90,
                                           plan_paged_attn_gqa_tc_sm90)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attn_ref
    mb = max_len // BS
    nb = SLOTS * mb + 1
    shape = dict(hd=hd, kvh=kvh, heads=heads, max_len=max_len)
    q, k, v, tables, pos = pa_inputs(B, S, positions, dtype, nb=nb, **shape)
    kw = dict(num_kv_heads=kvh, scale=1.0 / math.sqrt(hd), window=window)
    ref = paged_attn_ref(q, k, v, tables, pos, **kw)
    route = pa.attention_route(q.dtype, False, BS, hd, hd)
    tc = route == "gqa_tc"
    check(tc == (dtype == "bfloat16" and hd in (64, 128, 256)),
          f"gqa {name} {dtype} hd {hd}: route {route}")
    counts = (pa.launches_tc, pa.launches, pa.launches_bf16)
    fma_counts = (0, 1, 0) if dtype == "float32" else (0, 0, 1)
    errs = []

    def run(want, **extra):
        before = [c.n for c in counts]
        out = pa.paged_attention(q, k, v, tables, pos, **kw, **extra)
        torch.cuda.synchronize()
        ran = tuple(c.n - n for c, n in zip(counts, before))
        check(ran == want, f"gqa {name} {dtype} {extra} took the wrong "
                           f"kernel: {ran}")
        check(tuple(out.shape) == (B, S, heads, hd), f"gqa {name}: shape")
        check(bool(torch.isfinite(out.float()).all()),
              f"gqa {name}: non-finite")
        return float((out.float() - ref.float()).abs().max())

    fplan = plan_paged_attn_fma_sm90(
        batch=B, kv_heads=kvh, rows=heads // kvh * S, block_size=BS,
        max_blocks=mb, width=hd, kv_itemsize=q.element_size())
    for G in (None, 1, 2, 4):
        for ks in ((None, 1, 2) if tc else (None, 1, 2, fplan.pieces)):
            errs.append(run((1, 0, 0) if tc else fma_counts, num_bufs=G,
                            kv_splits=ks))
    err = max(errs)
    atol, _ = TOL[dtype]
    check(err <= atol, f"paged_attention {name} {dtype} hd {hd}: max err "
                       f"{err}")
    row = {"case": name, "B": B, "S": S, "positions": positions,
           "window": window, "dtype": dtype, "head_dim": hd, "heads": heads,
           "kv_heads": kvh, "max_len": max_len, "route": route,
           "max_abs_err": err, "tol": atol}
    if tc:
        row["fma_max_abs_err"] = run((0, 0, 1), route="gqa")
        check(row["fma_max_abs_err"] <= atol,
              f"gqa {name}: the FMA kernel's bf16 instance, max err "
              f"{row['fma_max_abs_err']}")
        plan = plan_paged_attn_gqa_tc_sm90(
            batch=B, kv_heads=kvh, rows=heads // kvh * S, block_size=BS,
            max_blocks=mb, head_dim=hd)
        row["merge_max_abs_err"] = gqa_merge_case(q, k, v, tables, pos, kw,
                                                  plan)
        row["plan"] = {"kv_splits": plan.kv_splits, "num_bufs":
                       plan.num_bufs, "ctas": plan.ctas,
                       "ctas_per_sm": plan.ctas_per_sm}
        row["ctas_per_sm"] = pa.gqa_tc_ctas_per_sm(plan)
        check(row["ctas_per_sm"] >= plan.ctas_per_sm,
              f"gqa {name}: the card holds {row['ctas_per_sm']} CTAs an SM, "
              f"planned {plan.ctas_per_sm}")
    if timed:
        es = q.element_size()
        n = copies_for(2 * k.numel() * es)
        sets = [pa_inputs(B, S, positions, dtype, nb=nb, seed=i, **shape)
                for i in range(n)]

        def call(**extra):
            return lambda q, k, v, t, p: pa.paged_attention(
                q, k, v, t, p, **kw, **extra)

        if tc:
            names = (KERNEL_NAMES["paged_attention_tc"],
                     KERNEL_NAMES["paged_attention_merge"])
            row["ms"], row["wall_ms"] = measure(call(), sets, names)
            row["kernel_ms"] = device_ms(call(), sets, names[0])
            row["merge_ms"] = (device_ms(call(), sets, names[1])
                               if plan.kv_splits > 1 else 0.0)
            row["fma_ms"], row["fma_wall_ms"] = measure(
                call(route="gqa"), sets,
                (KERNEL_NAMES["paged_attention"],
                 KERNEL_NAMES["paged_attention_merge"]))
            rows_q = [(pa._q_rows(q_, kw["scale"], kvh, q_.dtype), k_, v_,
                       t_, p_) for q_, k_, v_, t_, p_ in sets]
            row["graph_ms_by_splits"] = {}
            for ks in (1, 2, 4, None):
                p_ks = plan_paged_attn_gqa_tc_sm90(
                    batch=B, kv_heads=kvh, rows=heads // kvh * S,
                    block_size=BS, max_blocks=mb, head_dim=hd, kv_splits=ks)
                row["graph_ms_by_splits"][
                    "planned" if ks is None else str(ks)] = graph_ms(
                    lambda q2, k_, v_, t_, p_, p_ks=p_ks: pa._launch_gqa_tc(
                        q2, k_, v_, t_, p_, p_ks, S=S, window=window),
                    rows_q)
            row["graph_ms"] = row["graph_ms_by_splits"]["planned"]
        else:
            fma_times(row, call(), sets, KERNEL_NAMES["paged_attention"],
                      fplan, lambda q2, k_, v_, t_, p_: pa._launch_fma(
                          q2, k_, v_, t_, p_, fplan, S=S, window=window),
                      [(pa._q_rows(q_, kw["scale"], kvh, q_.dtype), k_, v_,
                        t_, p_) for q_, k_, v_, t_, p_ in sets])
        row["plain_ms"], row["plain_wall_ms"] = measure(
            lambda q, k, v, t, p: paged_attn_ref(q, k, v, t, p, **kw), sets)
        # yardstick: SDPA over K/V gathered through the tables beforehand
        # (each KV head repeated for its query group)
        T = max_len
        kpos = torch.arange(T, device="cuda")
        lib_sets = []
        for q_, k_, v_, t_, p_ in sets:
            kseq, vseq = (
                a[t_.long()].reshape(B, T, kvh, hd)
                .repeat_interleave(heads // kvh, dim=2).transpose(1, 2)
                for a in (k_, v_))
            qpos = p_.long()[:, None] + torch.arange(S, device="cuda")[None]
            m = kpos[None, None, :] <= qpos[:, :, None]
            if window is not None:
                m &= kpos[None, None, :] > qpos[:, :, None] - window
            lib_sets.append((q_.transpose(1, 2), kseq, vseq, m[:, None]))
        row["library_ms"], row["library_wall_ms"] = measure(
            lambda q, k, v, m: Fn.scaled_dot_product_attention(
                q, k, v, attn_mask=m, scale=kw["scale"]), lib_sets)
        nbytes, ops = pa_work(positions, S, window, es, heads=heads,
                              kvh=kvh, hd=hd, max_len=max_len)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dtype)
    print(f"paged_attention {name:14s} {dtype} {heads}/{kvh} heads hd {hd}"
          f" window {window} max_len {max_len} ({route}): "
          f"max_abs_err={err:.3g} atol={atol}"
          + (f" fma_err={row['fma_max_abs_err']:.3g} merge_err="
             f"{row['merge_max_abs_err']:.3g}" if tc else "")
          + (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
             f"library_ms={row['library_ms']:.4f} bound_ms="
             f"{row['bound_ms']:.5f} ({row['bound_by']}) "
             f"wall_ms={row['wall_ms']:.4f}"
             + (f" (kernel {row['kernel_ms']:.4f} + merge "
                f"{row['merge_ms']:.4f})")
             + (f" fma_ms={row['fma_ms']:.4f} graph_ms by kv_splits "
                f"{row['graph_ms_by_splits']}" if tc else
                f" graph_ms={row['graph_ms']:.4f} plan={row['plan']}")
             if timed else "")
          + (f" plan={row['plan']} ctas/SM={row['ctas_per_sm']}"
             if tc else ""), flush=True)
    return row


def gqa_merge_case(q, k, v, tables, pos, kw, plan):
    """The merge kernel against its plain version on the partials the
    tensor-core GQA kernel leaves at these inputs (as planned: kv_splits >
    1 at every path shape); max abs error (bf16 output, f32 plain)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import mla_merge_ref
    B, S, H_, hd = q.shape
    kvh = kw["num_kv_heads"]
    check(plan.kv_splits > 1, "the planned GQA call does not split")
    q2 = pa._q_rows(q, kw["scale"], kvh, q.dtype)
    ws = torch.empty(plan.workspace_floats(), device="cuda")
    out = torch.empty(q2.shape, dtype=torch.bfloat16, device="cuda")
    pa._launch_gqa_split(q2, k, v, tables, pos, plan, out, ws, S=S,
                         window=kw["window"])
    merged = pa.launches_merge.n
    pa._launch_merge(ws, out, plan.units, plan.row_tiles, plan.kv_splits,
                     hd, plan.rows)
    check(pa.launches_merge.n == merged + 1, "the merge did not count")
    ref = mla_merge_ref(ws, batch=B * kvh, row_tiles=plan.row_tiles,
                        kv_splits=plan.kv_splits, latent=hd, rows=plan.rows)
    torch.cuda.synchronize()
    e = float((out.reshape(B * kvh, plan.rows, hd).float() - ref).abs()
              .max())
    check(e <= TOL["bfloat16"][0], f"gqa merge: max err {e}")
    return e


def gqa_issue_order(report):
    """The tensor-core GQA kernel's issue-order record against
    `chunk_issue_schedule`, for the first run of >= 4 live blocks at the
    decode inputs: kv_splits 1 (lane 3's 7 live blocks in one run) and 2
    (its first run, 4 live blocks), G in {None, 1, 2, 4}."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import chunk_issue_schedule
    nb = SLOTS * (MAX_LEN // BS) + 1
    q, k, v, tables, pos = pa_inputs(SLOTS, 1, [5, 17, 40, 100], "bfloat16",
                                     nb=nb)
    n = 0
    for ks in (1, 2):
        for G in (None, 1, 2, 4):
            got, steps, g_used, C, cta = pa.issue_order_gqa(
                q, k, v, tables, pos, num_kv_heads=H, scale=0.125,
                num_bufs=G, kv_splits=ks)
            check(steps == (7 if ks == 1 else 4),
                  f"gqa issue order: {steps} steps recorded")
            check(G is None or g_used == min(G, 8 // ks),
                  f"gqa ring depth {g_used} != {G}")
            check(got == chunk_issue_schedule(steps, g_used, C),
                  f"gqa issue order differs at G={G} kv_splits={ks}")
            n += 1
            print(f"paged_attention_tc issue order kv_splits={ks} "
                  f"G={g_used} (asked {G}) C={C} CTA {cta} steps={steps}: "
                  f"{sum(len(v) for v in got.values())} chunk issues == "
                  "chunk_issue_schedule")
    report["paged_attention_issue_orders"] = n


def check_paged(report):
    """qwen1.5-0.5b's GQA paged attention at its three step shapes: bf16
    (the tensor-core kernel) with and without a 32-token window, f32 (the
    FMA kernel), all timed but f32 prefill and verify; then the
    tensor-core plan's other head dims (128 and 256, fewer KV heads) at
    decode and verify, and its issue order."""
    rows = []
    for name, B, S, positions in PA_CASES:
        for dtype in BOTH:
            rows.append(pa_case(name, B, S, positions, dtype,
                                timed=dtype == "bfloat16"
                                or name == "decode"))
        rows.append(pa_case(name + "+window", B, S, positions, "bfloat16",
                            window=32, timed=True))
    for hd, kvh in ((128, 4), (256, 8)):
        for name, B, S, positions in PA_CASES:
            if name != "prefill":
                for window in (None, 32):
                    rows.append(pa_case(
                        f"{name}{'+window' if window else ''}", B, S,
                        positions, "bfloat16", window=window, hd=hd,
                        kvh=kvh))
    # slice 11's archs at their own heads and windows, bf16 at the three
    # step shapes (timed at decode), f32 at decode
    for arch, (heads, kvh, hd, window, max_len, cases) in NEW_PA.items():
        for name, B, S, positions in cases:
            for dtype in BOTH:
                if dtype == "float32" and name != "decode":
                    continue
                rows.append(pa_case(
                    f"{arch} {name}", B, S, positions, dtype,
                    window=window, hd=hd, kvh=kvh, heads=heads,
                    max_len=max_len, timed=name == "decode"))
    gqa_issue_order(report)
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
    """One gpp_matmul_grouped comparison on the card at deepseek's expert
    count; max abs error (`grouped_check`)."""
    import torch
    x, w = grouped_inputs(M, K, N, dtype, seed=seed, int8=scale is not None)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    sc = None
    if scale is not None:
        shape = {"scalar": (), "expert": (DS_E,), "column": (DS_E, N)}[scale]
        sc = torch.rand(shape, generator=g, device="cuda") * 2e-3
    b = (torch.randn(DS_E, N, generator=g, device="cuda") * 0.1).to(x.dtype) \
        if bias else None
    return grouped_check(x, w, G=G, act=act, b=b, sc=sc,
                         what=f"scale={scale}")


def grouped_check(x, w, *, G=None, act=None, b=None, sc=None, what=""):
    """gpp_matmul_grouped on (E, M, K) x and (E, K, N) W against its plain
    version; max abs error.  bf16 x and W must launch the tensor-core
    kernel, anything else the FMA kernel."""
    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import dense_grouped_ref
    E, M, K = x.shape
    N = w.shape[2]
    dtype = str(x.dtype).split(".")[-1]
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
          f"gpp_matmul_grouped {E}x{M}x{K}x{N} {dtype} G={G} act={act} "
          f"{what}: max err {float(err.max())}")
    return float(err.max())


def grouped_time(M, K, N, dtype, *, sets=None, E=DS_E):
    """Kernel / plain / torch.bmm times of one (E, M, K) @ (E, K, N) launch
    at the path's shape, and its bound (every expert's W read once).  bf16
    times the tensor-core kernel, f32 the split-K FMA kernel (torch.bmm in
    f32 with TF32 off).  `sets` gives the (x, W) inputs (kimi-k2's 11.3 GB
    expert stacks: one set), else deepseek's are drawn."""
    import torch
    from repro_torch.kernels.gpp_matmul import gpp_matmul_grouped
    from repro_torch.kernels.ref import dense_grouped_ref
    es = 2 if dtype == "bfloat16" else 4
    if sets is None:
        sets = [grouped_inputs(M, K, N, dtype, seed=i)
                for i in range(copies_for(E * K * N * es))]
    name = KERNEL_NAMES["gpp_matmul_grouped_tc" if dtype == "bfloat16"
                        else "gpp_matmul_grouped"]
    ms, wall = measure(lambda x, w: gpp_matmul_grouped(x, w), sets, name)
    plain, plain_wall = measure(lambda x, w: dense_grouped_ref(x, w), sets)
    lib, lib_wall = measure(lambda x, w: torch.bmm(x, w), sets)
    b_ms, by = bound(E * (M * K + K * N + M * N) * es,
                     2.0 * E * M * K * N, dtype)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": by, "wall_ms": wall, "plain_wall_ms": plain_wall,
            "library_wall_ms": lib_wall, "kernel": name}


def grouped_issue_order(x, w, G, what, experts=1):
    """Read the first CTA's issue-order record back and compare it with
    `chunk_issue_schedule`; the run must hold more than one work item and
    at least `experts` experts.  Returns (G used, work items in the run)."""
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import chunk_issue_schedule
    got, steps, g_used, C, items, n_exp = gm.issue_order_grouped(x, w, G)
    check(G is None or g_used == G, f"{what}: ring depth {g_used} != {G}")
    check(items > 1 and n_exp >= experts,
          f"{what}: the first CTA's run holds {items} item(s) of {n_exp} "
          "expert(s)")
    check(got == chunk_issue_schedule(steps, g_used, C),
          f"{what}: issue order differs at G={G}")
    print(f"gpp_matmul_grouped issue order {what} G={g_used} (asked {G}) "
          f"C={C} steps={steps} over {items} work items of {n_exp} "
          f"expert(s): {sum(len(v) for v in got.values())} chunk issues == "
          "chunk_issue_schedule")
    return g_used, items


def check_grouped(report):
    import torch
    from repro_torch.core.schedule import (plan_grouped_tc_sm90,
                                           plan_matmul_fma_sm90)
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
                if key not in timed:
                    timed[key] = grouped_time(M, K, N, dtype)
                row.update(timed[key])
                # the card holds the CTAs an SM the plan assumed
                if dtype == "bfloat16":
                    plan = plan_grouped_tc_sm90(DS_E, M, K, N)
                    row["ctas_per_sm"] = gm.grouped_tc_ctas_per_sm(plan)
                else:
                    plan = plan_matmul_fma_sm90(M, K, N, w_itemsize=4,
                                                E=DS_E)
                    row["ctas_per_sm"] = gm.fma_ctas_per_sm(
                        plan, torch.float32, torch.float32)
                check(row["ctas_per_sm"] == plan.ctas_per_sm,
                      f"gpp_matmul_grouped {dtype} {DS_E}x{M}x{K}x{N}: "
                      f"{row['ctas_per_sm']} CTAs an SM, planned "
                      f"{plan.ctas_per_sm}")
                row["plan"] = {"block_m": plan.block_m,
                               "block_k": plan.block_k,
                               "num_bufs": plan.num_bufs, "grid": plan.grid}
                rows.append(row)
                print(f"gpp_matmul_grouped {phase:7s} {name:7s} "
                      f"{DS_E}x{M}x{K}x{N} {dtype} ({row['route']}): "
                      f"max_abs_err={err:.3g} (atol,rtol)={TOL[dtype]}"
                      f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f}"
                      f" library_ms (torch.bmm)={row['library_ms']:.4f} "
                      f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
                      f" wall_ms={row['wall_ms']:.4f} plan={row['plan']} "
                      f"ctas/SM={row['ctas_per_sm']}", flush=True)
    extra = {"tc": [], "fma": []}
    for dtype in ("bfloat16", "float32"):      # int8 W: the FMA route
        for scale in ("scalar", "expert", "column"):
            extra["fma"].append(grouped_case(DS_ROWS["decode"], DS_D, DS_F,
                                             dtype, scale=scale, act="silu"))
    for G in (None, 1, 2, 4):                  # ragged M, K, N
        extra["tc"].append(grouped_case(7, 300, 130, "bfloat16", bias=True,
                                        act="gelu", G=G))
        extra["fma"].append(grouped_case(7, 300, 130, "float32", bias=True,
                                         act="gelu", G=G))
    print("gpp_matmul_grouped int8/bias/ragged cases: "
          + ", ".join(f"{r} {len(v)} ok, max_abs_err={max(v):.3g}"
                      for r, v in extra.items()))
    # the FMA route sums split tiles in segment order: bitwise repeatable,
    # and a row's bits are the same at 8, 32 (decode, verify) and 128
    # (prefill) rows an expert, its k-cuts coming from E, K and N alone
    for name, (K, N) in DS_PROJ.items():
        x, w = grouped_inputs(DS_ROWS["prefill"], K, N, "float32", seed=7)
        y = gm.gpp_matmul_grouped(x, w, activation="silu")
        check(all(torch.equal(gm.gpp_matmul_grouped(x, w, activation="silu"),
                              y) for _ in range(3)),
              f"gpp_matmul_grouped f32 {name}: not bitwise repeatable")
        for M in (8, DS_ROWS["decode"]):
            check(torch.equal(gm.gpp_matmul_grouped(
                x[:, :M].contiguous(), w, activation="silu"), y[:, :M]),
                  f"gpp_matmul_grouped f32 {name}: a row's bits differ at "
                  f"{M} rows an expert")
        print(f"gpp_matmul_grouped f32 {name} {DS_E}x*x{K}x{N}: bitwise "
              "repeatable over 4 runs; a "
              f"row's bits equal at 8 / {DS_ROWS['decode']} / "
              f"{DS_ROWS['prefill']} rows an expert", flush=True)
        del x, w, y
    # the ring runs across work boundaries in the issue order of the
    # generalized ping-pong schedule: the tensor-core route at the path's
    # decode gate/up shape (n-tile boundaries) and at one n-tile an expert
    # (expert boundaries); the FMA route at the decode shape in f32 (tile
    # and k-split boundaries) and at one n-tile an expert (expert ones)
    orders = []
    x, w = grouped_inputs(DS_ROWS["decode"], DS_D, DS_F, "bfloat16")
    for G in (None, 1, 2, 4):
        orders.append(grouped_issue_order(x, w, G, "tc 64x32x2048x1408"))
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(600, 16, 512, generator=g, device="cuda").bfloat16()
    w = (torch.randn(600, 512, 64, generator=g, device="cuda")
         * 0.02).bfloat16()
    for G in (None, 1, 2, 4):
        orders.append(grouped_issue_order(x, w, G, "tc 600x16x512x64",
                                          experts=2))
    x, w = x.float(), w.float()
    for G in (None, 1, 2, 4):
        orders.append(grouped_issue_order(x, w, G, "fma f32 600x16x512x64",
                                          experts=3))
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


KIMI_ROWS = {"decode": 32, "prefill": 128, "verify": 32}
KIMI_PROJ = {"gate_up": (7168, KIMI_F), "down": (KIMI_F, 7168)}


def bf16_stack(E, K, N, seed):
    """A (E, K, N) bf16 weight stack drawn on the card 16 experts at a time
    (kimi-k2's 11.3 GB stacks would need 45 GB of f32 drawn at once)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.empty(E, K, N, dtype=torch.bfloat16, device="cuda")
    for e in range(0, E, 16):
        w[e:e + 16] = (torch.randn(min(16, E - e), K, N, generator=g,
                                   device="cuda") * 0.02).bfloat16()
    return w


def check_grouped_kimi(report):
    """The tensor-core gpp_matmul_grouped at kimi-k2's expert stacks (E =
    384, 7168 -> 2048 gate/up and 2048 -> 7168 down, bf16) with 32 rows an
    expert at decode and verify and 128 at prefill (dispatch groups x
    capacity, `models.moe`), at G planned, 1, 2 and 4 against the plain
    version; the planned CTAs an SM held; timed at decode and prefill
    (verify has decode's shape) beside torch.bmm and the bound."""
    import torch
    from repro_torch.core.schedule import plan_grouped_tc_sm90
    from repro_torch.kernels import gpp_matmul as gm
    rows = []
    for name, (K, N) in KIMI_PROJ.items():
        w = bf16_stack(KIMI_E, K, N, seed=21)
        timed = {}
        for phase, M in KIMI_ROWS.items():
            g = torch.Generator(device="cuda").manual_seed(22)
            x = torch.randn(KIMI_E, M, K, generator=g,
                            device="cuda").bfloat16()
            act = "silu" if name == "gate_up" else None
            err = max(grouped_check(x, w, G=G, act=act, what=f"kimi {name}")
                      for G in (None, 1, 2, 4))
            plan = plan_grouped_tc_sm90(KIMI_E, M, K, N)
            row = {"phase": phase, "proj": name, "E": KIMI_E, "M": M,
                   "K": K, "N": N, "dtype": "bfloat16", "max_abs_err": err,
                   "tol": TOL["bfloat16"], "route": "tc",
                   "ctas_per_sm": gm.grouped_tc_ctas_per_sm(plan),
                   "plan": {"block_m": plan.block_m,
                            "block_k": plan.block_k,
                            "num_bufs": plan.num_bufs}}
            check(row["ctas_per_sm"] == plan.ctas_per_sm,
                  f"gpp_matmul_grouped kimi {KIMI_E}x{M}x{K}x{N}: "
                  f"{row['ctas_per_sm']} CTAs an SM, planned "
                  f"{plan.ctas_per_sm}")
            if M not in timed:
                timed[M] = grouped_time(M, K, N, "bfloat16", sets=[(x, w)],
                                        E=KIMI_E)
            row.update(timed[M])
            rows.append(row)
            print(f"gpp_matmul_grouped kimi {phase:7s} {name:7s} "
                  f"{KIMI_E}x{M}x{K}x{N} bfloat16 (tc): max_abs_err="
                  f"{err:.3g} ms={row['ms']:.4f} plain_ms="
                  f"{row['plain_ms']:.4f} library_ms (torch.bmm)="
                  f"{row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) wall_ms={row['wall_ms']:.4f} plan="
                  f"{row['plan']} ctas/SM={row['ctas_per_sm']}", flush=True)
            del x
        del w
        torch.cuda.empty_cache()
    report["gpp_matmul_grouped_kimi"] = {"shapes": rows}
    return rows


def check_moe_layer(report, arch):
    """One full-width MoE layer of `arch` in bf16 (random weights from a
    seed), decode inputs (4 tokens) and prefill inputs (32): mode "auto"
    (the routed experts on the tensor-core kernel, the router on the FMA
    one) against mode "ref" (the plain versions), relative error of the
    layer's output; and the experts the router gave a row, so the share
    of the expert weights streamed for experts with none."""
    import dataclasses

    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import init_from_specs
    cfg = registry.get_config(arch).with_(dtype="bfloat16")
    mc = tf._moe_cfg(cfg)
    d = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(6)
    torch.cuda.reset_peak_memory_stats()
    params = init_from_specs(moe_mod.moe_specs(mc), gen,
                             torch.device("cuda"))
    out = {}
    for phase, (B, S) in (("decode", (SLOTS, 1)), ("prefill", (1, CHUNK))):
        x = torch.randn(B, S, d, generator=gen, device="cuda").bfloat16()
        tc = gm.launches_grouped_tc.n
        auto = moe_mod.moe_apply(params, mc, x)
        ran = gm.launches_grouped_tc.n - tc
        ref = moe_mod.moe_apply(
            params, dataclasses.replace(mc, dense_kernel="ref"), x)
        torch.cuda.synchronize()
        check(tuple(auto.shape) == (B, S, d)
              and bool(torch.isfinite(auto.float()).all()),
              f"{arch} MoE layer {phase}: shape or non-finite")
        rel = float((auto.float() - ref.float()).norm()
                    / ref.float().norm())
        check(ran == 3, f"{arch} MoE layer {phase}: {ran} tensor-core "
                        "launches")
        check(rel <= 1e-2, f"{arch} MoE layer {phase}: |auto - ref| / |ref| "
                           f"= {rel:.3g} > 1e-2")
        # the experts with a routed row (the kept dispatch entries)
        T = B * S
        G = moe_mod._dispatch_groups(mc, T)
        _, meta = moe_mod._dispatch(params, mc, x.reshape(G, T // G, d),
                                    moe_mod.capacity(mc, T // G))
        sorted_e, _, keep, _, _ = meta
        routed = int(torch.unique(sorted_e[keep]).numel())
        out[phase] = {"tokens": T, "rel_err": rel, "tc_launches": ran,
                      "experts": mc.num_experts, "experts_routed": routed,
                      "expert_bytes_unrouted_share":
                          1.0 - routed / mc.num_experts}
        print(f"{arch} MoE layer {phase} ({T} tokens, bf16): |auto - ref| / "
              f"|ref| = {rel:.3g} (limit 1e-2), {ran} tensor-core launches; "
              f"{routed} of {mc.num_experts} experts routed a row, "
              f"{1.0 - routed / mc.num_experts:.3f} of the expert bytes "
              "streamed for none", flush=True)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    report.setdefault("moe_layer", {})[arch] = out
    return out


# ---------------------------------------------------------------------------
# kernel 3b: MLA paged attention (deepseek-v2-lite-16b latent pools)
# ---------------------------------------------------------------------------

def mla_inputs(B, S, positions, dtype, *, nb, seed=0, bs=BS):
    """Latent pools of `bs`-token blocks, max_len max(MAX_LEN, bs)."""
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    mb = max(MAX_LEN, bs) // bs
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
              + B * (max(MAX_LEN, bs) // bs) * 4 + B * 4)
    return nbytes, 2.0 * pairs * DS_H * (DS_R + DS_RR + DS_R)


def mla_case(name, B, S, positions, dtype, *, timed=False, bs=BS):
    """One MLA comparison on the card, at every ring depth and at kv_splits
    planned, 1, 2 and the most (a run a block, or a piece): bf16 at
    `bs`-token blocks of 16-64 must launch the tensor-core kernel, bf16 at
    other block sizes the FMA kernel's bf16 instance, f32 the FMA kernel.
    `timed` adds the kernel's device time (its merge included, and each
    alone), the plain version's, SDPA's on gathered rows, the bound and
    the CUDA-event time of a graph of launches, with the FMA route's plan
    (P, kv_splits, grid)."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.core.schedule import (plan_paged_attn_fma_sm90,
                                           plan_paged_attn_mla_tc_sm90)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attn_ref
    mb = max(MAX_LEN, bs) // bs
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
    fplan = plan_paged_attn_fma_sm90(
        batch=B, kv_heads=1, rows=DS_H * S, block_size=bs, max_blocks=mb,
        width=DS_R, rope=DS_RR, mla=True, kv_itemsize=q.element_size())
    errs = []
    for G in ((None, 1, 2, 4) if bs == BS else (None, 1, 2)):
        for ks in (None, 1, 2, mb if tc else fplan.pieces):
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
                      KERNEL_NAMES["paged_attention_merge"]) if tc
           else KERNEL_NAMES["paged_attention_mla"]}
    if not tc:
        row["plan"] = {"piece": fplan.piece, "kv_splits": fplan.kv_splits,
                       "grid": list(fplan.grid)}
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
        # (the kernel and its merge, summed)
        if not tc:
            fma_times(row, lambda q, c, k, t, p: pa.paged_attention(
                q, c, k, t, p, **kw), sets, row["kernel"], fplan,
                lambda q2, c, k, t, p: pa._launch_fma(
                    q2, c, k, t, p, fplan, S=S, window=None),
                [(pa._q_rows(q_, kw["scale"], 1, q_.dtype), c_, k_, t_, p_)
                 for q_, c_, k_, t_, p_ in sets])
        else:
            row["ms"], row["wall_ms"] = measure(
                lambda q, c, k, t, p: pa.paged_attention(q, c, k, t, p,
                                                         **kw),
                sets, row["kernel"])
            row["kernel_ms"] = device_ms(
                lambda q, c, k, t, p: pa.paged_attention(q, c, k, t, p, **kw),
                sets, KERNEL_NAMES["paged_attention_mla_tc"])
            row["merge_ms"] = device_ms(
                lambda q, c, k, t, p: pa.paged_attention(q, c, k, t, p, **kw),
                sets, KERNEL_NAMES["paged_attention_merge"])
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
        T = mb * bs
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
              + f" graph_ms={row['graph_ms']:.4f} (kernel "
              f"{row['kernel_ms']:.4f} + merge {row['merge_ms']:.4f})"
              if timed else "")
          + f" plan={row['plan']}"
          + (f" ctas/SM={row['ctas_per_sm']}" if tc else ""), flush=True)
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
    merged = pa.launches_merge.n
    pa._launch_merge(ws, out, B * plan.row_tiles, plan.row_tiles,
                     plan.kv_splits, DS_R, plan.rows)
    check(pa.launches_merge.n == merged + 1, "the merge did not count")
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


# (form, kv_splits) -> (steps, CTA) of the first run of >= 4 live pieces
# at the decode positions: MLA's 8-token pieces put lane 2 (position 40: 6
# live pieces) first; GQA's 16-token pieces lane 3 (100: 7, or a run of 4)
FMA_ISSUE = {("mla", 1): (6, 2), ("mla", 2): (6, 4), ("gqa", 1): (7, 48),
             ("gqa", 2): (4, 96)}


def fma_issue_order(report):
    """The FMA kernel's issue-order record against `chunk_issue_schedule`,
    for the first run of >= 4 live pieces at the decode inputs
    (`FMA_ISSUE`): MLA in f32 and bf16 (deepseek's latent pools) and GQA in
    f32 (qwen's K / V), kv_splits 1 and 2, G in {None, 1, 2, 4}."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import chunk_issue_schedule
    nb = SLOTS * (MAX_LEN // BS) + 1
    n = 0
    for form, dtype in (("mla", "float32"), ("mla", "bfloat16"),
                        ("gqa", "float32")):
        if form == "mla":
            q, a, b, tables, pos = mla_inputs(SLOTS, 1, [5, 17, 40, 100],
                                              dtype, nb=nb)
        else:
            q, a, b, tables, pos = pa_inputs(SLOTS, 1, [5, 17, 40, 100],
                                             dtype, nb=nb)
        for ks in (1, 2):
            for G in (None, 1, 2, 4):
                got, steps, g_used, C, cta = pa.issue_order_fma(
                    q, a, b, tables, pos, num_kv_heads=1 if form == "mla"
                    else H, scale=0.05, mla=form == "mla", num_bufs=G,
                    kv_splits=ks)
                check((steps, cta) == FMA_ISSUE[(form, ks)],
                      f"fma {form} issue order: {steps} steps recorded by "
                      f"CTA {cta}")
                check(G is None or g_used == G,
                      f"fma {form} ring depth {g_used} != {G}")
                check(got == chunk_issue_schedule(steps, g_used, C),
                      f"fma {form} {dtype} issue order differs at G={G} "
                      f"kv_splits={ks}")
                n += 1
                print(f"paged_attention fma {form} {dtype} issue order "
                      f"kv_splits={ks} G={g_used} (asked {G}) C={C} CTA "
                      f"{cta} steps={steps}: "
                      f"{sum(len(v) for v in got.values())} chunk issues == "
                      "chunk_issue_schedule")
    report["paged_attention_fma_issue_orders"] = n


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
    fma_issue_order(report)
    report["paged_attention_mla"] = {"shapes": rows}
    return rows


def check_mla_blocks(report):
    """MLA at the block sizes the tensor-core kernel does not take, on the
    FMA kernel: bf16 (its bf16 instance) at 8-, 128- and 256-token blocks
    and f32 at 128 and 256 (which the whole-block design could not hold),
    at the decode, prefill (a chunk of max(32, block size) tokens, as the
    engine cuts it) and verify shapes, held against the plain version,
    each call counted on its own instance's launches alone; timed at
    decode.  A 256-token block gets max_len 256 (`mla_inputs`)."""
    rows = []
    for dtype, sizes in (("bfloat16", (8, 128, 256)),
                         ("float32", (128, 256))):
        for bs in sizes:
            chunk = max(CHUNK, bs)
            for name, B, S, positions in (
                    ("decode", SLOTS, 1, [5, 17, 40, 100]),
                    ("prefill", 1, chunk, [37] if 37 + chunk <= MAX_LEN
                     else [0]),
                    ("verify", SLOTS, DRAFT + 1, [3, 30, 64, 90])):
                rows.append(mla_case(name, B, S, positions, dtype,
                                     timed=name == "decode", bs=bs))
    report["paged_attention_mla_blocks"] = {"shapes": rows}
    return rows


def mla_merge_time(row, dtype="bfloat16"):
    """The merge kernel alone at the MLA decode shape (its inputs, the
    partials, are L2-hot on the path: the split kernel has just written
    them), beside its plain version and its bound (the live partials' acc
    and every (m, l) read once, the output written once): the bf16
    instance at the tensor-core kernel's plan, the f32 one at the FMA
    kernel's.  No one PyTorch call merges split-softmax partials:
    library_ms null."""
    import torch
    from repro_torch.core.schedule import (plan_paged_attn_fma_sm90,
                                           plan_paged_attn_mla_tc_sm90)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import mla_merge_ref
    B, S, positions = row["B"], row["S"], row["positions"]
    dt = getattr(torch, dtype)
    if dtype == "bfloat16":
        plan = plan_paged_attn_mla_tc_sm90(
            batch=B, rows=DS_H * S, block_size=BS, max_blocks=MAX_LEN // BS,
            latent=DS_R, rope=DS_RR)
        unit, floats = BS, plan.workspace_floats(DS_R)
    else:
        plan = plan_paged_attn_fma_sm90(
            batch=B, kv_heads=1, rows=DS_H * S, block_size=BS,
            max_blocks=MAX_LEN // BS, width=DS_R, rope=DS_RR, mla=True,
            kv_itemsize=4)
        unit, floats = plan.piece, plan.workspace_floats()
    g = torch.Generator(device="cuda").manual_seed(7)
    ws = torch.randn(floats, generator=g, device="cuda")
    ml = ws[plan.ctas * 16 * DS_R:].view(B, plan.row_tiles,
                                         plan.kv_splits, 16, 2)
    ml[..., 1].abs_().add_(1.0)            # l > 0
    live_runs = 0
    for b, p in enumerate(positions):      # empty runs: m = -inf, l = 0
        for s_ in range(plan.kv_splits):
            if not any(j * unit <= p + S - 1 for j in plan.run(s_)):
                ml[b, :, s_, :, 0] = float("-inf")
                ml[b, :, s_, :, 1] = 0.0
            else:
                live_runs += plan.row_tiles
    out = torch.empty((B, 1, DS_H * S, DS_R), dtype=dt, device="cuda")
    kw = dict(batch=B, row_tiles=plan.row_tiles, kv_splits=plan.kv_splits,
              latent=DS_R, rows=DS_H * S, dtype=dt)
    ms, wall = measure(lambda w: pa._launch_merge(
        w, out, B * plan.row_tiles, plan.row_tiles, plan.kv_splits, DS_R,
        plan.rows), [(ws,)], KERNEL_NAMES["paged_attention_merge"])
    plain, plain_wall = measure(lambda w: mla_merge_ref(w, **kw), [(ws,)])
    nbytes = (live_runs * 16 * DS_R * 4 + plan.ctas * 16 * 8
              + B * DS_H * S * DS_R * out.element_size())
    b_ms, by = bound(nbytes, 3.0 * live_runs * 16 * DS_R, "float32")
    return {"ms": ms, "wall_ms": wall, "plain_ms": plain,
            "plain_wall_ms": plain_wall, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "kv_splits": plan.kv_splits}


# ---------------------------------------------------------------------------
# RMSNorm (a kernel of the port alone: the reference leaves it to XLA)
# ---------------------------------------------------------------------------

# kv_norm, qwen, a q_norm, deepseek, then slice 11's d_models
RMS_WIDTHS = (DS_R, D, 1536, DS_D, *(w[0] for w in NEW_ARCHS.values()))
RMS_ROWS = (1, 4, 5, 20, 32)         # rows a step brings (decode .. prefill)
RMS_EPS = 1e-6


def rms_err(y, ref, dtype) -> "tuple[float, bool]":
    """(max abs error, within tolerance): f32 1e-5 + 1e-5 x |plain| (the
    sum's order and rsqrtf's rounding); bf16 one bf16 step of the plain
    value (2^(floor(log2 |plain|) - 7))."""
    import torch
    d = (y.float() - ref.float()).abs()
    r = ref.float().abs()
    if dtype == "float32":
        tol = 1e-5 + 1e-5 * r
    else:
        tol = torch.exp2(torch.floor(torch.log2(r.clamp(min=2.0 ** -126)))
                         - 7)
    return float(d.max()), bool((d <= tol).all())


def check_rmsnorm(report):
    """The RMSNorm kernel against its plain version at the paths' widths,
    1-32 rows, f32 and bf16, and its row invariance: a row's output bits
    are the same at 1, 5 and 32 rows, at any place in the batch, laid out
    as decode (4 lanes x 1) or verify (4 lanes x 5) steps, and as a strided
    slice of a wider row (MLA's c_kv).  Timed at both paths' decode shape
    (4 rows, bf16)."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_ref
    rows = []
    for width in RMS_WIDTHS:
        for dtype in BOTH:
            dt = getattr(torch, dtype)
            g = torch.Generator(device="cuda").manual_seed(11)
            wide = (torch.randn(32, width + 64, generator=g, device="cuda")
                    * 2).to(dt)
            x = wide[:, :width]                # strided rows
            xc = x.contiguous()
            scale = (1 + 0.1 * torch.randn(width, generator=g,
                                           device="cuda")).to(dt)
            before = rn.launches_rmsnorm.n
            err, ok = 0.0, True
            for n in RMS_ROWS:
                e, o = rms_err(rn.rmsnorm(xc[:n], scale, RMS_EPS),
                               rmsnorm_ref(xc[:n], scale, RMS_EPS), dtype)
                err, ok = max(err, e), ok and o
            check(ok, f"rmsnorm width {width} {dtype}: max err {err}")
            full = rn.rmsnorm(xc, scale, RMS_EPS)
            perm = torch.randperm(32, generator=g, device="cuda")
            lanes = xc[:20].reshape(4, 5, width)
            same = {
                "strided": torch.equal(rn.rmsnorm(x, scale, RMS_EPS), full),
                "permuted": torch.equal(rn.rmsnorm(xc[perm], scale,
                                                   RMS_EPS), full[perm]),
                "alone": all(torch.equal(
                    rn.rmsnorm(xc[i:i + 1], scale, RMS_EPS), full[i:i + 1])
                    for i in (0, 7, 31)),
                "five": torch.equal(rn.rmsnorm(xc[:5], scale, RMS_EPS),
                                    full[:5]),
                "decode_verify": torch.equal(
                    rn.rmsnorm(lanes[:, :1].contiguous(), scale,
                               RMS_EPS)[:, 0],
                    rn.rmsnorm(lanes, scale, RMS_EPS)[:, 0])}
            torch.cuda.synchronize()
            check(all(same.values()), f"rmsnorm width {width} {dtype}: a "
                                      f"row's bits depend on the batch "
                                      f"{same}")
            ran = rn.launches_rmsnorm.n - before
            check(ran == len(RMS_ROWS) + 9, f"rmsnorm: {ran} launches")
            row = {"width": width, "dtype": dtype, "rows": list(RMS_ROWS),
                   "max_abs_err": err,
                   "tol": "f32 1e-5 + 1e-5 x |plain|; bf16 one bf16 step",
                   "row_invariant": same}
            if dtype == "bfloat16" and width in (D, DS_D):
                row.update(rms_time(SLOTS, width))
            rows.append(row)
            print(f"rmsnorm width {width} {dtype}: max_abs_err={err:.3g}, "
                  f"a row's bits the same "
                  f"at 1 / 5 / 32 rows, permuted, strided, decode vs "
                  f"verify: {all(same.values())}"
                  + (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                     f"library_ms={row['library_ms']} bound_ms="
                     f"{row['bound_ms']:.5f} ({row['bound_by']}) wall_ms="
                     f"{row['wall_ms']:.4f}" if "ms" in row else ""),
                  flush=True)
    report["rmsnorm"] = {"shapes": rows}
    return rows


def rms_time(M, d):
    """Kernel / plain / F.rms_norm times of M rows of width d (bf16), and
    the bound (each row read once and written once, the scale read
    once)."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_ref
    g = torch.Generator(device="cuda").manual_seed(3)
    sets = [((torch.randn(M, d, generator=g, device="cuda")).bfloat16(),
             (1 + 0.1 * torch.randn(d, generator=g, device="cuda"))
             .bfloat16()) for _ in range(64)]
    out = {}
    out["ms"], out["wall_ms"] = measure(
        lambda x, s: rn.rmsnorm(x, s, RMS_EPS), sets,
        KERNEL_NAMES["rmsnorm"])
    out["plain_ms"], out["plain_wall_ms"] = measure(
        lambda x, s: rmsnorm_ref(x, s, RMS_EPS), sets)
    lib = getattr(Fn, "rms_norm", None)
    out["library_ms"] = None if lib is None else measure(
        lambda x, s: lib(x, (d,), s, RMS_EPS), sets)[0]
    out["bound_ms"], out["bound_by"] = bound((2 * M * d + d) * 2,
                                             4.0 * M * d, "float32")
    return out


# ---------------------------------------------------------------------------
# the paper's workload: consecutive GeMMs with streamed weights
# ---------------------------------------------------------------------------

SEQ_K, SEQ_R, SEQ_M = 4096, 8, (8, 128)  # 8 rounds of 4096 x 4096 (256 MB)
SIM_MACROS = 32            # the reference ledger's simulated macros


def check_gemm_sequence(report):
    """`kernels.ops.streamed_gemm_sequence` in bf16: x (M, 4096) against 8
    rounds of (4096 x 4096) weights, 256 MB, more than the L2, the rounds
    folded into N (one tensor-core gpp_matmul launch, 256 tiles), at M = 8
    and 128, at G = 1 (in-situ), 2 (naive ping-pong), 3 and 4 (GPP) and
    the planned G (`gpp_matmul`'s own, num_bufs None), each held against
    its plain version.  Prints the
    kernel's device time on the folded W and the whole call's (the fold
    copies W), and the achieved share of 3.35e12 B/s.  A tile's measured
    transfer (a device copy of W) and compute (the kernel's FLOP rate on
    an L2-resident 1024 x 16384 slice, 128 CTAs) go into a `TimingCache`
    as compiled samples; beside
    them, the copied simulator's bus-busy share and latency for insitu /
    naive_pp / gpp at that measured ratio (t_pim / t_rw mapped onto
    PimConfig.n_in as the reference's ledger does), and the ring depth the
    measured rates plan against the data sheet's.  Claims nothing."""
    import torch
    from repro_torch.core.analytical import PimConfig
    from repro_torch.core.schedule import TimingCache, plan_matmul_tc_sm90
    from repro_torch.core.simulator import simulate
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import dense_ref
    K = N = SEQ_K
    R = SEQ_R
    ws = bf16_stack(R, K, N, seed=31)
    w_flat = ops.fold_rounds(ws)
    wbytes = R * K * N * 2
    dst = torch.empty_like(w_flat)
    copy_ms = time_ms(lambda: dst.copy_(w_flat), [()], iters=20)
    del dst
    tcache = TimingCache()
    rows, sims = [], {}
    name = KERNEL_NAMES["gpp_matmul_tc"]
    for M in SEQ_M:
        g = torch.Generator(device="cuda").manual_seed(32)
        x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        want = dense_ref(x, w_flat).reshape(M, R, N).permute(1, 0, 2)
        analytic = ops.plan_ring_depth(M, K, 256)
        planned = plan_matmul_tc_sm90(M, K, R * N).num_bufs
        rows_m = []
        for G in dict.fromkeys((1, 2, 3, 4, planned)):
            pin = None if G == planned else G   # the planned G: unpinned
            before = gm.launches_tc.n
            y = ops.streamed_gemm_sequence(x, ws, num_bufs=pin)
            check(gm.launches_tc.n == before + 1,
                  "the GeMM sequence is not one tensor-core launch")
            err = (y.float() - want.float()).abs()
            atol, rtol = TOL["bfloat16"]
            check(tuple(y.shape) == (R, M, N)
                  and bool((err <= atol + rtol * want.float().abs()).all()),
                  f"GeMM sequence M={M} G={G}: max err {float(err.max())}")
            ms = device_ms(lambda: gm.gpp_matmul(x, w_flat, num_bufs=pin),
                           [()], name)
            call_ms, call_wall = measure(
                lambda: ops.streamed_gemm_sequence(x, ws, num_bufs=pin),
                [()])
            nbytes = wbytes + M * K * 2 + M * R * N * 2
            plan = plan_matmul_tc_sm90(M, K, R * N, num_bufs=G)
            row = {"M": M, "G": G, "planned": G == planned,
                   "max_abs_err": float(err.max()), "ms": ms,
                   "call_ms": call_ms, "call_wall_ms": call_wall,
                   "bytes": nbytes,
                   "achieved_share": nbytes / (ms * 1e-3)
                   / H100_HBM_BYTES_PER_S,
                   "plan": {"block_m": plan.block_m,
                            "block_n": plan.block_n,
                            "block_k": plan.block_k,
                            "cluster": plan.cluster, "ctas": plan.ctas}}
            rows_m.append(row)
            print(f"GeMM sequence M={M} x {R} rounds of {K}x{N} bf16 G={G}"
                  f"{' (planned)' if G == planned else ''}: kernel ms="
                  f"{ms:.4f} achieved {row['achieved_share']:.3f} of "
                  f"3.35e12 B/s; call (with the fold) ms={call_ms:.4f}; "
                  f"max_abs_err={row['max_abs_err']:.3g} plan="
                  f"{row['plan']}", flush=True)
        # one (block_k, block_n) tile of the planned launch, measured: its
        # transfer at the copy's rate, its compute at the kernel's FLOP
        # rate where W is L2-resident (a 32 MB slice, the same buffer each
        # call, 128 CTAs), so its bytes cost next to nothing
        plan = plan_matmul_tc_sm90(M, K, R * N, num_bufs=planned)
        tile_bytes = plan.block_k * plan.block_n * 2
        tile_flops = 2.0 * M * plan.block_k * plan.block_n
        hot_k, hot_n = 1024, 16384
        w_hot = w_flat[:hot_k, :hot_n].contiguous()
        x_hot = x[:, :hot_k].contiguous()
        hot_ms = device_ms(lambda: gm.gpp_matmul(x_hot, w_hot), [()], name)
        t_dma = copy_ms * 1e-3 / 2 * tile_bytes / wbytes
        t_cmp = hot_ms * 1e-3 * tile_flops / (2.0 * M * hot_k * hot_n)
        del w_hot, x_hot
        tcache.record(block_bytes=tile_bytes, compute_flops=tile_flops,
                      t_dma=t_dma, t_compute=t_cmp, measured_on="compiled")
        ratio = t_cmp / t_dma
        cfg = PimConfig()
        cfg = cfg.with_(n_in=max(1.0, ratio * cfg.size_ou / cfg.s))
        res = {st: simulate(st, cfg, SIM_MACROS, R)
               for st in ("insitu", "naive_pp", "gpp")}
        sims[M] = {
            "t_dma_s": t_dma, "t_compute_s": t_cmp, "ratio_pim_rw": ratio,
            "n_in": cfg.n_in, "l2_hot_ms": hot_ms,
            **{st: {"bus_busy_share": r.bw_busy_cycles / r.total_cycles,
                    "cycles": r.total_cycles,
                    "latency_vs_insitu": r.total_cycles
                    / res["insitu"].total_cycles}
               for st, r in res.items()},
            "measured_vs_g1": {str(r["G"]): r["ms"] / rows_m[0]["ms"]
                               for r in rows_m},
            "ring_analytic": analytic, "ring_planned": planned}
        print(f"GeMM sequence M={M}: tile {plan.block_k}x{plan.block_n} "
              f"t_dma={t_dma * 1e6:.4f} us t_compute={t_cmp * 1e6:.4f} us "
              f"(t_pim/t_rw {ratio:.4f} -> n_in {cfg.n_in:.3g}); simulator "
              + ", ".join(f"{st}: bus busy {v['bus_busy_share']:.3f}, "
                          f"latency x{v['latency_vs_insitu']:.3f}"
                          for st, v in sims[M].items() if st in res)
              + f"; measured ms / G=1: {sims[M]['measured_vs_g1']}",
              flush=True)
        rows += rows_m
        del x, y, want
    fps, bps = tcache.effective_rates()
    rings = {M: {"analytic": ops.plan_ring_depth(M, K, 256),
                 "measured": ops.plan_ring_depth(M, K, 256, timing=tcache)}
             for M in SEQ_M}
    print(f"TimingCache (compiled): effective_rates {fps:.4g} FLOP/s, "
          f"{bps:.4g} B/s; ring depth analytic vs measured {rings}",
          flush=True)
    del ws, w_flat
    torch.cuda.empty_cache()
    report["gemm_sequence"] = {
        "rows": rows, "simulator": sims, "copy_ms": copy_ms,
        "timing_samples": tcache.to_json(),
        "effective_rates": {"flops_per_s": fps, "bytes_per_s": bps},
        "ring_depth": rings}
    return rows


# ---------------------------------------------------------------------------
# the main paths: full-width models through the serving engine
# ---------------------------------------------------------------------------

# kernel counter -> profiler kernel name (the FMA kernels' bf16 instances
# share their f32 names and are told apart by their launch counters)
KERNEL_NAMES = {"gpp_matmul": "gpp_matmul_kernel",
                "gpp_matmul_tc": "gpp_matmul_tc_kernel",
                "gpp_matmul_grouped": "gpp_matmul_grouped_kernel",
                "gpp_matmul_grouped_tc": "gpp_matmul_grouped_tc_kernel",
                "paged_attention": "paged_attention_kernel",
                "paged_attention_tc": "paged_attention_tc_kernel",
                "paged_attention_mla": "paged_attention_mla_kernel",
                "paged_attention_mla_tc": "paged_attention_mla_tc_kernel",
                "paged_attention_merge": "paged_attention_merge_kernel",
                "rmsnorm": "rmsnorm_kernel"}


def counters():
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    return {"gpp_matmul": gm.launches, "gpp_matmul_tc": gm.launches_tc,
            "gpp_matmul_grouped": gm.launches_grouped,
            "gpp_matmul_grouped_tc": gm.launches_grouped_tc,
            "paged_attention": pa.launches,
            "paged_attention_bf16": pa.launches_bf16,
            "paged_attention_tc": pa.launches_tc,
            "paged_attention_mla": pa.launches_mla,
            "paged_attention_mla_bf16": pa.launches_mla_bf16,
            "paged_attention_mla_tc": pa.launches_mla_tc,
            "paged_attention_merge": pa.launches_merge,
            "rmsnorm": rn.launches_rmsnorm}


# prompt seeds of the gated bf16 spec-on == spec-off comparison, fixed
# before any run
SPEC_SEEDS = (0, 1, 2)


def random_prompts(vocab: int, requests: int = 4, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(4, 13)).tolist()
            for _ in range(requests)]


def repeated_prompts(vocab: int, requests: int = 4, seed: int = 0):
    """Prompts of one token repeated 20-40 times.  On random weights the
    greedy continuation of qwen2-7b and kimi-k2 depends on the whole
    context (after a prompt that holds its own continuation it continues
    elsewhere, and no token of it repeats in 16), so the n-gram drafter
    finds nothing to propose; after one token repeated, the continuation
    repeats too, and speculation runs verify steps."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(rng.integers(0, vocab))] * int(rng.integers(20, 41))
            for _ in range(requests)]


def serve(cfg, params, prompts, *, speculation: bool, mode: str,
          profile=False, max_new: int = 16, block_size: int = BS,
          max_len: int = MAX_LEN, on_step=None, keep_logits=False):
    """Serve `prompts` through the paged engine; `on_step(engine)` (if
    given) is called after every step.  With `keep_logits`, info["logits"]
    holds each request's (tokens, vocab) f32 rows, one an emitted token,
    the row it was sampled from."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import ServeConfig, make_engine

    engine = make_engine(cfg, params, ServeConfig(
        slots=SLOTS, max_len=max_len, block_size=block_size,
        prefill_chunk=max(CHUNK, block_size),   # a whole number of blocks
        speculation=speculation, draft_len=DRAFT, dense_kernel=mode,
        paged_attn_kernel=mode))
    rows = {}
    if keep_logits:
        sample = engine._sample

        def keep(logits_row, req):
            rows.setdefault(req.rid, []).append(
                np.array(logits_row, dtype=np.float32))
            return sample(logits_row, req)
        engine._sample = keep
    torch.cuda.synchronize()
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    for c in counters().values():
        c.n = 0
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    if on_step is None:
        engine.run()
    else:
        while engine.pending:
            engine.step()
            on_step(engine)
    results = {r: engine.result(r) for r in rids}
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
    # step-function calls: each runs one logits head
    calls = sum((m["prefill_tokens"] > 0) + (m["decode_tokens"] > 0)
                + (m["verify_tokens"] > 0) for m in engine.metrics)
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
            "block_size": block_size, "max_len": max_len,
            "tokens": ntok, "seconds": dt, "tok_s": ntok / dt,
            "steps": len(engine.metrics), "calls": calls, "launches": counts,
            "shapes": shapes, "acceptance_rate": engine.acceptance_rate(),
            "drafted_tokens": engine.metrics.total("drafted_tokens"),
            "accepted_tokens": engine.metrics.total("accepted_tokens")}
    if profile:
        info["device_busy_s"] = busy
    if keep_logits:
        info["logits"] = [np.stack(rows[r]) for r in rids]
        del engine._sample      # the wrapper holds the engine: free it now
    print(f"serve {cfg.name} ({cfg.num_layers} layers) {cfg.dtype} "
          f"spec={speculation} mode={mode} block={block_size}: {ntok} "
          f"tokens in {dt:.3f}s = "
          f"{ntok / dt:.1f} tok/s, {len(engine.metrics)} steps, launches "
          f"{counts}, shapes {shapes}, acceptance "
          f"{engine.acceptance_rate():.2f}")
    del engine
    torch.cuda.empty_cache()
    return streams, info


# the FMA kernels' bf16 instances count launches on their own counters but
# run under their f32 instances' names
INSTANCE_OF = {"paged_attention_bf16": "paged_attention",
               "paged_attention_mla_bf16": "paged_attention_mla"}


# f32 kernel vs plain: each emitted token's logits row within this share
# of the row's largest |logit|
LOGITS_RTOL = 1e-3


def check_logits(what: str, ker: dict, ref: dict) -> dict:
    """The f32 kernel run's logits rows against the plain run's, one row an
    emitted token (the streams are equal, so both rows saw the same
    context): max |difference| / max |plain logit| gated at LOGITS_RTOL,
    so a fault shows whatever the argmax margin.  On random weights the
    greedy streams can collapse into a few repeated tokens with a wide
    margin, which equal streams alone would not catch; the least top-1
    margin (over the same scale) and the distinct tokens a stream are
    reported beside it."""
    import numpy as np
    err, margin = 0.0, float("inf")
    for a, b in zip(ker.pop("logits"), ref.pop("logits")):
        check(a.shape == b.shape, f"{what}: logits rows {a.shape} vs "
                                  f"{b.shape}")
        scale = np.abs(b).max(axis=1)
        err = max(err, float((np.abs(a - b).max(axis=1) / scale).max()))
        top2 = np.partition(b, -2, axis=1)[:, -2:]
        margin = min(margin, float((np.abs(top2[:, 1] - top2[:, 0])
                                    / scale).min()))
    out = {"logits_max_rel_err": err, "least_top1_margin": margin}
    print(f"{what}: logits max |kernel - plain| / max |logit| = {err:.3g} "
          f"(gate {LOGITS_RTOL}), least top-1 margin {margin:.3g}",
          flush=True)
    check(err <= LOGITS_RTOL, f"{what}: logits differ by {err:.3g} of the "
                              f"row's scale (gate {LOGITS_RTOL})")
    return out


def check_serving(report, arch: str, path_kernels, f32_kernels,
                  f32_layers=None, *, bf16_layers=None, long=None,
                  f32_note=None, repeat=False):
    """bf16 serve (spec off, on, profiled) at full width (at `bf16_layers`
    layers if set, else full depth), then f32 kernel vs plain greedy
    streams (at `f32_layers` layers if set; skipped, with `f32_note`
    printed, when `f32_kernels` is None).  Every kernel in `path_kernels`
    must launch in the bf16 runs and no other (with device time under the
    path's names only); every kernel in `f32_kernels` must launch in the
    f32 kernel run.  bf16 greedy streams with speculation on must equal
    those with it off, at every prompt seed of SPEC_SEEDS (the reference
    guarantees it: a token's row is the same bits in a decode step and in a
    verify step), and some seed's speculating run must accept drafts.  The
    prompts hold each one's greedy continuation, or with `repeat` are one
    token repeated (`repeated_prompts`, which makes the drafter draft on
    these archs); the f32 comparison then takes `random_prompts`.  The f32
    runs' logits rows must agree too (`check_logits`).
    `long(cfg, params)`, if given, runs on each model while it is resident
    and its result goes into the report."""
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
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cfg, params = model("bfloat16", bf16_layers)
    runs["bf16_params_gb"] = (torch.cuda.memory_allocated() - before) / 1e9
    # a warm-up run on random prompts (library loading, kernel attributes
    # and the caching allocator's first blocks are not the main path's
    # cost); the measured prompts then hold each one's greedy continuation,
    # so the n-gram drafter has drafts and speculation runs verify steps
    spec_equal, accepted = {}, {}
    for seed in SPEC_SEEDS:
        if repeat:
            seeded = repeated_prompts(cfg.vocab_size, seed=seed)
            serve(cfg, params, seeded, speculation=False, mode="auto")
        else:
            base = random_prompts(cfg.vocab_size, seed=seed)
            first, _ = serve(cfg, params, base, speculation=False,
                             mode="auto")
            seeded = [p + s + p[-3:] for p, s in zip(base, first)]
        off, r_off = serve(cfg, params, seeded, speculation=False,
                           mode="auto")
        on, r_on = serve(cfg, params, seeded, speculation=True, mode="auto")
        spec_equal[seed] = off == on
        accepted[seed] = r_on["accepted_tokens"]
        print(f"{arch} bf16 greedy streams spec on == off, prompt seed "
              f"{seed}: {off == on} ({r_on['accepted_tokens']} of "
              f"{r_on['drafted_tokens']} drafts accepted)", flush=True)
        if seed == SPEC_SEEDS[0]:
            prompts, plain = seeded, off
            runs["bf16"], runs["bf16_spec"] = r_off, r_on
    named = {INSTANCE_OF.get(k, k) for k in path_kernels}
    for key in ("bf16", "bf16_spec"):
        counts = runs[key]["launches"]
        for k, n in counts.items():
            check((n > 0) == (k in path_kernels),
                  f"{k} launched {n} times on the {arch} path ({key})")
        # bf16 projections run the tensor-core gpp_matmul; the FMA one runs
        # the f32 logits head, one a step-function call, and the MoE
        # models' f32 router, one a MoE layer (three grouped launches)
        calls = runs[key]["calls"]
        check(counts["gpp_matmul"]
              == calls + counts["gpp_matmul_grouped_tc"] // 3,
              f"{arch} ({key}): {counts['gpp_matmul']} FMA gpp_matmul "
              f"launches for {calls} heads and "
              f"{counts['gpp_matmul_grouped_tc']} grouped launches")
    check(runs["bf16"]["shapes"]["decode"] == 1
          and runs["bf16_spec"]["shapes"]["verify"] == 1,
          f"{arch}: the decode or the verify shape did not run")
    check(all(spec_equal.values()),
          f"{arch}: bf16 greedy streams with speculation on differ from "
          f"those with it off at prompt seeds "
          f"{[k for k, v in spec_equal.items() if not v]}")
    check(sum(accepted.values()) > 0,
          f"{arch}: no speculating run accepted a draft ({accepted})")
    # the same bf16 run again under torch.profiler: device time by kernel,
    # over the wall time of the unprofiled run (same work, same shapes)
    again, prof = serve(cfg, params, prompts, speculation=False,
                        mode="auto", profile=True)
    check(again == plain, f"{arch}: the profiled run's streams differ")
    busy = prof["device_busy_s"]
    for k in KERNEL_NAMES:
        check((busy[k] > 0) == (k in named),
              f"{arch}: {busy[k]} s of device time under {KERNEL_NAMES[k]}")
    share = sum(busy.values()) / runs["bf16"]["seconds"]
    runs["bf16"]["device_busy_s"] = busy
    runs["bf16"]["gpp_matmul_device_s"] = busy["gpp_matmul"] + \
        busy["gpp_matmul_tc"]
    runs["bf16"]["attention_device_s"] = sum(
        v for k, v in busy.items() if k.startswith("paged_attention"))
    runs["bf16"]["device_busy_share"] = share
    runs["bf16"]["total_params"] = cfg.total_params()
    if long is not None:
        runs["long_bf16"] = long(cfg, params)
    runs["bf16"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{arch} bf16 decode run device time: {busy} s; under gpp_matmul "
          f"{runs['bf16']['gpp_matmul_device_s']:.4f} s, paged attention "
          f"{runs['bf16']['attention_device_s']:.4f} s; busy share "
          f"{share:.3f} of {runs['bf16']['seconds']:.3f}s wall; "
          f"{cfg.num_layers} layers, {runs['bf16_params_gb']:.1f} GB of "
          f"weights; peak memory {runs['bf16']['peak_mem_gb']:.1f} GB")
    del params
    torch.cuda.empty_cache()

    if f32_kernels is None:
        print(f"{arch} f32 kernel-vs-plain streams: not on the card "
              f"({f32_note})")
        runs["f32_note"] = f32_note
    else:
        cfg, params = model("float32", f32_layers)
        f32_prompts = (random_prompts(cfg.vocab_size, seed=SPEC_SEEDS[0])
                       if repeat else prompts)
        f32_kernel, runs["f32_kernel"] = serve(cfg, params, f32_prompts,
                                               speculation=False,
                                               mode="auto", keep_logits=True)
        f32_ref, runs["f32_ref"] = serve(cfg, params, f32_prompts,
                                         speculation=False, mode="ref",
                                         keep_logits=True)
        check(not any(runs["f32_ref"]["launches"].values()),
              "the plain run launched a kernel")
        for k in f32_kernels:
            check(runs["f32_kernel"]["launches"][k] > 0,
                  f"{k} never launched on the {arch} f32 kernel run")
        check(f32_kernel == f32_ref,
              f"{arch} f32 greedy streams differ: kernel {f32_kernel} ref "
              f"{f32_ref}")
        runs["f32_logits"] = check_logits(f"{arch} f32", runs["f32_kernel"],
                                          runs["f32_ref"])
        runs["f32_logits"]["distinct"] = [len(set(t)) for t in f32_kernel]
        print(f"{arch} f32 greedy streams kernel == plain: True "
              f"({cfg.num_layers} layers)")
        if long is not None:
            runs["long_f32"] = long(cfg, params)
        del params
        torch.cuda.empty_cache()
    report.setdefault("serving", {})[arch] = runs
    report.setdefault("bf16_spec_equal", {})[arch] = spec_equal
    runs["accepted_by_seed"] = accepted
    return runs


LONG_PROMPT, LONG_MAX_LEN = 1200, 1280


def window_long_run(cfg, params):
    """gemma3-12b past its window: one request with a 1,200-token prompt
    and 3 short ones, 16 new tokens each, max_len 1280 (80 blocks; the
    tensor-core plan cuts a lane's table into 8 runs of 10 blocks, so at
    decode the first run, positions 0-159, lies wholly behind the
    1024-token window and the window layers read zeroed table entries).
    bf16: speculation on == off, and the window group's blocks a lane maps
    stay at most ceil(1024 / 16) + 2 while the global group's grow with
    the context; f32: the kernel run's greedy streams equal the plain
    run's (the FMA GQA kernel at head_dim 256 with the window)."""
    import numpy as np
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, LONG_PROMPT).tolist()] + \
        random_prompts(cfg.vocab_size, requests=3, seed=13)
    horizons = tf.group_horizons(cfg)
    peak = [0] * len(horizons)

    def track(engine):
        for gi, g in enumerate(engine.kv.groups):
            peak[gi] = max([peak[gi]] + [len(g.blocks_for(lane))
                                         for lane in range(SLOTS)])

    kw = dict(max_len=LONG_MAX_LEN, on_step=track)
    out = {"prompt_tokens": [len(p) for p in prompts],
           "horizons": list(horizons)}
    if cfg.dtype == "bfloat16":
        off, r_off = serve(cfg, params, prompts, speculation=False,
                           mode="auto", **kw)
        on, r_on = serve(cfg, params, prompts, speculation=True,
                         mode="auto", **kw)
        check(off == on, f"{cfg.name} past its window: bf16 streams with "
                         "speculation on differ from those with it off")
        check(r_on["accepted_tokens"] > 0,
              f"{cfg.name} past its window: no draft accepted")
        win = math.ceil(cfg.window_size / BS) + 2
        need = math.ceil((LONG_PROMPT + 15) / BS)
        for h, p in zip(horizons, peak):
            check(p <= win if h else p >= need,
                  f"{cfg.name} past its window: group {h} mapped {p} "
                  f"blocks a lane (window bound {win}, context {need})")
        out.update(spec_equal=True, launches=r_off["launches"],
                   seconds=r_off["seconds"], tok_s=r_off["tok_s"],
                   peak_blocks_by_group=peak, window_bound=win,
                   context_blocks=need,
                   acceptance_rate=r_on["acceptance_rate"])
    else:
        ker, r_k = serve(cfg, params, prompts, speculation=False,
                         mode="auto", keep_logits=True, **kw)
        ref, r_ref = serve(cfg, params, prompts, speculation=False,
                           mode="ref", keep_logits=True, **kw)
        check(r_k["launches"]["paged_attention"] > 0,
              f"{cfg.name} past its window (f32): no FMA GQA launch")
        check(ker == ref, f"{cfg.name} past its window: f32 kernel streams "
                          f"{ker} differ from plain {ref}")
        out["logits"] = check_logits(f"{cfg.name} past its window f32",
                                     r_k, r_ref)
        out["logits"]["distinct"] = [len(set(t)) for t in ker]
        out.update(streams_equal_plain=True, launches=r_k["launches"],
                   seconds=r_k["seconds"], peak_blocks_by_group=peak)
    print(f"{cfg.name} ({cfg.num_layers} layers) {cfg.dtype} past its "
          f"window: prompts {out['prompt_tokens']}, max_len {LONG_MAX_LEN}, "
          f"blocks a lane by group {dict(zip(map(str, horizons), peak))}"
          + (f" (window bound {out['window_bound']}), spec on == off"
             if cfg.dtype == "bfloat16" else ", kernel == plain"),
          flush=True)
    return out


def check_mla_block_sizes(report):
    """deepseek-v2-lite-16b at full width, 4 of its 27 layers (1 dense + 3
    MoE), served with 8- and 128-token KV blocks, which the tensor-core MLA
    kernel does not take: bf16 must run the FMA MLA kernel's bf16 instance
    (its own count) and its merge, and neither tensor-core MLA kernel nor
    the f32 instance; f32 at 8- and 128-token blocks (the FMA kernel
    streams a block in pieces) must run the f32 instance and its merge and
    give the plain run's greedy streams.  The bf16 streams are set beside
    the plain bf16 run's, not gated (bf16 rounds differently in the
    two)."""
    import torch
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    arch = "deepseek-v2-lite-16b"
    out = {}
    for dtype, sizes in (("bfloat16", (8, 128)), ("float32", (8, 128))):
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
            check(c[mla] > 0 and c["paged_attention_merge"] > 0 and all(
                c[k] == 0 for k in ("paged_attention_mla_tc",
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
    head_rows = check_head(report)
    pa_rows = check_paged(report)
    rms_rows = check_rmsnorm(report)
    grouped_rows, grouped_err = check_grouped(report)
    check_moe_layer(report, "deepseek-v2-lite-16b")
    mla_rows = check_mla(report)
    mla_block_rows = check_mla_blocks(report)
    kimi_grouped_rows = check_grouped_kimi(report)
    check_moe_layer(report, "kimi-k2-1t-a32b")
    seq_rows = check_gemm_sequence(report)
    gqa_path = ("gpp_matmul_tc", "gpp_matmul", "paged_attention_tc",
                "paged_attention_merge", "rmsnorm")
    gqa_f32 = ("gpp_matmul", "paged_attention", "paged_attention_merge",
               "rmsnorm")
    qwen = check_serving(report, "qwen1.5-0.5b", gqa_path, gqa_f32)
    deepseek = check_serving(report, "deepseek-v2-lite-16b",
                             ("gpp_matmul_tc", "gpp_matmul",
                              "gpp_matmul_grouped_tc",
                              "paged_attention_mla_tc",
                              "paged_attention_merge", "rmsnorm"),
                             ("gpp_matmul", "gpp_matmul_grouped",
                              "paged_attention_mla", "paged_attention_merge",
                              "rmsnorm"),
                             f32_layers=4)
    blocks = check_mla_block_sizes(report)
    # slice 11: qwen2-7b (query group 7) and h2o-danube-1.8b (head_dim 80:
    # the FMA kernel's bf16 instance) at full width and depth, f32 too;
    # gemma3-12b at full width and depth in bf16, 12 layers in f32 (two
    # 5:1 superblocks; 48 in f32 is 47 GB), both also past its window;
    # kimi-k2 at full width with 2 of its 61 layers (the dense prefix layer
    # and one MoE layer of 384 experts: 1.03 T parameters fit no card)
    # (their spec on == off prompts: one token repeated,
    # `repeated_prompts`).  danube's 4096-token window does not bind under
    # max_len 128: its expiry is exercised at SMOKE on the CPU
    # (tests/test_torch_serving.py) and, on the card, by the same kernels
    # on gemma3's run past its window
    check_serving(report, "qwen2-7b", gqa_path, gqa_f32, repeat=True)
    check_serving(report, "h2o-danube-1.8b",
                  ("gpp_matmul_tc", "gpp_matmul", "paged_attention_bf16",
                   "paged_attention_merge", "rmsnorm"), gqa_f32, repeat=True)
    check_serving(report, "gemma3-12b", gqa_path, gqa_f32, f32_layers=12,
                  long=window_long_run, repeat=True)
    check_serving(report, "kimi-k2-1t-a32b",
                  ("gpp_matmul_tc", "gpp_matmul", "gpp_matmul_grouped_tc",
                   "paged_attention_tc", "paged_attention_merge", "rmsnorm"),
                  None, bf16_layers=2, repeat=True,
                  f32_note="2 layers in f32 are 80 GB; kimi-k2's f32 parity "
                           "with the reference stands on the CPU at SMOKE "
                           "(tests/test_torch_models.py, "
                           "test_torch_serving.py)")

    g = next(r for r in gpp_rows if r["path"] == "qwen1.5-0.5b"
             and r["phase"] == "decode" and r["proj"] == "gate_up"
             and r["dtype"] == "bfloat16")
    gr = next(r for r in gpp_rows if r["proj"] == "router"
              and r["phase"] == "decode")
    p = next(r for r in pa_rows if r["case"] == "decode"
             and r["dtype"] == "bfloat16" and r["head_dim"] == HD)
    pf = next(r for r in pa_rows if r["case"] == "decode"
              and r["dtype"] == "float32")
    pb = next(r for r in pa_rows if r["case"] == "h2o-danube-1.8b decode"
              and r["dtype"] == "bfloat16")
    at_new = ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
    pa_new = {f"{r['case']} {r['dtype']} {r['heads']}/{r['kv_heads']}x"
              f"{r['head_dim']} window {r['window']}":
              {k: r[k] for k in at_new} for r in pa_rows
              if r["case"].split()[0] in NEW_ARCHS and "ms" in r}
    gpp_new = {f"{r['path']} {r['proj']} {r['M']}x{r['K']}x{r['N']} "
               f"{r['dtype']}": {k: r[k] for k in at_new}
               for r in gpp_rows if r["path"] in NEW_ARCHS and "ms" in r}
    seq = {f"M={r['M']} G={r['G']}{' planned' if r['planned'] else ''}":
           {k: r[k] for k in ("ms", "call_ms", "achieved_share")}
           for r in seq_rows}
    rq = next(r for r in rms_rows if r["width"] == D
              and r["dtype"] == "bfloat16")
    gg = next(r for r in grouped_rows if r["phase"] == "decode"
              and r["proj"] == "gate_up" and r["dtype"] == "bfloat16")
    gf = next(r for r in grouped_rows if r["phase"] == "decode"
              and r["proj"] == "gate_up" and r["dtype"] == "float32")
    m = next(r for r in mla_rows if r["case"] == "decode"
             and r["dtype"] == "bfloat16")
    mf = next(r for r in mla_rows if r["case"] == "decode"
              and r["dtype"] == "float32")
    mla_bf16_rows = [r for r in mla_block_rows if r["dtype"] == "bfloat16"]
    mb8 = next(r for r in mla_bf16_rows if r["case"] == "decode"
               and r["block_size"] == 8)
    mla_decode = {f"{r['dtype']} block {r['block_size']}": {
        k: r[k] for k in ("ms", "kernel_ms", "merge_ms", "graph_ms",
                          "plain_ms", "library_ms", "bound_ms", "plan")}
        for r in mla_rows + mla_block_rows
        if r["case"] == "decode" and r["route"] == "mla"}
    mm = mla_merge_time(m)
    mm32 = mla_merge_time(mf, "float32")
    report["paged_attention_merge"] = {"bfloat16": mm, "float32": mm32}
    for dt, r in (("bf16", mm), ("f32", mm32)):
        print(f"paged_attention_merge {dt} MLA decode (kv_splits "
              f"{r['kv_splits']}): ms={r['ms']:.4f} plain_ms="
              f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) wall_ms={r['wall_ms']:.4f}")
    numbers = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    serving = report["serving"]

    def by_path(counter, f32=False):
        """{path: launches of `counter`} over every served path that ran
        it: the bf16 runs (and gemma3's long run) or the f32 kernel runs."""
        keys = (("f32_kernel", " in f32 ({} layers)"),
                ("long_f32", " past its window in f32 ({} layers)")) if f32 \
            else (("bf16", ""), ("long_bf16", " past its window"))
        out = {}
        for arch, runs in serving.items():
            for key, label in keys:
                n = runs.get(key, {}).get("launches", {}).get(counter, 0)
                if n:
                    layers = runs.get("f32_kernel", runs["bf16"])[
                        "num_layers"]
                    out[arch + label.format(layers)] = n
        return out

    tc_by_path = by_path("gpp_matmul_tc")
    fma_by_path = {**by_path("gpp_matmul"), **by_path("gpp_matmul", True)}
    head_by_shape = {f"{r['arch']} {r['phase']} {r['M']}x{r['K']}x{r['N']}":
                     {k: r[k] for k in ("ms", "library_ms", "plain_ms",
                                        "bound_ms")}
                     for r in head_rows}
    grouped_fma_by_shape = {
        f"{r['phase']} {r['proj']} {r['E']}x{r['M']}x{r['K']}x{r['N']}":
            {k: r[k] for k in ("ms", "library_ms", "plain_ms", "bound_ms",
                               "plan", "ctas_per_sm")}
        for r in grouped_rows if r["dtype"] == "float32"}
    kernels = [
        {"name": "gpp_matmul_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul.cu",
         "replaces": "src/repro/kernels/gpp_matmul.py:408",
         "kernel": "gpp_matmul_tc_kernel (bf16 x and W; cluster split-K, "
                   "partials summed in rank order through distributed "
                   "shared memory)",
         "path": ", ".join(serving),
         "launches": sum(tc_by_path.values()),
         "launches_by_path": tc_by_path,
         "max_abs_err": gpp_err["tc"],
         "tol": "atol 2e-2 + rtol 2e-2 x |plain| (bf16)",
         "shape": f"qwen decode up-projection {g['M']}x{g['K']}x{g['N']} "
                  "bf16 (every shape of both paths: --json-out)",
         "fma_ms": g["fma_ms"],
         "slice11_decode_shapes": gpp_new,
         "gemm_sequence": seq,
         "worst_prefill_verify_vs_library": max(
             (r["ms"] / r["library_ms"], f"{r['path']} {r['phase']} "
              f"{r['proj']} {r['M']}x{r['K']}x{r['N']}")
             for r in gpp_rows if r["dtype"] == "bfloat16"
             and r["phase"] != "decode" and "ms" in r),
         **{k: g[k] for k in numbers}},
        {"name": "gpp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul.cuh",
         "replaces": "src/repro/kernels/gpp_matmul.py:408",
         "kernel": "gpp_matmul_kernel (f32 x, or f32 / int8 W; the split-K "
                   "FMA body of gpp_matmul.cuh at E = 1, split tiles "
                   "summed by their last CTA)",
         "path": "every served path (its f32 logits head; the MoE "
                 "models' f32 router); f32 runs",
         "launches": sum(by_path("gpp_matmul").values()),
         "launches_by_path": fma_by_path,
         "max_abs_err": max(gpp_err["fma"],
                            max(r["max_abs_err"] for r in head_rows)),
         "tol": "atol 2e-4 + rtol 2e-4 x |plain| (f32); bf16 and int8 W as "
                "bf16",
         "shape": f"deepseek decode router {gr['M']}x{gr['K']}x{gr['N']} "
                  "f32 (prefill / verify, every f32 decode shape and the "
                  "heads: --json-out)",
         "graph_ms": gr["graph_ms"],
         "library_graph_ms": gr["library_graph_ms"],
         "router_ms_by_phase": {r["phase"]: r["ms"] for r in gpp_rows
                                if r["proj"] == "router"
                                and r["path"] == "deepseek-v2-lite-16b"},
         "logits_head": head_by_shape,
         **{k: gr[k] for k in numbers}},
        {"name": "paged_attention_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341",
         "kernel": "paged_attention_tc_kernel (bf16 GQA / window, split-KV "
                   "over fixed block runs; ms includes its merge kernel's)",
         "path": ", ".join(by_path("paged_attention_tc")),
         "launches": sum(by_path("paged_attention_tc").values()),
         "launches_by_path": by_path("paged_attention_tc"),
         "max_abs_err": max(r["max_abs_err"] for r in pa_rows
                            if r["route"] == "gqa_tc"),
         "tol": "atol 2e-2 (bf16); decode / prefill / verify, window 32 or "
                "none, head_dim 64 / 128 / 256",
         "shape": f"decode B={SLOTS} H={H} hd={HD} positions "
                  f"{p['positions']} bf16",
         "fma_ms": p["fma_ms"],
         "slice11_shapes": {k: v for k, v in pa_new.items()
                            if "bfloat16" in k},
         **{k: p[k] for k in numbers}},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341",
         "kernel": "paged_attention_kernel (f32 GQA / window, FMA, "
                   "split-KV over fixed runs of pieces; ms includes its "
                   "merge kernel's)",
         "path": ", ".join(by_path("paged_attention", True)),
         "launches": sum(by_path("paged_attention", True).values()),
         "launches_by_path": by_path("paged_attention", True),
         "max_abs_err": max(r["max_abs_err"] for r in pa_rows
                            if r["route"] == "gqa"),
         "shape": f"decode B={SLOTS} H={H} hd={HD} positions "
                  f"{pf['positions']} f32",
         **{k: pf[k] for k in ("kernel_ms", "merge_ms", "graph_ms",
                               "plan")},
         **{k: pf[k] for k in numbers}},
        {"name": "paged_attention_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341",
         "kernel": "paged_attention_kernel, bf16 instance (FMA, split-KV "
                   "over fixed runs of pieces; bf16 GQA at head dims the "
                   "tensor-core kernel does not take; ms includes its "
                   "merge kernel's)",
         "path": ", ".join(by_path("paged_attention_bf16")),
         "launches": sum(by_path("paged_attention_bf16").values()),
         "launches_by_path": by_path("paged_attention_bf16"),
         "max_abs_err": max(r["max_abs_err"] for r in pa_rows
                            if r["route"] == "gqa"
                            and r["dtype"] == "bfloat16"),
         "tol": "atol 2e-2 (bf16); decode / prefill / verify, window 4096 "
                "and 32",
         "shape": f"danube decode B={pb['B']} H={pb['heads']} kv "
                  f"{pb['kv_heads']} hd={pb['head_dim']} positions "
                  f"{pb['positions']} bf16",
         **{k: pb[k] for k in ("kernel_ms", "merge_ms", "graph_ms",
                               "plan")},
         **{k: pb[k] for k in numbers}},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "none: a kernel of the port alone (the reference's "
                     "RMSNorm, src/repro/models/layers.py:60, is XLA's)",
         "kernel": "rmsnorm_kernel (row-invariant: a CTA a row, threads "
                   "from the width)",
         "path": ", ".join(serving),
         "launches": sum(by_path("rmsnorm").values()),
         "launches_by_path": by_path("rmsnorm"),
         "max_abs_err": max(r["max_abs_err"] for r in rms_rows),
         "tol": "f32 1e-5 + 1e-5 x |plain|; bf16 one bf16 step",
         "shape": f"qwen decode {SLOTS}x{D} bf16 (widths 512-2048, 1-32 "
                  "rows: --json-out)",
         **{k: rq[k] for k in numbers}},
        {"name": "gpp_matmul_grouped", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul_grouped.cu",
         "replaces": "src/repro/kernels/gpp_matmul.py:606",
         "kernel": "gpp_matmul_grouped_tc_kernel (bf16 x and W)",
         "path": ", ".join(by_path("gpp_matmul_grouped_tc")),
         "launches": sum(by_path("gpp_matmul_grouped_tc").values()),
         "launches_by_path": by_path("gpp_matmul_grouped_tc"),
         "kimi_by_shape": {
             f"{r['phase']} {r['proj']} {r['E']}x{r['M']}x{r['K']}x{r['N']}":
                 {k: r[k] for k in ("ms", "library_ms", "plain_ms",
                                    "bound_ms", "max_abs_err")}
             for r in kimi_grouped_rows},
         "expert_bytes_unrouted_share": {
             arch: {ph: v["expert_bytes_unrouted_share"]
                    for ph, v in out.items() if ph != "peak_mem_gb"}
             for arch, out in report["moe_layer"].items()},
         "max_abs_err": grouped_err["tc"],
         "shape": f"decode gate/up {gg['E']}x{gg['M']}x{gg['K']}x{gg['N']} "
                  "bf16",
         **{k: gg[k] for k in numbers}},
        {"name": "gpp_matmul_grouped_fma", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul.cuh",
         "replaces": "src/repro/kernels/gpp_matmul.py:606",
         "kernel": "gpp_matmul_grouped_kernel (f32 x, or f32 / int8 W; the "
                   "split-K FMA body of gpp_matmul.cuh over the expert "
                   "axis)",
         "path": "deepseek-v2-lite-16b in f32 "
                 f"({deepseek['f32_kernel']['num_layers']} layers)",
         "launches":
             deepseek["f32_kernel"]["launches"]["gpp_matmul_grouped"],
         "max_abs_err": grouped_err["fma"],
         "tol": "atol 2e-4 + rtol 2e-4 x |plain| (f32); bf16 x as bf16",
         "shape": f"decode gate/up {gf['E']}x{gf['M']}x{gf['K']}x{gf['N']} "
                  "f32 (library: torch.bmm, TF32 off)",
         "by_shape": grouped_fma_by_shape,
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
        {"name": "paged_attention_merge", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (the split "
                     "walks' merge, for mla=True and GQA)",
         "kernel": "paged_attention_merge_kernel (f32 partials -> bf16)",
         "path": ", ".join(serving),
         "launches": sum(by_path("paged_attention_merge").values()),
         "launches_by_path": by_path("paged_attention_merge"),
         "max_abs_err": max(r["merge_max_abs_err"] for r in mla_rows + pa_rows
                            if "merge_max_abs_err" in r),
         "shape": f"MLA decode B={SLOTS} H={DS_H} latent {DS_R}, "
                  f"{mm['kv_splits']} partials a row (alone; its time is "
                  "also inside paged_attention_mla_tc's and, as "
                  "gqa_merge_ms, paged_attention_tc's)",
         "gqa_merge_ms": p["merge_ms"],
         **{k: mm[k] for k in numbers}},
        {"name": "paged_attention_merge_f32", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (the split "
                     "walks' merge, for mla=True and GQA)",
         "kernel": "paged_attention_merge_kernel, f32 instance (f32 "
                   "partials -> f32, after the FMA kernels in f32)",
         "path": "every f32 run",
         "launches": sum(by_path("paged_attention_merge", True).values()),
         "launches_by_path": {
             **by_path("paged_attention_merge", True),
             **{f"deepseek-v2-lite-16b (4 layers) {k}":
                v["launches"]["paged_attention_merge"]
                for k, v in blocks.items() if k.startswith("float32")}},
         "max_abs_err": max(r["max_abs_err"] for r in mla_rows + pa_rows
                            if r["dtype"] == "float32"),
         "tol": "inside the FMA kernels' f32 rows (atol 2e-4)",
         "shape": f"MLA decode B={SLOTS} H={DS_H} latent {DS_R}, "
                  f"{mm32['kv_splits']} partials a row (alone; its time is "
                  "also inside paged_attention_mla's and "
                  "paged_attention's)",
         **{k: mm32[k] for k in numbers}},
        {"name": "paged_attention_mla", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (mla=True, "
                     ":173-177)",
         "kernel": "paged_attention_mla_kernel (f32, FMA, split-KV over "
                   "fixed runs of pieces; ms includes its merge kernel's)",
         "path": "deepseek-v2-lite-16b in f32 "
                 f"({deepseek['f32_kernel']['num_layers']} layers; also at "
                 "8- and 128-token blocks)",
         "launches": deepseek["f32_kernel"]["launches"]["paged_attention_mla"],
         "launches_by_block": {
             k: v["launches"]["paged_attention_mla"]
             for k, v in blocks.items() if k.startswith("float32")},
         "max_abs_err": max(r["max_abs_err"] for r in mla_rows
                            + mla_block_rows if r["dtype"] == "float32"),
         "tol": "atol 2e-4 (f32), decode / prefill / verify at blocks of "
                "16, 128 and 256",
         "shape": f"decode B={SLOTS} H={DS_H} latent {DS_R}+{DS_RR} "
                  f"positions {mf['positions']} f32, 16-token blocks",
         "decode_by_block": mla_decode,
         **{k: mf[k] for k in ("kernel_ms", "merge_ms", "graph_ms",
                               "plan")},
         **{k: mf[k] for k in numbers}},
        {"name": "paged_attention_mla_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (mla=True, "
                     ":173-177)",
         "kernel": "paged_attention_mla_kernel, bf16 instance (FMA; bf16 "
                   "MLA at block sizes the tensor-core kernel does not "
                   "take)",
         "path": "deepseek-v2-lite-16b (4 layers) at 8- and 128-token KV "
                 "blocks (ms includes its merge kernel's)",
         "launches": sum(v["launches"]["paged_attention_mla_bf16"]
                         for k, v in blocks.items()
                         if k.startswith("bfloat16")),
         "launches_by_block": {
             k: v["launches"]["paged_attention_mla_bf16"]
             for k, v in blocks.items() if k.startswith("bfloat16")},
         "max_abs_err": max(r["max_abs_err"] for r in mla_bf16_rows),
         "tol": "atol 2e-2 (bf16), decode / prefill / verify at blocks of "
                "8, 128 and 256",
         "shape": f"decode B={SLOTS} H={DS_H} latent {DS_R}+{DS_RR} "
                  f"positions {mb8['positions']} bf16, 8-token blocks",
         **{k: mb8[k] for k in ("kernel_ms", "merge_ms", "graph_ms",
                                "plan")},
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
