#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--json-out PATH]

In order, it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds both CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per source, started together) and prints the build seconds;
  3. holds each kernel against its plain PyTorch version on the card, at
     every shape the serving path gives it, and prints the largest error
     beside its tolerance, then the kernel's time, the plain version's time,
     a library yardstick's time (`torch.matmul`; `scaled_dot_product_attention`
     on gathered K/V) and the bound (the larger of bytes / 3.35e12 B/s and
     operations / the peak rate of their type); it also reads the
     gpp_matmul issue-order record back and compares it with
     `chunk_issue_schedule` for G in {1, 2, 4};
  4. serves full-width qwen1.5-0.5b (random weights from a seed) through
     `repro_torch.serving.ServingEngine`: bf16 with speculation off and on
     (tok/s, launch counts of both kernels, which must be > 0), then float32
     with the kernels and with their plain versions, whose greedy streams
     must be equal;
  5. prints {"kernels": [...]} and, last, the device line.

Any failed check raises, so the exit code is not 0.  Without CUDA it exits
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
SLOTS, MAX_LEN, BS, CHUNK, DRAFT = 4, 128, 16, 32, 4
PROJ = {"qkvo": (D, D), "gate_up": (D, F), "down": (F, D)}
PHASE_M = {"decode": SLOTS, "prefill": CHUNK, "verify": SLOTS * (DRAFT + 1)}


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


def device_ms(fn, argsets, name: "str | None" = None, iters: int = 50):
    """Device time per call: the summed duration of the kernels the calls
    ran (only those whose name contains `name`, if given), from a
    torch.profiler (CUPTI) trace.  None when the trace holds no device
    events; the caller then keeps the CUDA-event time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and (name is None or name in e.name))
    return us / iters / 1e3 if us > 0 else None


def measure(fn, argsets, name: "str | None" = None) -> "tuple[float, float]":
    """(device ms, wall ms) per call.  The wall time (CUDA events around
    back-to-back calls) includes the host's launch cost where that is the
    larger; the device time is what the card spent."""
    wall = time_ms(fn, argsets)
    dev = device_ms(fn, argsets, name)
    return (dev if dev is not None else wall), wall


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
             seed=0):
    """One gpp_matmul comparison on the card; returns the max abs error."""
    import torch
    from repro_torch.kernels.gpp_matmul import gpp_matmul
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
    y = gpp_matmul(x, w, bias=b, w_scale=scale, activation=act, num_bufs=G)
    ref = dense_ref(x, w, bias=b, w_scale=scale, activation=act)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs()
    atol, rtol = TOL[dtype]
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    check(bool(torch.isfinite(y.float()).all()), "gpp_matmul non-finite")
    check(ok, f"gpp_matmul {M}x{K}x{N} {dtype} act={act} bias={bias} "
              f"int8={w_int8} G={G}: max err {float(err.max())}")
    return float(err.max())


def gpp_time(M, K, N, dtype):
    """Kernel / plain / torch.matmul times of an (M,K)@(K,N) product with
    no bias or activation (the up projection), and its bound."""
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
    ms, wall = measure(lambda x, w: gpp_matmul(x, w), sets,
                       "gpp_matmul_kernel")
    plain, plain_wall = measure(lambda x, w: dense_ref(x, w), sets)
    lib, lib_wall = measure(lambda x, w: torch.matmul(x, w), sets)
    b_ms, by = bound((M * K + K * N + M * N) * es, 2.0 * M * K * N, dtype)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": by, "wall_ms": wall, "plain_wall_ms": plain_wall,
            "library_wall_ms": lib_wall}


def check_gpp(report):
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import ACTIVATION_IDS, chunk_issue_schedule
    rows = []
    for phase, M in PHASE_M.items():
        for name, (K, N) in PROJ.items():
            for dtype in ("bfloat16", "float32"):
                err = max(gpp_case(M, K, N, dtype, G=G)
                          for G in (None, 1, 2, 4))
                row = {"phase": phase, "proj": name, "M": M, "K": K, "N": N,
                       "dtype": dtype, "max_abs_err": err,
                       "tol": TOL[dtype]}
                if dtype == "bfloat16":
                    row.update(gpp_time(M, K, N, dtype))
                rows.append(row)
                print(f"gpp_matmul {phase:7s} {name:7s} {M}x{K}x{N} {dtype}: "
                      f"max_abs_err={err:.3g} (atol,rtol)={TOL[dtype]}"
                      + (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f}"
                         f" library_ms={row['library_ms']:.4f} bound_ms="
                         f"{row['bound_ms']:.4f} ({row['bound_by']})"
                         f" wall_ms={row['wall_ms']:.4f}"
                         if "ms" in row else ""))
    # epilogue variants at the path's projection shapes
    extra = []
    for act in ACTIVATION_IDS:
        if act is None:
            continue
        for dtype in ("bfloat16", "float32"):
            extra.append(gpp_case(SLOTS, D, F, dtype, act=act, bias=True))
    for dtype in ("bfloat16", "float32"):
        extra.append(gpp_case(CHUNK, D, D, dtype, w_int8=True, act="silu"))
        extra.append(gpp_case(SLOTS, F, D, dtype, w_int8=True, G=1))
        # ragged M/K/N: 2002-byte bf16 rows take the byte-copy path
        extra.append(gpp_case(7, 1000, 1001, dtype, bias=True, act="gelu"))
        extra.append(gpp_case(37, 333, 130, dtype, G=4))
    print(f"gpp_matmul epilogue/int8/ragged cases: {len(extra)} ok, "
          f"max_abs_err={max(extra):.3g}")
    # the generalized ping-pong issue order survived the port
    import torch
    x = torch.randn(SLOTS, D, device="cuda").bfloat16()
    w = (torch.randn(D, D, device="cuda") * 0.02).bfloat16()
    for G in (1, 2, 4):
        got, num_k, g_used, C = gm.issue_order(x, w, G)
        check(g_used == G, f"ring depth {g_used} != {G}")
        want = chunk_issue_schedule(num_k, G, C)
        check(got == want, f"issue order differs at G={G}")
        print(f"gpp_matmul issue order G={G} C={C} steps={num_k}: "
              f"{sum(len(v) for v in got.values())} chunk issues == "
              "chunk_issue_schedule")
    report["gpp_matmul"] = {"shapes": rows, "extra_cases": len(extra),
                            "extra_max_abs_err": max(extra)}
    return rows


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
# the main path: full-width qwen1.5-0.5b through the serving engine
# ---------------------------------------------------------------------------

def serve(dtype: str, *, speculation: bool, mode: str, profile=False,
          requests: int = 4, max_new: int = 16):
    import numpy as np
    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import ServeConfig, make_engine

    cfg = registry.get_config("qwen1.5-0.5b").with_(dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen, "cuda")
    engine = make_engine(cfg, params, ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, speculation=speculation,
        draft_len=DRAFT, dense_kernel=mode, paged_attn_kernel=mode))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 13))
               .tolist() for _ in range(requests)]
    torch.cuda.synchronize()
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    gm.launches.n = pa.launches.n = 0
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    results = engine.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if profile:
        prof.stop()
        busy = {"gpp_matmul": 0.0, "paged_attention": 0.0, "other": 0.0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = next((k for k in busy if k + "_kernel" in e.name),
                           "other")
                busy[key] += e.time_range.elapsed_us() / 1e6
    counts = {"gpp_matmul": gm.launches.n, "paged_attention": pa.launches.n}
    streams = [results[r] for r in rids]
    ntok = sum(len(s) for s in streams)
    check(all(len(s) == max_new for s in streams), "a request did not finish")
    check(all(0 <= t < cfg.vocab_size for s in streams for t in s),
          "token out of range")
    shapes = engine.trace_counts
    check(shapes["prefill_chunk"] == 1 and shapes["decode"] == 1
          and shapes["verify"] <= 1, f"step shapes {shapes}")
    info = {"dtype": dtype, "speculation": speculation, "mode": mode,
            "tokens": ntok, "seconds": dt, "tok_s": ntok / dt,
            "steps": len(engine.metrics), "launches": counts,
            "shapes": shapes, "acceptance_rate": engine.acceptance_rate()}
    if profile:
        info["device_busy_s"] = busy
    print(f"serve qwen1.5-0.5b {dtype} spec={speculation} mode={mode}: "
          f"{ntok} tokens in {dt:.3f}s = {ntok / dt:.1f} tok/s, "
          f"{len(engine.metrics)} steps, launches {counts}, shapes {shapes}, "
          f"acceptance {engine.acceptance_rate():.2f}")
    del engine, params
    torch.cuda.empty_cache()
    return streams, info


def check_serving(report):
    runs = {}
    # one short warm-up run: library loading, kernel attributes and the
    # caching allocator's first blocks are not the main path's cost
    serve("bfloat16", speculation=False, mode="auto", requests=1, max_new=2)
    plain, runs["bf16"] = serve("bfloat16", speculation=False, mode="auto")
    spec, runs["bf16_spec"] = serve("bfloat16", speculation=True, mode="auto")
    for key in ("bf16", "bf16_spec"):
        for k, n in runs[key]["launches"].items():
            check(n > 0, f"{k} never launched on the main path ({key})")
    print(f"bf16 greedy streams spec on == off: {plain == spec}")
    # the same bf16 run again under torch.profiler: device time by kernel,
    # over the wall time of the unprofiled run (same work, same shapes)
    again, prof = serve("bfloat16", speculation=False, mode="auto",
                        profile=True)
    check(again == plain, "the profiled run's streams differ")
    busy = prof["device_busy_s"]
    share = sum(busy.values()) / runs["bf16"]["seconds"]
    runs["bf16"]["device_busy_s"] = busy
    runs["bf16"]["device_busy_share"] = share
    print(f"bf16 decode run device time: {busy} s; busy share "
          f"{share:.3f} of {runs['bf16']['seconds']:.3f}s wall")
    f32_kernel, runs["f32_kernel"] = serve("float32", speculation=False,
                                           mode="auto")
    f32_ref, runs["f32_ref"] = serve("float32", speculation=False, mode="ref")
    check(runs["f32_ref"]["launches"] == {"gpp_matmul": 0,
                                          "paged_attention": 0},
          "the plain run launched a kernel")
    check(f32_kernel == f32_ref,
          f"f32 greedy streams differ: kernel {f32_kernel} ref {f32_ref}")
    print("f32 greedy streams kernel == plain: True")
    report["serving"] = runs
    report["bf16_spec_equal"] = plain == spec
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
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

    gpp_rows = check_gpp(report)
    pa_rows = check_paged(report)
    runs = check_serving(report)

    g = next(r for r in gpp_rows if r["phase"] == "decode"
             and r["proj"] == "gate_up" and r["dtype"] == "bfloat16")
    p = next(r for r in pa_rows if r["case"] == "decode"
             and r["dtype"] == "bfloat16")
    kernels = [
        {"name": "gpp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul.cu",
         "replaces": "src/repro/kernels/gpp_matmul.py:408",
         "launches": runs["bf16"]["launches"]["gpp_matmul"],
         "max_abs_err": max(r["max_abs_err"] for r in gpp_rows),
         "shape": f"decode up-projection {g['M']}x{g['K']}x{g['N']} bf16",
         "ms": g["ms"], "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
         "bound_by": g["bound_by"], "library_ms": g["library_ms"]},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341",
         "launches": runs["bf16"]["launches"]["paged_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in pa_rows),
         "shape": f"decode B={SLOTS} H={H} hd={HD} positions "
                  f"{p['positions']} bf16",
         "ms": p["ms"], "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
         "bound_by": p["bound_by"], "library_ms": p["library_ms"]},
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
