#!/usr/bin/env python3
"""Plan sweep of `gpp_matmul_grouped`'s split-K FMA route on one NVIDIA GPU:
the measurements behind `plan_matmul_fma_sm90`'s rule at E experts.

    python3 scripts/grouped_fma_sweep.py [--parent DIR] [--ptxas] [--ablate]
                                         [--phases decode,prefill]
                                         [--json-out PATH]

At every f32 shape of deepseek-v2-lite-16b's routed experts (64 experts;
32 rows an expert at decode and verify, 128 at prefill; gate / up 2048 x
1408, down 1408 x 2048) it launches the kernel at every block_k (256,
128, 64, 32), at the planner's grid for that block_k and at 264 and 132
CTAs, at G = 1, 2 and 3, and at the planned block_m and at 32 rows (for
prefill's 128 rows: four m-tiles in place of two), and prints the time per
launch: CUDA events around the replay of a CUDA graph of 20 launches
whose inputs rotate through copies larger than the L2 cache.  Each
configuration's output is held against `kernels.ref.dense_grouped_ref`
(f32 tolerance 2e-4).  Beside the planned configuration it times
`torch.bmm` in f32 (TF32 off) by the same replay, and prints the bound
(the f32 W bytes at 3.35e12 B/s against the FMAs at 67e12 FLOP/s) and the
CTAs an SM the card holds at the plan (the occupancy API).

`--parent DIR` also times `gpp_matmul_grouped(x, w)` as planned at every
shape through the wrappers of two trees, DIR (a `git archive` of the parent
commit) and this checkout, each in a process of its own, in turns: parent,
change, change, parent.  `--ptxas` compiles the grouped library once more
with `-Xptxas -v` and prints the registers and spills of its FMA kernel
instances.  `--ablate` builds edited copies of the library
(`kernels.build.build_variants`) and times each at the planned
configuration beside the built one: one k-group a CTA (`one_kgroup`), one
column a thread at every block_m (`one_column`), 64 fix-up floats in
flight a thread (`fixup64`) and the inner loop unrolled whole
(`unroll_full`).  Without CUDA, or outside a checkout of the repo, it
exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

H = "gpp_matmul.cuh"
ABLATIONS = {
    "one_kgroup": [(H, "static constexpr int KG = BK >= 64 ? 2 : 1;",
                    "static constexpr int KG = 1;")],
    "one_column": [(H, "static constexpr int TN = BM >= 16 ? 4 : 1;",
                    "static constexpr int TN = 1;")],
    "fixup64": [(H, "constexpr int kFixupFloats = 32;",
                 "constexpr int kFixupFloats = 64;")],
    "unroll_full": [(H, "#pragma unroll 4\n    for (int kk = lay.kg",
                     "#pragma unroll\n    for (int kk = lay.kg")],
}
E = 64
PROJ = {"gate_up": (2048, 1408), "down": (1408, 2048)}
PHASE_M = {"decode": 32, "prefill": 128}     # verify's shape is decode's
L2_BYTES = 50 * 1024 * 1024
GRAPH_LAUNCHES = 20
HBM_BYTES_PER_S, F32_FLOPS = 3.35e12, 67e12


def shapes(phases):
    return [(phase, name, PHASE_M[phase], K, N)
            for phase in phases for name, (K, N) in PROJ.items()]


def input_sets(M, K, N):
    """Copies of (x, w) larger than the L2 cache together, from seed 0."""
    import torch
    copies = max(2, math.ceil(2 * L2_BYTES / (E * K * N * 4)))
    g = torch.Generator(device="cuda").manual_seed(0)
    return [(torch.randn(E, M, K, generator=g, device="cuda"),
             torch.randn(E, K, N, generator=g, device="cuda") * 0.02)
            for _ in range(copies)]


def graph_ms(call, sets):
    """ms per call from CUDA events around replays of a CUDA graph of
    GRAPH_LAUNCHES calls cycling through `sets`."""
    import torch
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        for a in sets:
            call(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(GRAPH_LAUNCHES):
            call(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(3):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (3 * GRAPH_LAUNCHES)


def wrapper_times(tree: Path, phases) -> int:
    """Time `gpp_matmul_grouped(x, w)` as planned (f32, no epilogue) at
    every shape through the wrapper of the tree at `tree`; print one JSON
    line {shape key: ms}."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.gpp_matmul import gpp_matmul_grouped
    resolve_device("cuda")
    build.build_all(("gpp_matmul_grouped",))
    out = {}
    for phase, name, M, K, N in shapes(phases):
        sets = input_sets(M, K, N)
        out[f"{phase} {name}"] = graph_ms(
            lambda x, w: gpp_matmul_grouped(x, w), sets)
        del sets
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def ab_times(parent: Path, phases) -> dict:
    """parent, change, change, parent: {tree: [{shape: ms}, {shape: ms}]},
    each run a process of its own."""
    runs = {"parent": [], "change": []}
    for tag, tree in (("parent", parent), ("change", ROOT),
                      ("change", ROOT), ("parent", parent)):
        res = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--times-of",
             str(tree), "--phases", ",".join(phases)],
            capture_output=True, text=True, cwd=str(tree))
        if res.returncode != 0:
            raise RuntimeError(f"{tag} timing failed:\n{res.stdout}\n"
                               f"{res.stderr}")
        runs[tag].append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(f"{tag} ({tree}) timed", flush=True)
    return runs


def ptxas_report() -> "list[str]":
    """Registers and spills of the FMA kernel's instances, from nvcc's
    -Xptxas -v on the grouped library's source."""
    from repro_torch.kernels import build
    out = build.BUILD_DIR / "ptxas_grouped.o"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    res = subprocess.run(
        [build.find_nvcc(), *build.NVCC_FLAGS, "-c", "-Xptxas", "-v", "-o",
         str(out), str(build.CSRC / "gpp_matmul_grouped.cu")],
        capture_output=True, text=True, check=True)
    out.unlink(missing_ok=True)
    lines, fma = [], False
    for line in res.stdout.splitlines() + res.stderr.splitlines():
        if "Compiling entry function" in line:
            fma = "gpp_matmul_grouped_kernel" in line
            name = line.split("'")[1] if "'" in line else line
        elif fma and ("Used" in line or "spill" in line):
            lines.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return lines


def launcher(lib_path: Path):
    """`_launch_grouped`'s FMA launch through the C entry of the library
    at `lib_path` (a built variant)."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import gpp_matmul as gm
    lib = ctypes.CDLL(str(lib_path))
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.gpp_matmul_grouped_launch.argtypes = [p_] * 7 + [i_] * 16 + [p_, p_]
    lib.gpp_matmul_grouped_launch.restype = i_

    def call(x, w, p):
        E_, M, K = x.shape
        N = w.shape[2]
        y = torch.empty((E_, M, N), dtype=x.dtype, device=x.device)
        st = torch.cuda.current_stream()
        ws, cnt = gm._fma_scratch(p, x, st)
        err = lib.gpp_matmul_grouped_launch(
            x.data_ptr(), w.data_ptr(), None, None, y.data_ptr(),
            gm._ptr(ws), gm._ptr(cnt), E_, M, K, N, 0, 0, p.block_m,
            p.block_k, p.num_bufs, p.chunks, 0,
            build.copy_width(N * 4, w.data_ptr()), 0, p.grid,
            build.copy_width(K * 4, x.data_ptr()), p.max_segs, None,
            st.cuda_stream)
        if err:
            raise RuntimeError(f"{lib_path}: cudaError {err}")
        return y
    return call


def configs(sched, M, K, N, planned):
    """(block_k, G, grid, block_m) of every configuration swept."""
    out = []
    for bk in sched.GPP_FMA_BLOCK_KS:
        try:
            base = sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=4, E=E,
                                              block_k=bk, num_bufs=2)
        except ValueError:
            continue
        for bm in sorted({base.block_m, 32}):
            m_tiles = -(-M // bm)
            full = m_tiles * (base.grid // base.m_tiles)
            for grid in sorted({full, 264, 132}):
                for G in (1, 2, 3):
                    out.append((bk, G, grid, bm))
    key = (planned.block_k, planned.num_bufs, planned.grid,
           planned.block_m)
    if key not in out:
        out.append(key)
    return out, key


def plan_of(sched, M, K, N, bk, G, grid, bm):
    """The plan at a pinned block_k, ring and grid, its rows cut into
    m-tiles of `bm` (the planner's own block_m, or another for the
    sweep); None when it does not fit."""
    try:
        p = sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=4, E=E,
                                       block_k=bk, num_bufs=G, grid=grid)
    except ValueError:
        return None
    smem = sched.matmul_fma_smem_bytes(bm, bk, G, 4)
    if smem > sched.SMEM_BUDGET_BYTES:
        return None
    p = dataclasses.replace(
        p, block_m=bm, smem_bytes=smem,
        ctas_per_sm=min(2, sched.SM_SMEM_BYTES
                        // (smem + sched.CTA_SMEM_RESERVED)))
    return dataclasses.replace(p, grid=min(grid, p.units))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="decode,prefill")
    ap.add_argument("--parent", default=None,
                    help="a tree of the parent commit to time beside")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--times-of", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("grouped_fma_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.times_of:
        return wrapper_times(Path(args.times_of).resolve(), phases)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("grouped_fma_sweep: run it from a checkout of the repo",
              file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    ab = ab_times(Path(args.parent).resolve(), phases) if args.parent \
        else None
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import schedule as sched
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import dense_grouped_ref
    resolve_device("cuda")                  # TF32 off for torch.bmm
    build.build_all(("gpp_matmul_grouped",))
    report = {"card": card}
    if args.ptxas:
        report["ptxas"] = ptxas_report()
        print("\n".join(report["ptxas"]), flush=True)
    ablated = {}
    if args.ablate:
        paths = build.build_variants("gpp_matmul_grouped", ABLATIONS)
        ablated = {n: launcher(path) for n, path in paths.items()}
    rows, per_shape = [], []
    for phase, name, M, K, N in shapes(phases):
        planned = sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=4, E=E)
        sets = input_sets(M, K, N)
        ref = dense_grouped_ref(*sets[0])
        tol = 2e-4 + 2e-4 * float(ref.abs().max())
        bmm = graph_ms(torch.bmm, sets)
        b_s = max(E * (M * K + K * N + M * N) * 4 / HBM_BYTES_PER_S,
                  2.0 * E * M * K * N / F32_FLOPS)
        held = gm.fma_ctas_per_sm(planned, torch.float32, torch.float32)
        print(f"{phase} {name} {E}x{M}x{K}x{N}: torch.bmm {bmm:.4f} ms, "
              f"bound {b_s * 1e3:.4f} ms; planned block_k="
              f"{planned.block_k} G={planned.num_bufs} grid={planned.grid} "
              f"block_m={planned.block_m} ctas/SM planned "
              f"{planned.ctas_per_sm}, held {held}", flush=True)
        times = {}
        todo, key = configs(sched, M, K, N, planned)
        for bk, G, grid, bm in todo:
            p = plan_of(sched, M, K, N, bk, G, grid, bm)
            if p is None:
                continue

            def call(x, w, p=p):
                return gm._launch_grouped(x, w, p, None, None, None, None)

            err = float((call(*sets[0]) - ref).abs().max())
            if err > tol:
                raise AssertionError(f"{name} {(bk, G, grid, bm)}: err "
                                     f"{err}")
            ms = graph_ms(call, sets)
            times[(bk, G, p.grid, bm)] = ms
            is_plan = (bk, G, p.grid, bm) == key
            rows.append({"phase": phase, "shape": name, "E": E, "M": M,
                         "K": K, "N": N, "block_k": bk, "G": G,
                         "grid": p.grid, "block_m": bm,
                         "max_segs": p.max_segs, "steps": p.cta_steps(0),
                         "ms": ms, "max_abs_err": err, "bmm_ms": bmm,
                         "bound_ms": b_s * 1e3, "planned": is_plan})
            print(f"  block_k={bk} G={G} grid={p.grid} block_m={bm} "
                  f"segs={p.max_segs} steps={p.cta_steps(0)} "
                  f"ms={ms:.4f} err={err:.3g}"
                  + (" (planned)" if is_plan else ""), flush=True)
        ablation = {}
        for tag, fn in ablated.items():
            err = float((fn(*sets[0], planned) - ref).abs().max())
            if err > tol:
                raise AssertionError(f"{name} {tag}: err {err}")
            ablation[tag] = graph_ms(lambda x, w, fn=fn: fn(x, w, planned),
                                     sets)
            print(f"  ablation {tag} at the plan: {ablation[tag]:.4f} ms",
                  flush=True)
        best = min(times, key=times.get)
        summary = {"shape": f"{phase} {name}", "planned": list(key),
                   "ablation_ms": ablation,
                   "planned_ms": times[key], "best": list(best),
                   "best_ms": times[best], "bmm_ms": bmm,
                   "bound_ms": b_s * 1e3, "ctas_per_sm": held}
        if ab:
            k = f"{phase} {name}"
            summary["parent_ms"] = [r[k] for r in ab["parent"]]
            summary["change_ms"] = [r[k] for r in ab["change"]]
        per_shape.append(summary)
        print(f"  planned {key} {times[key]:.4f} ms, best {best} "
              f"{times[best]:.4f} ms, torch.bmm {bmm:.4f}, bound "
              f"{b_s * 1e3:.4f}"
              + (f", wrapper parent {summary['parent_ms']} change "
                 f"{summary['change_ms']}" if ab else ""), flush=True)
        del sets, ref
        torch.cuda.empty_cache()
    report.update(rows=rows, shapes=per_shape)
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
