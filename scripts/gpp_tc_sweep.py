#!/usr/bin/env python3
"""Plan-space sweep of `gpp_matmul`'s tensor-core kernel (cluster split-K)
on one NVIDIA GPU: the measurements behind `plan_matmul_tc_sm90`'s rule.

    python3 scripts/gpp_tc_sweep.py [--ablate] [--parent DIR]
                                    [--phases decode,prefill,verify]
                                    [--json-out PATH]

At every bf16 projection shape of the two serving paths (qwen1.5-0.5b and
deepseek-v2-lite-16b; x of 4 rows at decode, 32 at prefill, 20 at verify)
it launches the kernel through its C entry at every block_n (64, 128),
cluster size S (1, 2, 4, 8, 16), block_k (128, 256) and ring depth G
(1, 2; 3 and 4 too at the planned split) that can run, and prints the time
per launch: CUDA events around the replay of a CUDA graph of 40 launches
whose inputs rotate through copies larger than the L2 cache (a launch takes
a few microseconds, about the host's cost of issuing one from Python).
Each configuration's output is held against `kernels.ref.dense_ref` (bf16
tolerance 2e-2 + 2e-2 |plain|), and `torch.matmul`'s time, by the same
graph replay, is printed beside the planned one.  `--ablate` also builds
copies of the kernel sources with the tensor-core product, the
global-to-shared copies, or the distributed-shared-memory reads of the
partials compiled out, and times them at the planned configuration.
`--parent DIR` times `gpp_matmul` as planned at every shape through the
wrappers of two trees, DIR (a `git archive` of the parent commit) and this
checkout, each in a process of its own, in turns: parent, change, change,
parent.  Without CUDA, or outside a checkout of the repo, it exits 2.
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

PROJ = {"qwen qkvo": (1024, 1024), "qwen gate_up": (1024, 2816),
        "qwen down": (2816, 1024), "ds q": (2048, 3072),
        "ds kv_down": (2048, 576), "ds o": (2048, 2048),
        "ds shared_gate_up": (2048, 2816), "ds shared_down": (2816, 2048),
        "ds dense_gate_up": (2048, 10944), "ds dense_down": (10944, 2048)}
PHASE_M = {"decode": 4, "prefill": 32, "verify": 20}
L2_BYTES = 50 * 1024 * 1024
GRAPH_LAUNCHES = 40
_MMA = ("mma.cuh", '  asm volatile(\n      "mma.sync',
        '  if (false) asm volatile(\n      "mma.sync')
_COPY_W = ("gpp_matmul.cu", "    copy_tile<kRowW, V16>(",
           "    if (false) copy_tile<kRowW, V16>(")
_COPY_X = ("gpp_matmul.cu", "      copy_tile<kXRow, V16>(",
           "      if (false) copy_tile<kXRow, V16>(")
_DSMEM = ("gpp_matmul.cu", "ld_rank(off + g * kPart * 4, q0 + b)",
          "make_float4(0.0f, 0.0f, 0.0f, 0.0f)")
ABLATIONS = {
    "no_mma": [_MMA],                # copies, waits, ldmatrix, the sum
    "no_copy": [_COPY_W, _COPY_X],   # ldmatrix, mma, the sum, the waits
    "no_dsmem": [_DSMEM],            # all but the partials' remote reads
}


def shapes(phases):
    return [(phase, name, PHASE_M[phase], K, N)
            for phase in phases for name, (K, N) in PROJ.items()]


def input_sets(M, K, N):
    """Copies of (x, w) larger than the L2 cache together, from seed 0."""
    import torch
    copies = max(2, math.ceil(2 * L2_BYTES / (K * N * 2)))
    g = torch.Generator(device="cuda").manual_seed(0)
    return [(torch.randn(M, K, generator=g, device="cuda").bfloat16(),
             (torch.randn(K, N, generator=g, device="cuda")
              * 0.02).bfloat16()) for _ in range(copies)]


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
    for _ in range(5):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (5 * GRAPH_LAUNCHES)


def wrapper_times(tree: Path, phases) -> int:
    """Time `gpp_matmul(x, w)` as planned (bf16, no epilogue) at every
    shape through the wrapper of the tree at `tree`; print one JSON line
    {shape key: ms}."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.gpp_matmul import gpp_matmul
    build.build_all(("gpp_matmul",))
    out = {}
    for phase, name, M, K, N in shapes(phases):
        sets = input_sets(M, K, N)
        out[f"{phase} {name}"] = graph_ms(lambda x, w: gpp_matmul(x, w),
                                          sets)
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


def launcher(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.gpp_matmul_tc_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


class Launch:
    """One configuration's launch through the C entry, its output allocated
    up front (so a CUDA graph can capture it)."""

    def __init__(self, fn, plan, M, N):
        import torch
        self.fn, self.plan = fn, plan
        self.y = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")

    def __call__(self, x, w):
        import torch
        p = self.plan
        M, K = x.shape
        N = w.shape[1]
        err = self.fn(
            x.data_ptr(), w.data_ptr(), None, None, self.y.data_ptr(), M, K,
            N, p.block_m, p.block_n, p.block_k, p.num_bufs, p.chunks,
            p.cluster, 0, 16 if N % 8 == 0 else 1, 16 if K % 8 == 0 else 1,
            None, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch refused: cudaError {err}")
        return self.y


def configs(sched, M, K, N, planned):
    """Every (block_n, S, block_k, G) plan that can run at this shape: G 1
    and 2 everywhere, 3 and 4 at the planned split."""
    out = []
    for bn in sched.GPP_MM_TC_BLOCK_NS:
        for S in sched.GPP_MM_TC_CLUSTERS + (sched.GPP_MM_TC_MAX_CLUSTER,):
            for bk in sched.GPP_MM_TC_BLOCK_KS:
                split = (bn, S, bk) == (planned.block_n, planned.cluster,
                                        planned.block_k)
                for G in ((1, 2, 3, 4) if split else (1, 2)):
                    try:
                        p = sched.plan_matmul_tc_sm90(
                            M, K, N, num_bufs=G, block_n=bn, cluster=S,
                            block_k=bk)
                    except ValueError:
                        continue
                    out.append(p)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--phases", default="decode,prefill,verify")
    ap.add_argument("--parent", default=None,
                    help="a tree of the parent commit to time beside")
    ap.add_argument("--times-of", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    import torch
    if not torch.cuda.is_available():
        print("gpp_tc_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.times_of:
        return wrapper_times(Path(args.times_of).resolve(), phases)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("gpp_tc_sweep: run it from a checkout of the repo",
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
    from repro_torch.kernels import build
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import dense_ref
    build.build_all(("gpp_matmul",))
    fn = launcher(build.library_path("gpp_matmul"))
    ablated = {}
    if args.ablate:
        paths = build.build_variants("gpp_matmul", ABLATIONS)
        ablated = {n: launcher(path) for n, path in paths.items()}
    rows, per_shape = [], []
    for phase, name, M, K, N in shapes(phases):
        planned = sched.plan_matmul_tc_sm90(M, K, N)
        sets = input_sets(M, K, N)
        ref = dense_ref(*sets[0]).float()
        mm = graph_ms(torch.matmul, sets)
        print(f"{phase} {name} {M}x{K}x{N}: torch.matmul {mm:.4f} ms; "
              f"planned block_n={planned.block_n} S={planned.cluster} "
              f"block_k={planned.block_k} G={planned.num_bufs} "
              f"ctas={planned.ctas} clusters resident="
              f"{gm.tc_max_clusters(planned)}", flush=True)
        times = {}
        for p in configs(sched, M, K, N, planned):
            call = Launch(fn, p, M, N)
            diff = (call(*sets[0]).float() - ref).abs()
            err = float(diff.max())
            if not bool((diff <= 2e-2 + 2e-2 * ref.abs()).all()):
                raise AssertionError(f"{name} {p}: err {err}")
            ms = graph_ms(call, sets)
            key = (p.block_n, p.cluster, p.block_k, p.num_bufs)
            is_plan = key == (planned.block_n, planned.cluster,
                              planned.block_k, planned.num_bufs)
            times[key] = ms
            row = {"phase": phase, "shape": name, "M": M, "K": K, "N": N,
                   "block_n": p.block_n, "cluster": p.cluster,
                   "block_k": p.block_k, "G": p.num_bufs, "ctas": p.ctas,
                   "steps": max(p.cta_steps(r) for r in range(p.cluster)),
                   "smem": p.smem_bytes, "resident": gm.tc_max_clusters(p),
                   "ms": ms, "max_abs_err": err, "matmul_ms": mm,
                   "planned": is_plan}
            if is_plan:
                for n, afn in ablated.items():
                    row[f"{n}_ms"] = graph_ms(Launch(afn, p, M, N), sets)
            rows.append(row)
            extra = "".join(f" {n}={row[n + '_ms']:.4f}" for n in ablated
                            if n + "_ms" in row)
            print(f"  block_n={p.block_n} S={p.cluster} block_k="
                  f"{p.block_k} G={p.num_bufs} ctas={p.ctas} steps="
                  f"{row['steps']} smem={p.smem_bytes} clusters="
                  f"{p.tiles}/{row['resident']} ms={ms:.4f} err={err:.3g}"
                  + (" (planned)" if is_plan else "") + extra, flush=True)
        pk = (planned.block_n, planned.cluster, planned.block_k,
              planned.num_bufs)
        best = min(times, key=times.get)
        summary = {"phase": phase, "shape": name, "M": M, "K": K, "N": N,
                   "planned": pk, "planned_ms": times[pk], "best": best,
                   "best_ms": times[best], "matmul_ms": mm,
                   "bound_ms": (M * K + K * N + M * N) * 2 / 3.35e12 * 1e3}
        if ab:
            key = f"{phase} {name}"
            summary["parent_ms"] = [r[key] for r in ab["parent"]]
            summary["change_ms"] = [r[key] for r in ab["change"]]
        per_shape.append(summary)
        print(f"  planned {pk} {times[pk]:.4f} ms, best {best} "
              f"{times[best]:.4f} ms, matmul {mm:.4f}"
              + (f", wrapper parent {summary['parent_ms']} change "
                 f"{summary['change_ms']}" if ab else ""), flush=True)
        del sets
        torch.cuda.empty_cache()
    print("shape | planned ms | best ms | torch.matmul ms | bound ms"
          + (" | parent ms (A, A) | change ms (B, B)" if ab else ""))
    for s in per_shape:
        print(f"{s['phase']} {s['shape']} | {s['planned_ms']:.4f} | "
              f"{s['best_ms']:.4f} {s['best']} | {s['matmul_ms']:.4f} | "
              f"{s['bound_ms']:.4f}"
              + (f" | {s['parent_ms']} | {s['change_ms']}" if ab else ""))
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows,
                                   "shapes": per_shape}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
