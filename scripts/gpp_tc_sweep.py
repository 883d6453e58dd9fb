#!/usr/bin/env python3
"""Tile, ring and grid sweep of `gpp_matmul`'s tensor-core kernel on one
NVIDIA GPU: the measurements behind `plan_matmul_tc_sm90`'s rule.

    python3 scripts/gpp_tc_sweep.py [--ablate] [--phases decode,prefill]
                                    [--json-out PATH]

At every bf16 projection shape of the two serving paths (qwen1.5-0.5b and
deepseek-v2-lite-16b; x of 4 rows at decode, 32 at prefill) it launches the
kernel through its C entry at every block_k (128, 256) and ring depth G
(1..4) that fits, at the planned grid and at 132, 66 and 33 CTAs where
those are fewer, and prints the time per launch: CUDA events around the replay
of a CUDA graph of 40 launches whose inputs rotate through copies larger
than the L2 cache (a launch takes a few microseconds, about the host's
cost of issuing one from Python).  Each configuration's output is held
against `kernels.ref.dense_ref` (bf16 tolerance 2e-2), and `torch.matmul`'s
time, by the same graph replay, is printed beside the planned one.
`--ablate` also builds copies of the kernel sources with the tensor-core
product compiled out and with the global-to-shared copies compiled out,
and times them at the planned configuration: what the memory pipeline
alone and the compute and fix-up alone cost.  Without CUDA, or outside a
checkout of the repo, it exits 2.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

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
_COPY_W = ("gpp_matmul.cu", "    copy_rows_vec<kRowBytesW>(",
           "    if (false) copy_rows_vec<kRowBytesW>(")
_COPY_X = ("gpp_matmul.cu", "      copy_rows_vec<kXRow>(",
           "      if (false) copy_rows_vec<kXRow>(")
ABLATIONS = {
    "no_mma": [_MMA],                # copies, waits, ldmatrix, fix-up
    "no_copy": [_COPY_W, _COPY_X],   # ldmatrix, mma, fix-up, the waits
}


def launcher(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.gpp_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 15 + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


class Launch:
    """One configuration's launch with its output, workspace and counters
    allocated up front (so a CUDA graph can capture it)."""

    def __init__(self, fn, plan, M, N):
        import torch
        self.fn, self.plan = fn, plan
        self.segs = plan.max_segs
        self.y = torch.empty((M, N), dtype=torch.bfloat16, device="cuda")
        self.ws = self.cnt = None
        if self.segs > 1:
            self.ws = torch.empty(plan.workspace_floats, device="cuda")
            self.cnt = torch.zeros(plan.tiles, dtype=torch.int32,
                                   device="cuda")

    def __call__(self, x, w):
        import torch
        p = self.plan
        M, K = x.shape
        N = w.shape[1]
        err = self.fn(
            x.data_ptr(), w.data_ptr(), None, None, self.y.data_ptr(),
            None if self.ws is None else self.ws.data_ptr(),
            None if self.cnt is None else self.cnt.data_ptr(), M, K, N, 1,
            1, p.block_m, p.block_k, p.num_bufs, p.chunks, 0, 16, 1, p.grid,
            16, self.segs, None, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch refused: cudaError {err}")
        return self.y


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--phases", default="decode,prefill")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gpp_tc_sweep: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("gpp_tc_sweep: run it from a checkout of the repo",
              file=sys.stderr)
        return 2
    from repro_torch.core import schedule as sched
    from repro_torch.kernels import build
    from repro_torch.kernels.ref import dense_ref
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    build.build_all(("gpp_matmul",))
    fn = launcher(build.library_path("gpp_matmul"))
    ablated = {}
    if args.ablate:
        paths = build.build_variants("gpp_matmul", ABLATIONS)
        ablated = {n: launcher(path) for n, path in paths.items()}
    rows = []
    for phase in args.phases.split(","):
        M = PHASE_M[phase]
        for name, (K, N) in PROJ.items():
            planned = sched.plan_matmul_tc_sm90(M, K, N)
            copies = max(2, math.ceil(2 * L2_BYTES / (K * N * 2)))
            g = torch.Generator(device="cuda").manual_seed(0)
            sets = [(torch.randn(M, K, generator=g, device="cuda").bfloat16(),
                     (torch.randn(K, N, generator=g, device="cuda")
                      * 0.02).bfloat16()) for _ in range(copies)]
            ref = dense_ref(*sets[0]).float()
            mm = graph_ms(torch.matmul, sets)
            print(f"{phase} {name} {M}x{K}x{N}: torch.matmul {mm:.4f} ms; "
                  f"planned block_k={planned.block_k} G={planned.num_bufs} "
                  f"grid={planned.grid} segs={planned.max_segs}", flush=True)
            for bk in (128, 256):
                for G in (1, 2, 3, 4):
                    try:
                        plan = sched.plan_matmul_tc_sm90(M, K, N, num_bufs=G,
                                                         block_k=bk)
                    except ValueError:
                        continue
                    grids = [plan.grid] + [g for g in (132, 66, 33)
                                           if g < plan.grid]
                    for grid in grids:
                        p = dataclasses.replace(plan, grid=grid)
                        call = Launch(fn, p, M, N)
                        err = float((call(*sets[0]).float() - ref).abs()
                                    .max())
                        if err > 2e-2 + 2e-2 * float(ref.abs().max()):
                            raise AssertionError(f"{name} bk={bk} G={G} "
                                                 f"grid={grid}: err {err}")
                        ms = graph_ms(call, sets)
                        is_plan = (bk, G, grid) == (planned.block_k,
                                                    planned.num_bufs,
                                                    planned.grid)
                        row = {"phase": phase, "shape": name, "M": M, "K": K,
                               "N": N, "block_k": bk, "G": G, "grid": grid,
                               "ctas_per_sm": p.ctas_per_sm,
                               "max_segs": p.max_segs, "ms": ms,
                               "max_abs_err": err, "matmul_ms": mm,
                               "planned": is_plan}
                        if is_plan:
                            for n, afn in ablated.items():
                                row[f"{n}_ms"] = graph_ms(Launch(afn, p, M, N),
                                                          sets)
                        rows.append(row)
                        extra = "".join(f" {n}={row[n + '_ms']:.4f}"
                                        for n in ablated
                                        if n + "_ms" in row)
                        print(f"  block_k={bk} G={G} grid={grid} "
                              f"ctas/SM={p.ctas_per_sm} segs={p.max_segs} "
                              f"ms={ms:.4f} err={err:.3g}"
                              + (" (planned)" if is_plan else "") + extra,
                              flush=True)
            del sets
            torch.cuda.empty_cache()
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
