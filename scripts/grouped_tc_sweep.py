#!/usr/bin/env python3
"""Tile and ring sweep of `gpp_matmul_grouped`'s tensor-core kernel on one
NVIDIA GPU: the measurements behind `plan_grouped_tc_sm90`'s rule.

    python3 scripts/grouped_tc_sweep.py [--ablate] [--json-out PATH]

At the deepseek-v2-lite-16b path's shapes (64 experts; decode / verify 32
rows an expert, prefill 128; gate/up 2048 -> 1408 and down 1408 -> 2048,
bf16) it launches the kernel through its C entry at every block_k (64,
128) and ring depth G (1..6) whose shared memory fits one SM, at the grid
the planner would give that occupancy, and prints the time per launch
(CUDA events over back-to-back launches whose inputs rotate through
copies larger than the L2 cache), the planned configuration and
`torch.bmm`'s time beside it.  `--ablate` also builds copies of the
kernel source with the tensor-core product compiled out, with the
global-to-shared copies compiled out, and with only the x tiles' copies
compiled out, and times them at the planned tiles: what the memory
pipeline alone, the compute alone and the x tiles cost.
Without CUDA it exits 2.
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
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"decode gate_up": (64, 32, 2048, 1408),
          "decode down": (64, 32, 1408, 2048),
          "prefill gate_up": (64, 128, 2048, 1408),
          "prefill down": (64, 128, 1408, 2048)}
L2_BYTES = 50 * 1024 * 1024
_MMA = ("mma.cuh", '  asm volatile(\n      "mma.sync',
        '  if (false) asm volatile(\n      "mma.sync')
_COPY_W = ("gpp_matmul_grouped.cu", "    copy_rows_vec<kRowBytesW>(",
           "    if (false) copy_rows_vec<kRowBytesW>(")
_COPY_X = ("gpp_matmul_grouped.cu", "      copy_rows_vec<kXRow>(",
           "      if (false) copy_rows_vec<kXRow>(")
ABLATIONS = {
    "no_mma": [_MMA],                # copies, waits and ldmatrix only
    "no_copy": [_COPY_W, _COPY_X],   # ldmatrix, mma and the ring's waits
    "no_x_copy": [_COPY_X],          # everything but the x tiles' copies
}


def launcher(lib_path: Path):
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.gpp_matmul_grouped_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 16 + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    occ = lib.gpp_matmul_grouped_tc_ctas_per_sm
    occ.argtypes = [ctypes.c_int] * 3
    occ.restype = ctypes.c_int
    return fn, occ


def run(fn, x, w, bm, bk, G, grid):
    import torch
    E, M, K = x.shape
    N = w.shape[2]
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), w.data_ptr(), None, None, y.data_ptr(), E, M, K,
             N, 0, 1, 1, bm, bk, G, max(1, min(G - 1, bk)), 0, 16, 1, grid,
             16, None, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch refused: cudaError {err}")
    return y


def time_ms(call, sets, iters=40):
    import torch
    for a in sets:
        call(*a)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        call(*sets[i % len(sets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def build_ablations(names):
    """Compile each ablated copy of the kernel sources (one nvcc each, all
    started together) under the kernels' build directory."""
    from repro_torch.kernels import build
    paths = build.build_variants("gpp_matmul_grouped",
                                 {n: ABLATIONS[n] for n in names})
    return {n: launcher(path)[0] for n, path in paths.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("grouped_tc_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import schedule as sched
    from repro_torch.kernels import build
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    build.build_all(("gpp_matmul_grouped",))
    fn, occ = launcher(build.library_path("gpp_matmul_grouped"))
    ablated = build_ablations(list(ABLATIONS)) if args.ablate else {}
    rows = []
    for name, (E, M, K, N) in SHAPES.items():
        plan = sched.plan_grouped_tc_sm90(E, M, K, N)
        bm = plan.block_m
        copies = max(2, math.ceil(2 * L2_BYTES / (E * K * N * 2)))
        g = torch.Generator(device="cuda").manual_seed(0)
        sets = [(torch.randn(E, M, K, generator=g, device="cuda").bfloat16(),
                 (torch.randn(E, K, N, generator=g, device="cuda")
                  * 0.02).bfloat16()) for _ in range(copies)]
        ref = torch.bmm(sets[0][0].float(), sets[0][1].float())
        bmm = time_ms(torch.bmm, sets)
        print(f"{name} {E}x{M}x{K}x{N}: torch.bmm {bmm:.4f} ms; planned "
              f"block_k={plan.block_k} G={plan.num_bufs} "
              f"ctas/SM={plan.ctas_per_sm}")
        for bk in (128, 64):
            for G in range(1, 7):
                smem = sched.grouped_tc_smem_bytes(bm, bk, G)
                if smem > sched.SMEM_BUDGET_BYTES:
                    continue
                per_sm = occ(bm, bk, G)
                grid = min(plan.units, per_sm * sched.H100_SMS)
                y = run(fn, *sets[0], bm, bk, G, grid)
                err = float((y.float() - ref).abs().max())
                ms = time_ms(lambda x, w: run(fn, x, w, bm, bk, G, grid),
                             sets)
                planned = (bk, G) == (plan.block_k, plan.num_bufs)
                row = {"shape": name, "E": E, "M": M, "K": K, "N": N,
                       "block_k": bk, "G": G, "smem": smem,
                       "ctas_per_sm": per_sm, "grid": grid, "ms": ms,
                       "max_abs_err": err, "bmm_ms": bmm,
                       "planned": planned}
                if planned:
                    for n, afn in ablated.items():
                        row[f"{n}_ms"] = time_ms(
                            lambda x, w: run(afn, x, w, bm, bk, G, grid),
                            sets)
                rows.append(row)
                extra = "".join(f" {n}={row[n + '_ms']:.4f}"
                                for n in ablated if n + "_ms" in row)
                print(f"  block_k={bk} G={G} smem={smem} ctas/SM={per_sm} "
                      f"grid={grid} ms={ms:.4f} err={err:.3g}"
                      + (" (planned)" if planned else "") + extra,
                      flush=True)
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
