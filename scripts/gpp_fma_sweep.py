#!/usr/bin/env python3
"""block_k, grid and ring sweep of `gpp_matmul`'s split-K FMA kernel on one
NVIDIA GPU: the measurements behind `plan_matmul_fma_sm90`'s rule.

    python3 scripts/gpp_fma_sweep.py [--phases decode,prefill]
                                     [--json-out PATH]

At deepseek-v2-lite-16b's f32 router (4 x 2048 x 64 at decode, 32 and 20
rows at prefill and verify) and at every f32 projection shape of the two
serving paths (qwen1.5-0.5b and deepseek-v2-lite-16b; x of 4 rows at
decode, 32 at prefill) it launches the kernel at every block_k (256, 128,
64, 32), at the planner's grid for that block_k (m-tiles of at most 132
CTAs each) and at 66, 33 and 16 CTAs where those are fewer, and at G = 1
and 2, and prints the time per
launch: CUDA events around the replay of a CUDA graph of 40 launches whose
inputs rotate through copies larger than the L2 cache (a launch takes a
few microseconds, about the host's cost of issuing one from Python).  Each
configuration's output is held against `kernels.ref.dense_ref` (f32
tolerance 2e-4).  Beside the planned configuration it times
`torch.matmul` by the same graph replay, and sums the planned and the best
configuration's times over the shapes.  (`gpp_matmul_grouped` at E = 1
runs the same kernel body; `scripts/grouped_fma_sweep.py` sweeps it over
the experts.)  Without CUDA, or outside a checkout of the repo, it exits
2.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ROUTER = {"ds router": (2048, 64)}
PROJ = {"qwen qkvo": (1024, 1024), "qwen gate_up": (1024, 2816),
        "qwen down": (2816, 1024), "ds q": (2048, 3072),
        "ds kv_down": (2048, 576), "ds o": (2048, 2048), **ROUTER,
        "ds shared_gate_up": (2048, 2816), "ds shared_down": (2816, 2048),
        "ds dense_gate_up": (2048, 10944), "ds dense_down": (10944, 2048)}
PHASE_M = {"decode": 4, "prefill": 32, "verify": 20}
L2_BYTES = 50 * 1024 * 1024
GRAPH_LAUNCHES = 40


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
    ap.add_argument("--phases", default="decode,prefill")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gpp_fma_sweep: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("gpp_fma_sweep: run it from a checkout of the repo",
              file=sys.stderr)
        return 2
    from repro_torch.core import schedule as sched
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import dense_ref
    resolve_device("cuda")                  # TF32 off for torch.matmul
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    build.build_all(("gpp_matmul",))
    shapes = []
    for phase in args.phases.split(","):
        M = PHASE_M[phase]
        for name, KN in (PROJ if phase != "verify" else ROUTER).items():
            shapes.append((phase, name, M, *KN))
    if "verify" not in args.phases.split(","):
        shapes.append(("verify", "ds router", PHASE_M["verify"],
                       *ROUTER["ds router"]))
    rows, totals = [], {"planned": 0.0, "best": 0.0, "matmul": 0.0}
    for phase, name, M, K, N in shapes:
        planned = sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=4)
        copies = max(2, math.ceil(2 * L2_BYTES / (K * N * 4)))
        g = torch.Generator(device="cuda").manual_seed(0)
        sets = [(torch.randn(M, K, generator=g, device="cuda"),
                 torch.randn(K, N, generator=g, device="cuda") * 0.02)
                for _ in range(copies)]
        ref = dense_ref(*sets[0])
        mm = graph_ms(torch.matmul, sets)
        print(f"{phase} {name} {M}x{K}x{N}: torch.matmul {mm:.4f} ms; "
              f"planned block_k="
              f"{planned.block_k} G={planned.num_bufs} grid={planned.grid} "
              f"segs={planned.max_segs}", flush=True)
        times = {}
        for bk in sched.GPP_FMA_BLOCK_KS:
            full = sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=4,
                                              block_k=bk).grid
            for grid in [full] + [n for n in (66, 33, 16) if n < full]:
                for G in (1, 2):
                    p = sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=4,
                                                   num_bufs=G, block_k=bk,
                                                   grid=grid)

                    def call(x, w, p=p):
                        return gm._launch(x, w, p, None, None, None, None,
                                          "fma")

                    err = float((call(*sets[0]) - ref).abs().max())
                    if err > 2e-4 + 2e-4 * float(ref.abs().max()):
                        raise AssertionError(f"{name} bk={bk} G={G} "
                                             f"grid={grid}: err {err}")
                    ms = graph_ms(call, sets)
                    is_plan = (bk, G, grid) == (planned.block_k,
                                                planned.num_bufs,
                                                planned.grid)
                    times[(bk, G, grid)] = ms
                    rows.append({"phase": phase, "shape": name, "M": M,
                                 "K": K, "N": N, "block_k": bk, "G": G,
                                 "grid": grid, "max_segs": p.max_segs,
                                 "ms": ms, "max_abs_err": err,
                                 "matmul_ms": mm, "planned": is_plan})
                    print(f"  block_k={bk} G={G} grid={grid} block_m="
                          f"{p.block_m} segs="
                          f"{p.max_segs} steps={p.cta_steps(0)} ms={ms:.4f}"
                          f" err={err:.3g}" + (" (planned)" if is_plan
                                               else ""), flush=True)
        # the planned configuration was timed among the rest (a planned
        # ring of 1 or 2 at the planned block_k and grid)
        key = (planned.block_k, planned.num_bufs, planned.grid)
        best = min(times, key=times.get)
        print(f"  planned {key} {times[key]:.4f} ms, best {best} "
              f"{times[best]:.4f} ms, matmul {mm:.4f}", flush=True)
        totals["planned"] += times[key]
        totals["best"] += times[best]
        totals["matmul"] += mm
        del sets
        torch.cuda.empty_cache()
    print("summed over the shapes (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in totals.items()))
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "rows": rows,
                                   "totals": totals}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
