"""Run one benchmark cell once and print its result as the last line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  `--trace 0` prints the cell's end-to-end
metrics; `--trace 1` turns the engine's telemetry on, traces a fixed slice
of the window with `torch.profiler` and prints the cell's per-layer metrics
(read by `bench/metrics/<name>.py`) and the breakdown.  Every run judges
its output against the plain reference (`bench/reference/`) and prints
each number compared beside its limit, last, on standard error and in the
result's `check` key.  It exits non-zero, printing no result, without the
cards the cell asks for, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """perf_counter() at the process's start (from /proc), or at this
    module's import where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def forbidden_modules() -> "list[str]":
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", smoke: bool = False, fault=None,
             t_process: "float | None" = None, root: Path = ROOT,
             overrides: "dict | None" = None) -> dict:
    """One run of cell `name`: the result line's object (without the
    device section's card fields) and the numbers compared.  `smoke` runs
    the program's small config (tests on the CPU); `overrides` updates the
    cell's and the mix's settings ({"cell": {...}, "mix": {...}}); `fault`
    is called with the program's object before the run (tests)."""
    from bench.lib import manifest as mf
    from bench.lib.serve import p95, run_serve

    man = mf.manifest(root)
    conf, cell, mix = mf.cell_files(man, name, root, overrides)
    if cell["kind"] != "serve":
        from bench.lib.train import run_train
        out = run_train(conf, cell, mix, seed, seconds, trace, device,
                        smoke=smoke, t_process=t_process, fault=fault)
    else:
        out = run_serve(conf, cell, mix, seed, seconds, trace, device,
                        smoke=smoke, t_process=t_process, fault=fault)
    run = out["run"]
    metrics = {}
    if trace:
        for m in mf.per_layer(man, name):
            v = mf.reader(m["name"], root)(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"setup_s": out["setup_s"]}
        if cell["kind"] == "serve":
            e2e["serve_tok_s"] = run.tokens_in_window() / run.window_s
            e2e["ttft_p95_ms"] = p95(run.ttft_ms())
            e2e["itl_p95_ms"] = p95(run.itl_ms())
        else:
            e2e["train_tok_s"] = run.tokens_per_s()
        for m in mf.end_to_end(man, name):
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    res = {"correct": out["verdict"]["correct"],
           "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics,
           "device": {"memory_peak_bytes": int(out["memory_peak"])}}
    if trace and run.trace is not None:
        res["device"]["busy_s"] = run.trace["busy_s"]
        res["device"]["window_s"] = run.trace["window_s"]
        res["breakdown"] = run.trace["breakdown"]
    res["readings"] = out["verdict"].get("readings", {})
    res["check"] = out["verdict"]["numbers"]
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    t_process = process_start()

    import torch
    from bench.lib import manifest as mf

    chips = int(mf.cell_entry(mf.manifest(ROOT), a.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                   t_process=t_process)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    res["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": chips, **res["device"]}
    res["check"] = res.pop("check")          # the compared numbers last
    print("readings: " + json.dumps(res.pop("readings")), file=sys.stderr)
    for k, v in res["check"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
