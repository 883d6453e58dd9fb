#!/usr/bin/env python3
"""Wall time of the port's paged engine, for comparing two trees of the
repo on one NVIDIA GPU.

    python3 scripts/serve_ab.py --tree DIR [--arch qwen1.5-0.5b]
                                [--runs 5] [--json-out PATH]

Imports `repro_torch` from DIR/src (a checkout, or a `git archive` of
another commit), builds its kernels, and serves the arch at full width and
depth (random weights from seed 0) as `chip_smoke.py` does: 4 requests x 16
greedy tokens, 4 slots, 16-token blocks, speculation off, bf16; one
warm-up run on random prompts, then `--runs` timed runs of the prompts
holding their own greedy continuation, then one run under torch.profiler
(device time summed over all kernels, over the median run's wall time: the
busy share).  Prints one line a run and a JSON record.  Run the trees in
turns in one call (parent, change, change, parent): the engine is bound by
the host, whose speed differs from machine to machine.  Without CUDA it
exits 2.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    if not (tree / "src" / "repro_torch").is_dir():
        print(f"serve_ab: no src/repro_torch under {tree}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import ServeConfig, make_engine

    resolve_device("cuda")
    build.build_all()
    cfg = registry.get_config(args.arch).with_(dtype="bfloat16")
    params = tf.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), "cuda")
    rng = np.random.default_rng(0)
    base = [rng.integers(0, cfg.vocab_size, size=rng.integers(4, 13))
            .tolist() for _ in range(4)]

    def serve(prompts, prof=None):
        engine = make_engine(cfg, params, ServeConfig(
            slots=4, max_len=128, block_size=16, prefill_chunk=32,
            speculation=False, dense_kernel="auto",
            paged_attn_kernel="auto"))
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        rids = [engine.submit(p, max_new_tokens=16) for p in prompts]
        out = engine.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
        return [out[r] for r in rids], dt

    first, _ = serve(base)
    prompts = [p + s + p[-3:] for p, s in zip(base, first)]
    seconds, streams = [], None
    for i in range(args.runs):
        streams, dt = serve(prompts)
        seconds.append(dt)
        print(f"{tree.name} {args.arch} run {i}: {dt:.4f} s, "
              f"{64 / dt:.2f} tok/s", flush=True)
    prof = profile(activities=[ProfilerActivity.CUDA])
    again, _ = serve(prompts, prof)
    if again != streams:
        raise AssertionError("the profiled run's streams differ")
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
    med = statistics.median(seconds)
    rec = {"tree": str(tree), "arch": args.arch, "seconds": seconds,
           "median_s": med, "tok_s": 64 / med, "device_busy_s": busy,
           "busy_share": busy / med, "card": torch.cuda.get_device_name(0)}
    print(f"{tree.name} {args.arch}: median {med:.4f} s ({64 / med:.2f} "
          f"tok/s), device {busy:.4f} s, busy share {busy / med:.3f}")
    print(json.dumps(rec))
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
