"""The readings a cell's limits are set from, on the card, at the cell's
own size: for each seed, a short run of the program at the cell's load
(its number, the lower reading) and the control's number on the same
inputs (the upper reading).  Not part of a benchmark run.

    python3 bench/control.py --workload <name> --seconds <s> --seeds a b c
        [--fault half_batch]

Serving: the control is the reference with every weight product in
float8 e4m3, read at the positions of the requests the program served
(the widest gap of the token it puts first).  Training: the control is
the reference trained in e4m3 against the reference in f32;
`--fault half_batch` instead plants in the program a step that takes the
mean loss over half of each batch.  Prints one JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench":
    sys.path.pop(0)
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def half_batch(step_fn):
    """The program's step on the first half of each batch's rows."""
    def step(params, state, batch, k):
        half = {n: v[:v.shape[0] // 2] for n, v in batch.items()}
        return step_fn(params, state, half, k)
    return step


def serve_readings(name, seed, seconds, device="cuda", smoke=False,
                   overrides=None, root=ROOT):
    from bench.lib import check, manifest as mf, serve
    conf, cell, mix = mf.cell_files(mf.manifest(root), name, root,
                                    overrides)
    out = {}

    def judge(cell_, pub, params, run, seed_, dev):
        picked = check.sample_finished(run, seed_,
                                       int(cell_["check"]["requests"]),
                                       int(cell_["check"]["min_tokens"]))
        r = check.readings(pub, params, [(t.prompt, t.tokens)
                                         for t in picked], dev,
                           control=True)
        out.update(r)
        return {"correct": True, "numbers": {}}

    real = check.judge_serve
    check.judge_serve = judge
    try:
        serve.run_serve(conf, cell, mix, seed, seconds, False, device,
                        smoke=smoke)
    finally:
        check.judge_serve = real
    return out


def train_readings(name, seed, seconds, fault=None, device="cuda",
                   smoke=False, overrides=None, root=ROOT):
    from bench.lib import check_train, manifest as mf
    from bench.lib.train import run_train
    conf, cell, mix = mf.cell_files(mf.manifest(root), name, root,
                                    overrides)
    out = {}
    real = check_train.judge

    def judge(cell_, pub, seed_, dev, specs, scale, shape, prog):
        refr = check_train.reference_run(cell_, pub, seed_, dev, specs,
                                         scale, shape)
        out["program"] = check_train.readings(prog, refr)
        if fault is None:
            low = check_train.reference_run(cell_, pub, seed_, dev, specs,
                                            scale, shape, quant="fp8")
            out["control"] = check_train.readings(low, refr)
        return {"correct": True, "numbers": {}}

    check_train.judge = judge
    try:
        run_train(conf, cell, mix, seed, seconds, False, device,
                  smoke=smoke,
                  fault=half_batch if fault == "half_batch" else None)
    finally:
        check_train.judge = real
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    a = ap.parse_args(argv)
    from bench.lib import manifest as mf
    kind = mf.load_json(mf.BENCH / "workloads" /
                        f"{a.workload}.json")["kind"]
    for seed in a.seeds:
        t = time.perf_counter()
        if kind == "serve":
            r = serve_readings(a.workload, seed, a.seconds)
        else:
            r = train_readings(a.workload, seed, a.seconds, a.fault)
        r.update(seed=seed, workload=a.workload, fault=a.fault,
                 wall_s=time.perf_counter() - t)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
