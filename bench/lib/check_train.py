"""How `correct` is decided in a training cell.

The reference (`bench.reference.train`) trains the job's first three steps
in f32 from the same starting leaves (drawn again from the seed) on the
same batches.  Three numbers are read; those the cell's `check.limits`
names are compared with their limits:

* `loss`: the largest |loss - reference's| / reference's over the steps;
* `first_grad`: over the leaves, the gap between the norm of the program's
  first gradient as its optimizer got it and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger (some gradients are all but zero);
* `change`: the same of each leaf's change after the three steps, leaving
  out leaves whose reference gradient is under a thousandth of the median
  leaf's (they move by round-off alone).

`fp8=True` trains the reference with every weight product in e4m3 (the
control) and reads the same numbers against the f32 run.
"""
from __future__ import annotations

import statistics

from bench.lib.weights import make_params
from bench.reference import train as ref


def gaps(mine, want, skip=()) -> float:
    keys = [k for k in want if k not in skip]
    med = statistics.median(want[k] for k in want)
    return max(abs(mine[k] - want[k]) / max(want[k], med) for k in keys)


def readings(prog, refr) -> dict:
    (pl, pg, pc), (rl, rg, rc) = prog, refr
    med = statistics.median(rg.values())
    skip = {k for k, v in rg.items() if v < 1e-3 * med}
    return {"loss": max(abs(a - b) / abs(b) for a, b in zip(pl, rl)),
            "first_grad": gaps(pg, rg),
            "change": gaps(pc, rc, skip)}


def reference_run(cell, pub, seed, device, specs, scale, shape,
                  quant=None):
    from bench.lib.train import batch
    B, T, vocab = shape
    job = cell["job"]
    params = make_params(specs, seed, device, scale=scale)
    batches = [batch(seed, k, B, T, vocab, device)
               for k in range(int(cell["check"]["steps"]))]
    out = ref.train_steps(pub, params,
                          [(b["tokens"].long(), b["labels"]) for b in
                           batches],
                          job["adamw"], int(job["first_step"]), quant=quant)
    del params
    return out


def judge(cell, pub, seed, device, specs, scale, shape, prog) -> dict:
    """prog: (losses, first gradient norms, change norms) keyed by the
    leaves' paths in the program's tree."""
    refr = reference_run(cell, pub, seed, device, specs, scale, shape)
    r = readings(prog, refr)
    lim = cell["check"]["limits"]
    nums = {k: {"value": r[k], "limit": float(v)} for k, v in lim.items()}
    ok = all(r[k] <= float(v) for k, v in lim.items())
    return {"correct": bool(ok), "numbers": nums, "readings": r}
