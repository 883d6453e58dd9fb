"""Runtime-phase pipeline adaptation under off-chip bandwidth reduction.

Reproduces paper §IV-C / Fig 7: when an SoC cuts the PIM accelerator's
off-chip bandwidth to band/n at runtime, each strategy adapts differently:

  insitu    keep all macros, slow each rewrite n×            (Eq 7)
  naive_pp  keep rewrite speed at the t_pim==t_rw matching point, cut the
            number of active macro pairs                     (Eq 8)
  gpp       keep rewrite speed, cut active macros to num/m and give each
            survivor m× the on-chip buffer (n_in *= m), re-staggering so the
            reduced bandwidth is still flat-saturated        (Eq 9)

Each adaptation is evaluated both in closed form (analytical.py) and with the
cycle-accurate simulator on the adapted operating point.

A copy of `repro.core.runtime_adapt`; the parity tests hold
tests hold the two to the same outputs.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import analytical as ana
from repro_torch.core import simulator as dessim
from repro_torch.core.analytical import PimConfig


@dataclasses.dataclass(frozen=True)
class AdaptPoint:
    strategy: str
    band_reduction: float          # n: bandwidth is band/n
    active_macros: int
    perf_theory: float             # remaining performance (closed form)
    perf_sim: float                # remaining performance (DES)
    bw_utilization: float          # fraction of cycles with bus traffic (sim)
    macro_utilization: float       # busy fraction of *active* macros (sim)
    buffer_utilization: float      # used n_in slots / total buffer budget


def _design_point(cfg: PimConfig, strategy: str) -> "tuple[PimConfig, int]":
    """Design-phase anchor: t_pim == t_rw (paper's Fig 7 anchor) at cfg.band,
    with each strategy sized by its own Eq 3/4 optimum."""
    n_in_match = cfg.size_ou / cfg.s  # makes t_pim == t_rw
    c = cfg.with_(n_in=n_in_match)
    num = max(2, round(ana.num_macros(c, strategy)))
    return c, num


def adapt_insitu(cfg: PimConfig, n: float, rounds: int = 16) -> AdaptPoint:
    c, num = _design_point(cfg, "insitu")
    perf_th = ana.insitu_perf_degradation(c, n)
    reduced = c.with_(band=c.band / n)
    res = dessim.simulate("insitu", reduced, num, rounds)
    base = dessim.simulate("insitu", c, num, rounds)
    return AdaptPoint(
        strategy="insitu",
        band_reduction=n,
        active_macros=num,
        perf_theory=perf_th,
        perf_sim=base.total_cycles / res.total_cycles,
        bw_utilization=res.bandwidth_utilization,
        macro_utilization=res.macro_utilization,
        buffer_utilization=1.0,  # all macros keep their buffers
    )


def adapt_naive_pp(cfg: PimConfig, n: float, rounds: int = 16) -> AdaptPoint:
    c, num = _design_point(cfg, "naive_pp")
    perf_th = ana.naive_pp_perf_degradation(c, n)
    # keep per-macro rewrite speed s; active pairs limited by band/n:
    # each pair's average demand is s/2 => active = 2*(band/n)/s macros.
    active = max(2, 2 * math.floor((c.band / n) / c.s))
    active = min(active, num)
    reduced = c.with_(band=c.band / n)
    res = dessim.simulate("naive_pp", reduced, active, rounds)
    base = dessim.simulate("naive_pp", c, num, rounds)
    # throughput is per-macro-round; scale by active/num macros
    perf_sim = (res.throughput) / (base.throughput)
    used_buffer = active * c.n_in
    return AdaptPoint(
        strategy="naive_pp",
        band_reduction=n,
        active_macros=active,
        perf_theory=perf_th,
        perf_sim=perf_sim,
        bw_utilization=res.bandwidth_utilization,
        macro_utilization=res.macro_utilization,
        buffer_utilization=used_buffer / (num * c.n_in),
    )


def adapt_gpp(cfg: PimConfig, n: float, rounds: int = 16) -> AdaptPoint:
    c, num = _design_point(cfg, "gpp")
    perf_th = ana.gpp_perf_degradation(c, n)
    # perf = (1+r0)/(1+r') with r0 = 1 at the anchor; the survivors' compute:
    # rewrite ratio r' solves r'(1+r') = num*r0*s*n/band (Eq 9 rearranged).
    r0 = 1.0
    rp = (-1.0 + math.sqrt(1.0 + 4.0 * num * r0 * c.s * n / c.band)) / 2.0
    active = max(1, round(num * r0 / rp))
    # survivors inherit the freed buffers: n_in' = n_in * (num/active)
    n_in_new = c.n_in * num / active
    adapted = c.with_(n_in=n_in_new, band=c.band / n)
    res = dessim.simulate("gpp", adapted, active, rounds)
    base = dessim.simulate("gpp", c, num, rounds)
    # per-round useful work scales with n_in: account for it
    work_res = active * rounds * n_in_new
    work_base = num * rounds * c.n_in
    perf_sim = (work_res / res.total_cycles) / (work_base / base.total_cycles)
    return AdaptPoint(
        strategy="gpp",
        band_reduction=n,
        active_macros=active,
        perf_theory=perf_th,
        perf_sim=perf_sim,
        bw_utilization=res.bandwidth_utilization,
        macro_utilization=res.macro_utilization,
        buffer_utilization=(active * n_in_new) / (num * c.n_in),
    )


def fig7_sweep(
    cfg: PimConfig | None = None,
    reductions=(1, 2, 4, 8, 16, 32, 64),
    rounds: int = 16,
) -> "list[AdaptPoint]":
    """Full Fig 7 sweep for the three strategies."""
    cfg = cfg or PimConfig(size_macro=1024, size_ou=32, s=8.0, band=512.0)
    out: list[AdaptPoint] = []
    for n in reductions:
        out.append(adapt_insitu(cfg, float(n), rounds))
        out.append(adapt_naive_pp(cfg, float(n), rounds))
        out.append(adapt_gpp(cfg, float(n), rounds))
    return out
