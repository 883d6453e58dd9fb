"""Closed-form analytic model of the three write/compute schedules (paper Eqs 1-9).

All times are in clock cycles, all sizes in bytes, bandwidths in bytes/cycle.
The model is exact for fractional macro counts ("theory" column of Table II);
`repro_torch.core.simulator` provides the integer-macro cycle-accurate counterpart
("practice" column).

Parameter glossary (paper Table I):
    band        off-chip bandwidth                      [B/cycle]
    size_macro  macro (weight tile) size                [B]
    size_ou     operation-unit size: bytes of weights consumed per cycle
                while computing one input vector        [B/cycle]
    s           rewrite speed per macro                 [B/cycle]
    n_in        input vectors per compute phase         [-]

A copy of `repro.core.analytical`; the parity tests hold
tests hold the two to the same outputs.
"""
from __future__ import annotations

import dataclasses
import math

STRATEGIES = ("insitu", "naive_pp", "gpp")


@dataclasses.dataclass(frozen=True)
class PimConfig:
    """Hardware/workload point for the analytic model."""

    size_macro: float = 32 * 32  # bytes (paper: 32x32 B)
    size_ou: float = 4 * 8       # bytes/cycle (paper: 4x8 B)
    s: float = 4.0               # rewrite speed, bytes/cycle/macro
    n_in: float = 8.0            # input vectors per compute phase
    band: float = 128.0          # off-chip bandwidth, bytes/cycle

    @property
    def time_rewrite(self) -> float:
        """t_rw = size_macro / s   (cycles to fully rewrite one macro)."""
        return self.size_macro / self.s

    @property
    def time_pim(self) -> float:
        """t_pim = size_macro * n_in / size_ou  (cycles of one compute phase)."""
        return self.size_macro * self.n_in / self.size_ou

    @property
    def ratio(self) -> float:
        """t_pim / t_rw."""
        return self.time_pim / self.time_rewrite

    def with_(self, **kw) -> "PimConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Eqs 1-2: naive ping-pong macro utilization
# ---------------------------------------------------------------------------

def naive_pp_macro_util(cfg: PimConfig) -> float:
    """Macro utilization of naive ping-pong (paper Eqs 1-2).

    util = (t_pim + t_rw) / (2 * max(t_pim, t_rw)); peaks at 1.0 only when
    t_pim == t_rw.
    """
    tp, tr = cfg.time_pim, cfg.time_rewrite
    return (tp + tr) / (2.0 * max(tp, tr))


def insitu_macro_util(cfg: PimConfig) -> float:
    """In-situ write/compute: macros always busy (write or compute) but the
    paper counts a macro "active" only while computing; utilization in the
    busy-fraction sense used for Fig 7(d) is t_pim/(t_pim+t_rw)."""
    tp, tr = cfg.time_pim, cfg.time_rewrite
    return tp / (tp + tr)


def gpp_macro_util(cfg: PimConfig) -> float:
    """Generalized ping-pong never idles a macro."""
    return 1.0


# ---------------------------------------------------------------------------
# Eqs 3-4: macros supportable at fixed off-chip bandwidth (full usage)
# ---------------------------------------------------------------------------

def num_macros(cfg: PimConfig, strategy: str) -> float:
    """Number of macros a bandwidth `band` sustains at full utilization.

    Eq 3:  in-situ  -> band/s        (all macros rewrite simultaneously)
           naive_pp -> 2*band/s      (only half rewrite at a time)
    Eq 4:  gpp      -> (t_pim+t_rw)*band/(t_rw*s)
                       (each macro's average demand is t_rw*s/(t_pim+t_rw))
    """
    tp, tr = cfg.time_pim, cfg.time_rewrite
    if strategy == "insitu":
        return cfg.band / cfg.s
    if strategy == "naive_pp":
        return 2.0 * cfg.band / cfg.s
    if strategy == "gpp":
        return (tp + tr) * cfg.band / (tr * cfg.s)
    raise ValueError(f"unknown strategy {strategy!r}")


def per_macro_bandwidth(cfg: PimConfig, strategy: str) -> float:
    """Average off-chip bandwidth demand of one macro [B/cycle]."""
    tp, tr = cfg.time_pim, cfg.time_rewrite
    if strategy == "insitu":
        return cfg.s                      # bursty: s while rewriting, all together
    if strategy == "naive_pp":
        return cfg.s / 2.0                # two groups alternate
    if strategy == "gpp":
        return tr * cfg.s / (tp + tr)     # flattened to the true average
    raise ValueError(f"unknown strategy {strategy!r}")


def naive_pp_perf_factor(cfg: PimConfig) -> float:
    """Per-macro throughput retention of naive ping-pong vs an ideal macro
    (paper: (t_pim+t_rw)/(t_pim+t_rw+|t_pim-t_rw|))."""
    tp, tr = cfg.time_pim, cfg.time_rewrite
    return (tp + tr) / (tp + tr + abs(tp - tr))


# ---------------------------------------------------------------------------
# Eqs 5-6: design-phase ratios at equal off-chip bandwidth
# ---------------------------------------------------------------------------

def macro_count_ratio(cfg: PimConfig) -> tuple[float, float, float]:
    """Eq 5 — macros used by (gpp, insitu, naive_pp) normalized to insitu=1.

    gpp : insitu : naive = (size_macro*n_in/size_ou + size_macro/s)
                           / (size_macro/s)  :  1  :  2
    """
    tp, tr = cfg.time_pim, cfg.time_rewrite
    return ((tp + tr) / tr, 1.0, 2.0)


def execution_time_ratio(cfg: PimConfig) -> tuple[float, float, float]:
    """Eq 6 — execution time of (gpp, insitu, naive_pp) for a fixed workload
    with each strategy sized per Eqs 3-4, normalized to t_gpp = 1.

    NOTE: the paper labels Eq 6 an "execution time ratio" but the printed
    expression is dimensionally a *throughput* ratio — only that reading makes
    gpp == naive at t_pim == t_rw and gpp 2x in-situ, as §IV-B states and our
    DES confirms.  First-principles times (derived from Eq 3-4 macro counts
    and per-round periods, validated by `simulator.py`):

        t_gpp    ∝ t_rw                 (bus saturated, 100% macro util)
        t_insitu ∝ t_pim + t_rw
        t_naive  ∝ max(t_pim, t_rw)

    i.e. 1 : (n_in*s+size_ou)/size_ou
           : (n_in*s+size_ou+|n_in*s-size_ou|)/(2*size_ou)
    — the reciprocal of the paper's printed right-hand term, matching its
    worked examples.
    """
    nin_s = cfg.n_in * cfg.s
    ou = cfg.size_ou
    t_gpp = 1.0
    t_insitu = (nin_s + ou) / ou
    t_naive = (nin_s + ou + abs(nin_s - ou)) / (2.0 * ou)
    return (t_gpp, t_insitu, t_naive)


def throughput_per_band(cfg: PimConfig, strategy: str) -> float:
    """Aggregate useful compute throughput (weight-bytes*inputs processed per
    cycle, i.e. size_ou-equivalents) sustained by `band`, combining the macro
    count (Eqs 3-4) with the per-macro retention factor.

    This is the quantity behind Fig 6(a): execution latency of a fixed
    workload is workload / throughput.
    """
    n = num_macros(cfg, strategy)
    per_macro = cfg.size_ou  # bytes of weights consumed per cycle while computing
    if strategy == "insitu":
        duty = cfg.time_pim / (cfg.time_pim + cfg.time_rewrite)
        return n * per_macro * duty
    if strategy == "naive_pp":
        return n * per_macro * naive_pp_perf_factor(cfg) * (
            cfg.time_pim / (cfg.time_pim + cfg.time_rewrite)
        ) * 2.0
    if strategy == "gpp":
        duty = cfg.time_pim / (cfg.time_pim + cfg.time_rewrite)
        return n * per_macro * duty
    raise ValueError(f"unknown strategy {strategy!r}")


# ---------------------------------------------------------------------------
# Eqs 7-9: runtime-phase bandwidth-reduction adaptation
# ---------------------------------------------------------------------------

def insitu_perf_degradation(cfg: PimConfig, n: float) -> float:
    """Eq 7 — in-situ: keep all macros, slow the rewrite by n.

    remaining perf = (t_pim + t_rw) / (t_pim + n*t_rw).
    """
    tp, tr = cfg.time_pim, cfg.time_rewrite
    return (tp + tr) / (tp + n * tr)


def naive_pp_perf_degradation(cfg: PimConfig, n: float) -> float:
    """Eq 8 — naive ping-pong under band/n.

    While t_pim > t_rw*n' the slowdown only eats idle time (perf flat); once
    rewrite dominates, performance falls as 1/n relative to the t_pim==t_rw
    point.  Design-phase anchor in the paper is t_pim == t_rw, so degradation
    is simply 1/n from there; we implement the general form.
    """
    tp, tr = cfg.time_pim, cfg.time_rewrite
    eff_tr = n * tr
    if eff_tr <= tp:
        # still hidden by compute; each macro pair alternates perfectly.
        return 1.0
    # rewrite dominates: throughput ∝ 1/eff_tr; normalize to the undegraded
    # naive-pp throughput (∝ 1/max(tp, tr)).
    return max(tp, tr) / eff_tr


def gpp_perf_degradation(cfg: PimConfig, n: float) -> float:
    """Eq 9 — generalized ping-pong under band/n.

    GPP reduces active macros to num/m and lets each survivor use m× the
    on-chip buffer => n_in' = m*n_in => t_pim' = m*t_pim.  m solves
        (t_rw*s/(t_pim' + t_rw)) * num/m = band/n
    which is a quadratic in m; perf retention is (throughput')/(throughput) =
    (num/m * 1) / num = 1/m ... but each macro also computes the same rate, so
    retention = 1/m with m from Eq 9:

        perf = 2*(n_in*s + size_ou) /
               (size_ou + sqrt(size_ou^2 + 4*num*size_ou*n_in*s^2*n / band))

    (paper Eq 9, with num = num_macro at design point).
    """
    num = num_macros(cfg, "gpp")
    ou, s, nin, band = cfg.size_ou, cfg.s, cfg.n_in, cfg.band
    denom = ou + math.sqrt(ou * ou + 4.0 * num * ou * nin * s * s * n / band)
    return 2.0 * (nin * s + ou) / denom


def gpp_adapted_point(cfg: PimConfig, n: float) -> PimConfig:
    """Return the adapted operating point (fewer macros, larger n_in) GPP
    chooses when bandwidth drops to band/n.  Solves for m such that the
    surviving num/m macros exactly saturate band/n."""
    perf = gpp_perf_degradation(cfg, n)
    m = 1.0 / perf
    return cfg.with_(n_in=cfg.n_in * m, band=cfg.band / n)
