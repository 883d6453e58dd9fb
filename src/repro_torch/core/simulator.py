"""Cycle-accurate discrete-event simulator for multi-macro PIM pipelines.

Stand-in for the paper's synthesizable-Verilog timing simulation: N macros
share one off-chip bus of `band` bytes/cycle through a fair arbiter (each
active rewriter gets min(s, band/k) for k rewriters); each macro must
  rewrite(size_macro bytes)  then  compute(t_pim cycles)
for each of `rounds` consecutive GeMMs (weights change every round — the
streaming regime the paper targets).  Strategies differ in *when* a macro may
start each phase:

  insitu    all macros synchronize on both phase boundaries (Fig 3a)
  naive_pp  two banks, synchronized swap: one computes GeMM n while the other
            rewrites weights for GeMM n+1 (Fig 3b)
  gpp       staggered free-running macros per schedule.build_gpp (Fig 3c)

Simulation is exact event-driven integration (rates are piecewise constant),
no time-step quantization.

A copy of `repro.core.simulator`; the parity tests hold
tests hold the two to the same outputs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.analytical import PimConfig
from repro_torch.core import schedule as sched

_EPS = 1e-9


@dataclasses.dataclass
class SimResult:
    strategy: str
    num_macros: int
    rounds: int
    total_cycles: float
    compute_cycles: float      # sum over macros of cycles spent computing
    rewrite_cycles: float      # sum over macros of cycles spent rewriting
    bytes_transferred: float
    peak_bandwidth: float      # max instantaneous bus demand [B/cycle]
    bw_busy_cycles: float      # cycles with nonzero bus traffic

    @property
    def macro_utilization(self) -> float:
        """Busy (compute or rewrite) fraction averaged over macros."""
        return (self.compute_cycles + self.rewrite_cycles) / (
            self.total_cycles * self.num_macros
        )

    @property
    def compute_utilization(self) -> float:
        """Computing fraction averaged over macros (Fig 7d notion)."""
        return self.compute_cycles / (self.total_cycles * self.num_macros)

    @property
    def bandwidth_utilization(self) -> float:
        """Fraction of cycles with bus traffic in flight (Fig 7c)."""
        return self.bw_busy_cycles / self.total_cycles

    @property
    def avg_bandwidth(self) -> float:
        return self.bytes_transferred / self.total_cycles

    @property
    def throughput(self) -> float:
        """Completed macro-GeMM rounds per cycle."""
        return self.num_macros * self.rounds / self.total_cycles


def _rewrite_time(cfg: PimConfig, k: int) -> float:
    """Cycles for k macros to rewrite concurrently through the arbiter."""
    if k == 0:
        return 0.0
    rate = min(cfg.s, cfg.band / k)
    return cfg.size_macro / rate


def simulate_insitu(cfg: PimConfig, num_macros: int, rounds: int) -> SimResult:
    tp = cfg.time_pim
    tr = _rewrite_time(cfg, num_macros)
    rate = min(cfg.s, cfg.band / num_macros) * num_macros
    total = rounds * (tr + tp)
    return SimResult(
        strategy="insitu",
        num_macros=num_macros,
        rounds=rounds,
        total_cycles=total,
        compute_cycles=num_macros * rounds * tp,
        rewrite_cycles=num_macros * rounds * tr,
        bytes_transferred=num_macros * rounds * cfg.size_macro,
        peak_bandwidth=rate,
        bw_busy_cycles=rounds * tr,
    )


def simulate_naive_pp(cfg: PimConfig, num_macros: int, rounds: int) -> SimResult:
    """Two synchronized banks; each macro computes `rounds` GeMMs.

    Phase p: bank (p%2) computes its current round; the other bank rewrites
    its next round (if any).  Both must finish before the swap (barrier).
    """
    tp = cfg.time_pim
    half = num_macros - num_macros // 2  # bank0 size (>= bank1)
    sizes = (half, num_macros - half)
    tr = [_rewrite_time(cfg, k) for k in sizes]
    loaded = [0, 0]       # rounds of weights loaded per bank
    done = [0, 0]         # rounds computed per bank
    t = 0.0
    compute_cycles = rewrite_cycles = bytes_moved = bw_busy = 0.0
    peak_bw = 0.0

    # warm-up: bank0 rewrites its first weights alone
    t += tr[0]
    bw_busy += tr[0]
    rewrite_cycles += sizes[0] * tr[0]
    bytes_moved += sizes[0] * cfg.size_macro
    peak_bw = max(peak_bw, min(cfg.s, cfg.band / sizes[0]) * sizes[0])
    loaded[0] = 1

    p = 0
    guard = 0
    while done[0] < rounds or done[1] < rounds:
        guard += 1
        if guard > 8 * rounds + 64:
            raise RuntimeError("naive_pp wedged")
        cb, rb = p % 2, 1 - p % 2
        dur_c = tp if (done[cb] < rounds and loaded[cb] > done[cb]) else 0.0
        needs_rw = loaded[rb] < rounds
        dur_r = tr[rb] if needs_rw and sizes[rb] else 0.0
        dur = max(dur_c, dur_r)
        if dur == 0.0:
            p += 1
            continue
        if dur_c:
            compute_cycles += sizes[cb] * tp
            done[cb] += 1
        if dur_r:
            rewrite_cycles += sizes[rb] * dur_r
            bytes_moved += sizes[rb] * cfg.size_macro
            bw_busy += dur_r
            peak_bw = max(peak_bw, min(cfg.s, cfg.band / sizes[rb]) * sizes[rb])
            loaded[rb] += 1
        t += dur
        p += 1

    return SimResult(
        strategy="naive_pp",
        num_macros=num_macros,
        rounds=rounds,
        total_cycles=t,
        compute_cycles=compute_cycles,
        rewrite_cycles=rewrite_cycles,
        bytes_transferred=bytes_moved,
        peak_bandwidth=peak_bw,
        bw_busy_cycles=bw_busy,
    )


def simulate_gpp(cfg: PimConfig, num_macros: int, rounds: int) -> SimResult:
    """Staggered free-running macros with a fair bus arbiter (event-driven).

    Vectorized over macros with numpy: per-event work is O(1) numpy kernels
    instead of Python for-loops over every macro, so `num_macros >= 1024`
    DSE sweeps (core/dse.py) stop being quadratic in Python.  Event semantics
    are identical to `simulate_gpp_scalar` (asserted by
    tests/test_sim_vectorized.py).
    """
    tp = cfg.time_pim
    size = cfg.size_macro
    period = tp + cfg.time_rewrite
    groups = sched.gpp_group_count(cfg)

    WAIT, REWRITE, COMPUTE, DONE = range(4)
    phase = np.full(num_macros, WAIT, dtype=np.int8)
    remaining = np.zeros(num_macros, dtype=np.float64)
    round_no = np.zeros(num_macros, dtype=np.int64)
    release = (np.arange(num_macros) % groups) * (period / groups)

    t = 0.0
    compute_cycles = rewrite_cycles = bytes_moved = bw_busy = 0.0
    peak_bw = 0.0
    guard = 0
    max_events = 16 * num_macros * rounds + 4096

    while (phase != DONE).any():
        guard += 1
        if guard > max_events:
            raise RuntimeError(f"gpp sim wedged N={num_macros}")
        # admit waiting macros whose stagger release has passed
        admit = (phase == WAIT) & (t + _EPS >= release)
        phase[admit] = REWRITE
        remaining[admit] = size

        rewriting = phase == REWRITE
        computing = phase == COMPUTE
        waiting = phase == WAIT
        k = int(rewriting.sum())
        rate = min(cfg.s, cfg.band / k) if k else 0.0
        bus = rate * k
        peak_bw = max(peak_bw, bus)

        dt = math.inf
        if k and rate > 0:
            dt = min(dt, float(remaining[rewriting].min()) / rate)
        if computing.any():
            dt = min(dt, float(remaining[computing].min()))
        if waiting.any():
            dt = min(dt, float(np.maximum(_EPS, release[waiting] - t).min()))
        if not math.isfinite(dt):
            raise RuntimeError("gpp sim: no runnable macro")

        t += dt
        if bus > 0:
            bw_busy += dt
            bytes_moved += bus * dt
        if k:
            remaining[rewriting] -= rate * dt
            rewrite_cycles += k * dt
            rw_done = rewriting & (remaining <= _EPS * size)
            phase[rw_done] = COMPUTE
            remaining[rw_done] = tp
        if computing.any():
            remaining[computing] -= dt
            compute_cycles += int(computing.sum()) * dt
            cp_done = computing & (remaining <= _EPS * max(tp, 1.0))
            round_no[cp_done] += 1
            finished = cp_done & (round_no >= rounds)
            again = cp_done & ~finished
            phase[finished] = DONE
            phase[again] = REWRITE
            remaining[again] = size

    return SimResult(
        strategy="gpp",
        num_macros=num_macros,
        rounds=rounds,
        total_cycles=t,
        compute_cycles=compute_cycles,
        rewrite_cycles=rewrite_cycles,
        bytes_transferred=bytes_moved,
        peak_bandwidth=peak_bw,
        bw_busy_cycles=bw_busy,
    )


def simulate_gpp_scalar(cfg: PimConfig, num_macros: int, rounds: int) -> SimResult:
    """Reference scalar event loop (pre-vectorization), kept as the oracle for
    the numpy path above — one Python iteration per macro per event."""
    tp = cfg.time_pim
    size = cfg.size_macro
    period = tp + cfg.time_rewrite
    groups = sched.gpp_group_count(cfg)

    WAIT, REWRITE, COMPUTE, DONE = range(4)
    phase = [WAIT] * num_macros
    remaining = [0.0] * num_macros
    round_no = [0] * num_macros
    release = [(m % groups) * period / groups for m in range(num_macros)]

    t = 0.0
    compute_cycles = rewrite_cycles = bytes_moved = bw_busy = 0.0
    peak_bw = 0.0
    guard = 0
    max_events = 16 * num_macros * rounds + 4096

    while any(p != DONE for p in phase):
        guard += 1
        if guard > max_events:
            raise RuntimeError(f"gpp sim wedged N={num_macros}")
        # admit waiting macros whose stagger release has passed
        for m in range(num_macros):
            if phase[m] == WAIT and t + _EPS >= release[m]:
                phase[m] = REWRITE
                remaining[m] = size

        rewriters = [m for m in range(num_macros) if phase[m] == REWRITE]
        k = len(rewriters)
        rate = min(cfg.s, cfg.band / k) if k else 0.0
        bus = rate * k
        peak_bw = max(peak_bw, bus)

        dt = math.inf
        for m in range(num_macros):
            if phase[m] == REWRITE and rate > 0:
                dt = min(dt, remaining[m] / rate)
            elif phase[m] == COMPUTE:
                dt = min(dt, remaining[m])
            elif phase[m] == WAIT:
                dt = min(dt, max(_EPS, release[m] - t))
        if not math.isfinite(dt):
            raise RuntimeError("gpp sim: no runnable macro")

        t += dt
        if bus > 0:
            bw_busy += dt
            bytes_moved += bus * dt
        for m in range(num_macros):
            if phase[m] == REWRITE:
                remaining[m] -= rate * dt
                rewrite_cycles += dt
                if remaining[m] <= _EPS * size:
                    phase[m] = COMPUTE
                    remaining[m] = tp
            elif phase[m] == COMPUTE:
                remaining[m] -= dt
                compute_cycles += dt
                if remaining[m] <= _EPS * max(tp, 1.0):
                    round_no[m] += 1
                    if round_no[m] >= rounds:
                        phase[m] = DONE
                    else:
                        phase[m] = REWRITE
                        remaining[m] = size

    return SimResult(
        strategy="gpp",
        num_macros=num_macros,
        rounds=rounds,
        total_cycles=t,
        compute_cycles=compute_cycles,
        rewrite_cycles=rewrite_cycles,
        bytes_transferred=bytes_moved,
        peak_bandwidth=peak_bw,
        bw_busy_cycles=bw_busy,
    )


def simulate(strategy: str, cfg: PimConfig, num_macros: int, rounds: int) -> SimResult:
    fn = {
        "insitu": simulate_insitu,
        "naive_pp": simulate_naive_pp,
        "gpp": simulate_gpp,
    }.get(strategy)
    if fn is None:
        raise ValueError(f"unknown strategy {strategy!r}")
    if num_macros < 1 or rounds < 1:
        raise ValueError("num_macros and rounds must be >= 1")
    return fn(cfg, num_macros, rounds)
