"""GPP planners: the reference's schedule IR, stream/serve planners and
timing cache, plus sm_90 ring plans.

The schedule IR and its builders (`ScheduleOp`, `Schedule`,
`gpp_group_count`, `gpp_concurrent_rewriters`, `build_insitu` /
`build_naive_pp` / `build_gpp` / `build`), `round_up`, `plan_stream`,
`plan_serve_chunk`, `plan_verify_budget`, `tokens_per_step_cov` and the
measured-timing feedback (`TimingSample`, `TimingCache`,
`set_default_timing_cache` / `get_default_timing_cache`; the default stays
None) are copies of `repro.core.schedule`.  The TPU tile
planners (v5e rates, ~100 MiB VMEM budget, (8, 128) tiling) do not carry
over; in their place `plan_matmul_fma_sm90` (the FMA
route of `gpp_matmul` and, with an expert axis, of `gpp_matmul_grouped`),
`plan_matmul_tc_sm90` and `plan_grouped_tc_sm90` (their tensor-core
routes),
`plan_paged_attn_fma_sm90`, `plan_paged_attn_mla_tc_sm90` and
`plan_paged_attn_gqa_tc_sm90` pick the tile
sizes and the shared-memory ring depth G of the CUDA kernels:

  * G comes from `plan_stream` at the H100's rates (989e12 bf16 FLOP/s,
    3.35e12 B/s): G = ceil(t_transfer / t_compute) + 1, so a DMA-bound tile
    (small M, the decode regime) gets a deep ring and a compute-bound one
    degenerates to double buffering — the paper's Eq. 4 on the card;
  * G then shrinks until the block's shared memory fits 227 KB.

The shared-memory formulas here are the ones the CUDA sources lay out
(`kernels/csrc/*.cu`); keep the two in lockstep.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import statistics

from repro_torch.core.analytical import PimConfig

# NVIDIA H100 SXM data sheet (dense, 700 W)
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_SMS = 132
SMEM_BUDGET_BYTES = 232_448          # 227 KB dynamic shared memory per block
MAX_RING = 8


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of `mult` >= x (tile, block, and chunk sizing)."""
    return ((x + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# the schedule IR and its builders (copies)
# ---------------------------------------------------------------------------

KIND_REWRITE = "rewrite"
KIND_COMPUTE = "compute"


@dataclasses.dataclass(frozen=True)
class ScheduleOp:
    macro: int
    kind: str          # "rewrite" | "compute"
    start: float       # cycles
    dur: float         # cycles
    nbytes: float      # off-chip bytes moved (0 for compute)

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclasses.dataclass(frozen=True)
class Schedule:
    ops: tuple[ScheduleOp, ...]
    num_macros: int
    cfg: PimConfig
    strategy: str

    @property
    def makespan(self) -> float:
        return max((op.end for op in self.ops), default=0.0)

    def bandwidth_profile(self, resolution: int = 2048) -> "list[float]":
        """Off-chip bandwidth demand sampled over the makespan [B/cycle]."""
        span = self.makespan
        if span <= 0:
            return []
        out = [0.0] * resolution
        dt = span / resolution
        for op in self.ops:
            if op.kind != KIND_REWRITE or op.dur <= 0:
                continue
            rate = op.nbytes / op.dur
            i0 = int(op.start / dt)
            i1 = min(resolution - 1, int((op.end - 1e-9) / dt))
            for i in range(i0, i1 + 1):
                lo = max(op.start, i * dt)
                hi = min(op.end, (i + 1) * dt)
                out[i] += rate * max(0.0, hi - lo) / dt
        return out

    def peak_bandwidth(self) -> float:
        """Exact peak instantaneous bandwidth demand [B/cycle]."""
        events: list[tuple[float, float]] = []
        for op in self.ops:
            if op.kind != KIND_REWRITE or op.dur <= 0:
                continue
            rate = op.nbytes / op.dur
            events.append((op.start, rate))
            events.append((op.end, -rate))
        events.sort()
        cur = peak = 0.0
        for _, delta in events:
            cur += delta
            peak = max(peak, cur)
        return peak

    def avg_bandwidth(self) -> float:
        total = sum(op.nbytes for op in self.ops if op.kind == KIND_REWRITE)
        return total / self.makespan if self.makespan else 0.0

    def bandwidth_idle_fraction(self) -> float:
        """Fraction of the makespan with zero rewrite traffic in flight."""
        span = self.makespan
        if span <= 0:
            return 0.0
        ivals = sorted(
            (op.start, op.end) for op in self.ops if op.kind == KIND_REWRITE
        )
        busy = 0.0
        cur_s = cur_e = None
        for s, e in ivals:
            if cur_s is None:
                cur_s, cur_e = s, e
            elif s <= cur_e:
                cur_e = max(cur_e, e)
            else:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
        if cur_s is not None:
            busy += cur_e - cur_s
        return 1.0 - busy / span

    def macro_utilization(self) -> float:
        """Mean fraction of the makespan each macro spends busy (either op)."""
        span = self.makespan
        if span <= 0:
            return 0.0
        busy = sum(op.dur for op in self.ops)
        return busy / (span * self.num_macros)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def gpp_group_count(cfg: PimConfig) -> int:
    """Number of stagger groups G = round((t_pim + t_rw) / t_rw), >= 2.

    With G groups, group k starts its rewrite at k*(t_pim+t_rw)/G; exactly
    num/G macros rewrite at any instant when the ratio divides evenly.
    """
    tp, tr = cfg.time_pim, cfg.time_rewrite
    return max(2, round((tp + tr) / tr))


def gpp_concurrent_rewriters(cfg: PimConfig, num_macros: int) -> float:
    """Average number of simultaneously-rewriting macros under GPP."""
    tp, tr = cfg.time_pim, cfg.time_rewrite
    return num_macros * tr / (tp + tr)


def build_insitu(cfg: PimConfig, num_macros: int, rounds: int) -> Schedule:
    """All macros rewrite together, then all compute together."""
    tp, tr = cfg.time_pim, cfg.time_rewrite
    ops = []
    for r in range(rounds):
        t0 = r * (tp + tr)
        for m in range(num_macros):
            ops.append(ScheduleOp(m, KIND_REWRITE, t0, tr, cfg.size_macro))
            ops.append(ScheduleOp(m, KIND_COMPUTE, t0 + tr, tp, 0.0))
    return Schedule(tuple(ops), num_macros, cfg, "insitu")


def build_naive_pp(cfg: PimConfig, num_macros: int, rounds: int) -> Schedule:
    """Two synchronized banks: one computes GeMM n while the other rewrites
    weights for GeMM n+1; banks swap when BOTH finish (paper Fig 3b)."""
    tp, tr = cfg.time_pim, cfg.time_rewrite
    period = max(tp, tr)
    half = num_macros // 2
    bank = [0] * half + [1] * (num_macros - half)
    ops = []
    # phase p: bank (p % 2) computes round p, bank ((p+1) % 2) rewrites
    # weights for round p+1.  Warm-up: bank0 rewrites round 0 first.
    for m in range(num_macros):
        if bank[m] == 0:
            ops.append(ScheduleOp(m, KIND_REWRITE, 0.0, tr, cfg.size_macro))
    t0 = tr  # steady phases start after warm-up fill
    for p in range(rounds):
        comp_bank = p % 2
        for m in range(num_macros):
            if bank[m] == comp_bank:
                ops.append(ScheduleOp(m, KIND_COMPUTE, t0, tp, 0.0))
            elif p + 1 < rounds:
                ops.append(ScheduleOp(m, KIND_REWRITE, t0, tr, cfg.size_macro))
        t0 += period
    return Schedule(tuple(ops), num_macros, cfg, "naive_pp")


def build_gpp(cfg: PimConfig, num_macros: int, rounds: int) -> Schedule:
    """Generalized ping-pong: macro groups stagger rewrite starts so that
    off-chip traffic is flat and no macro ever idles (paper Fig 3c)."""
    tp, tr = cfg.time_pim, cfg.time_rewrite
    period = tp + tr
    groups = gpp_group_count(cfg)
    ops = []
    for m in range(num_macros):
        g = m % groups
        offset = g * period / groups
        for r in range(rounds):
            t0 = offset + r * period
            ops.append(ScheduleOp(m, KIND_REWRITE, t0, tr, cfg.size_macro))
            ops.append(ScheduleOp(m, KIND_COMPUTE, t0 + tr, tp, 0.0))
    return Schedule(tuple(ops), num_macros, cfg, "gpp")


def build(strategy: str, cfg: PimConfig, num_macros: int, rounds: int) -> Schedule:
    return {
        "insitu": build_insitu,
        "naive_pp": build_naive_pp,
        "gpp": build_gpp,
    }[strategy](cfg, num_macros, rounds)


# ---------------------------------------------------------------------------
# the stream planner (a copy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """GPP plan for streaming weight blocks through a compute pipeline.

    ring_depth   buffers held at once (blocks in flight + the one computing)
    chunks       chunks each block's transfer is split into
    t_compute / t_transfer   per-block time estimates [s]
    """

    ring_depth: int
    chunks: int
    t_compute: float
    t_transfer: float

    @property
    def ratio(self) -> float:
        return self.t_compute / self.t_transfer if self.t_transfer else math.inf


def plan_stream(*, block_bytes: float, compute_flops: float,
                flops_per_s: float, transfer_bytes_per_s: float,
                max_ring: int = MAX_RING) -> StreamPlan:
    """Ring depth & chunking for streaming blocks (the paper's Eq. 4):
    ring = ceil(t_tr / t_cmp) + 1 buffers keep compute from waiting."""
    t_cmp = compute_flops / flops_per_s
    t_tr = block_bytes / transfer_bytes_per_s
    if t_cmp <= 0:
        return StreamPlan(2, 1, t_cmp, t_tr)
    ring = min(max_ring, max(2, math.ceil(t_tr / t_cmp) + 1))
    chunks = max(1, round(t_cmp / t_tr)) if t_tr > 0 else 1
    return StreamPlan(ring, chunks, t_cmp, t_tr)


# ---------------------------------------------------------------------------
# serving planners (copies)
# ---------------------------------------------------------------------------

def plan_serve_chunk(*, token_budget: int, decode_lanes: int,
                     block_size: int, cached_tokens: int = 0) -> int:
    """Prefill chunk size: the largest KV-block multiple that keeps one
    step (decode lanes + one chunk) at or under the flat token budget."""
    if block_size < 1:
        raise ValueError("block_size >= 1")
    if decode_lanes < 0:
        raise ValueError("decode_lanes >= 0")
    if cached_tokens < 0:
        raise ValueError("cached_tokens >= 0")
    spare = max(block_size, token_budget + cached_tokens - decode_lanes)
    return max(block_size, (spare // block_size) * block_size)


def plan_verify_budget(*, token_budget: int, prefill_tokens: int,
                       decode_lanes: int) -> int:
    """Draft tokens a verify step may add: the slack the prefill chunk and
    the decode lanes leave under the flat token budget."""
    if token_budget < 0:
        raise ValueError("token_budget >= 0")
    if prefill_tokens < 0:
        raise ValueError("prefill_tokens >= 0")
    if decode_lanes < 0:
        raise ValueError("decode_lanes >= 0")
    return max(0, token_budget - prefill_tokens - decode_lanes)


def tokens_per_step_cov(counts: "list[int] | list[float]") -> float:
    """Coefficient of variation of per-step token counts (0 = flat)."""
    counts = [float(c) for c in counts]
    if not counts:
        return 0.0
    mean = sum(counts) / len(counts)
    if mean == 0:
        return 0.0
    return statistics.pstdev(counts) / mean


# ---------------------------------------------------------------------------
# measured-timing feedback (copies)
# ---------------------------------------------------------------------------

TIMING_PROVENANCES = ("host", "compiled")


@dataclasses.dataclass(frozen=True)
class TimingSample:
    """One measured (transfer, compute) pair for a weight tile.

    block_bytes / compute_flops describe the tile the measurement was taken
    on; t_dma / t_compute are the measured wall-times [s] to move and to
    matmul that tile.  Rates (bytes/s, flop/s) are what the planner consumes,
    so samples at any tile size inform plans at every tile size.

    measured_on records provenance: "host" samples come from eager/CPU timing
    loops (dispatch overhead, no real HBM), "compiled" samples from a
    compiled run on the accelerator the plan will execute on.  Consumers
    (`TimingCache.effective_rates`) prefer compiled samples when any exist —
    a host-measured rate is a stand-in, not ground truth.
    """

    block_bytes: float
    compute_flops: float
    t_dma: float
    t_compute: float
    measured_on: str = "host"

    @property
    def bytes_per_s(self) -> float:
        return self.block_bytes / self.t_dma if self.t_dma > 0 else math.inf

    @property
    def flops_per_s(self) -> float:
        return self.compute_flops / self.t_compute if self.t_compute > 0 else math.inf


class TimingCache:
    """Measured per-tile t_dma/t_compute samples feeding the ring-depth
    plan (`kernels.ops.plan_ring_depth`).

    The analytic model (the H100's data-sheet rates) is an ideal; real
    kernels see epilogue overheads, copy contention and clock throttling.
    `chip_smoke.py` records what one tile of the GeMM sequence costs on the
    card (`measured_on="compiled"`) and the planner can then size the ring
    against median measured rates instead of the ideal — the paper's
    runtime-adaptation loop (Fig 7) applied to the CUDA mapping.
    """

    def __init__(self, samples: "list[TimingSample] | tuple[TimingSample, ...]" = ()):
        self._samples: list[TimingSample] = list(samples)

    def __len__(self) -> int:
        return len(self._samples)

    @property
    def samples(self) -> "tuple[TimingSample, ...]":
        return tuple(self._samples)

    def record(self, *, block_bytes: float, compute_flops: float,
               t_dma: float, t_compute: float,
               measured_on: str = "host") -> None:
        if block_bytes <= 0 or compute_flops <= 0:
            raise ValueError("block_bytes and compute_flops must be positive")
        if t_dma < 0 or t_compute < 0:
            raise ValueError("measured times must be non-negative")
        if measured_on not in TIMING_PROVENANCES:
            raise ValueError(
                f"measured_on must be one of {TIMING_PROVENANCES}, "
                f"got {measured_on!r}")
        self._samples.append(TimingSample(block_bytes, compute_flops,
                                          t_dma, t_compute, measured_on))

    def effective_rates(self) -> "tuple[float, float]":
        """(flops_per_s, transfer_bytes_per_s) — median of per-sample rates.

        Median (not mean): one cold-cache or preempted sample must not drag
        the plan; the planner wants the steady-state rate.  When any
        compiled-run samples exist they are used exclusively — host-measured
        rates (eager dispatch, no real HBM link) only stand in until a
        compiled path has been profiled.
        """
        if not self._samples:
            raise ValueError("TimingCache has no samples")
        pool = [s for s in self._samples if s.measured_on == "compiled"] \
            or self._samples
        fps = statistics.median(s.flops_per_s for s in pool)
        bps = statistics.median(s.bytes_per_s for s in pool)
        return fps, bps

    # ---- persistence (JSON lists of samples) ----
    def to_json(self) -> "list[dict]":
        return [dataclasses.asdict(s) for s in self._samples]

    @classmethod
    def from_json(cls, entries: "list[dict]") -> "TimingCache":
        return cls([TimingSample(**e) for e in entries])

    @classmethod
    def from_bench_json(cls, path: str,
                        key: str = "dense_timing_samples") -> "TimingCache":
        """Load the samples a benchmark JSON holds under entry `key`,
        field "samples" (the reference's BENCH_kernels.json layout)."""
        import json
        with open(path) as f:
            bench = json.load(f)
        entry = bench.get(key) or {}
        return cls.from_json(entry.get("samples", []))


_DEFAULT_TIMING: "TimingCache | None" = None


def set_default_timing_cache(cache: "TimingCache | None") -> None:
    """Install measurements for every subsequent `kernels.ops.plan_ring_depth`
    call that doesn't pass its own `timing` (None clears)."""
    global _DEFAULT_TIMING
    _DEFAULT_TIMING = cache


def get_default_timing_cache() -> "TimingCache | None":
    return _DEFAULT_TIMING


# ---------------------------------------------------------------------------
# sm_90 plans for the CUDA kernels
# ---------------------------------------------------------------------------

GPP_BLOCK_N = 64         # FMA route: output columns of a tile
GPP_MAX_BLOCK_M = 64     # its rows of a tile: 4 row groups x <= 16 rows


def _ring_depth(block_bytes: float, flops: float, flops_per_s: float) -> int:
    return plan_stream(block_bytes=block_bytes, compute_flops=flops,
                       flops_per_s=flops_per_s,
                       transfer_bytes_per_s=H100_HBM_BYTES_PER_S).ring_depth


GPP_TC_BLOCK_N = 128         # output columns of one tensor-core unit
GPP_TC_BLOCK_KS = (128, 64)  # k rows a step, largest first
GPP_TC_MAX_BLOCK_M = 128     # rows of a unit: an expert's rows up to 128


@dataclasses.dataclass(frozen=True)
class GroupedTcPlan:
    """`gpp_matmul_grouped`'s tensor-core route (bf16 x and W).  A unit is
    one (expert, n-tile, m-tile), numbered expert-major with the m-tile
    innermost; `grid` persistent CTAs (`ctas_per_sm` to an SM) each walk
    a contiguous run of units, `cta_units(i)`, and stream the (block_k,
    block_n) W tiles of the run's k-steps through one num_bufs-slot ring
    in `chunks` chunks, the x tile of each step beside it in two slots."""

    E: int
    M: int
    K: int
    N: int
    block_m: int
    block_n: int
    block_k: int
    num_bufs: int
    chunks: int
    ctas_per_sm: int
    smem_bytes: int

    @property
    def m_tiles(self) -> int:
        return -(-self.M // self.block_m)

    @property
    def n_tiles(self) -> int:
        return -(-self.N // self.block_n)

    @property
    def num_k(self) -> int:
        return -(-self.K // self.block_k)

    @property
    def units(self) -> int:
        return self.E * self.n_tiles * self.m_tiles

    @property
    def grid(self) -> int:
        return min(self.units, self.ctas_per_sm * H100_SMS)

    def cta_units(self, i: int) -> range:
        """The units CTA i walks: [floor(i*U/P), floor((i+1)*U/P))."""
        U, P = self.units, self.grid
        return range(i * U // P, (i + 1) * U // P)

    def cta_steps(self, i: int) -> int:
        return len(self.cta_units(i)) * self.num_k

    def unit(self, u: int) -> "tuple[int, int, int]":
        """(expert, n-tile, m-tile) of unit u."""
        e, r = divmod(u, self.n_tiles * self.m_tiles)
        return (e, *divmod(r, self.m_tiles))


def grouped_tc_smem_bytes(bm: int, bk: int, G: int) -> int:
    """G-slot bf16 W ring of (bk, 128) tiles + two bf16 (bm, bk) x slots;
    rows are swizzled, not padded (gpp_matmul_grouped.cu)."""
    return G * bk * GPP_TC_BLOCK_N * 2 + 2 * bm * bk * 2


def plan_grouped_tc_sm90(E: int, M: int, K: int, N: int, *,
                         num_bufs: "int | None" = None,
                         smem_budget: int = SMEM_BUDGET_BYTES
                         ) -> GroupedTcPlan:
    """Plan for the tensor-core route of `gpp_matmul_grouped`.

    block_m is the smallest of 16, 32, 64, 128 that covers M (so each W
    tile streams once a call for M <= 128).  Each step issues one (block_k,
    128) W tile (and its x tile); the ring's wait forces a tile's last
    chunk one step after its issue and the others two (csrc/ring.cuh), so
    tile bytes a step, and up to two steps of them at G >= 3, are what is
    in flight.  The plan takes two CTAs an SM (they
    also overlap each other's waits) and the largest block_k whose ring
    fits half the budget, with G from `plan_stream` shrunk to fit, down to
    in-situ: decode (32 rows) keeps 128-row tiles on a G = 3 ring, prefill
    (128 rows, whose x tiles take half the room) 128-row tiles in situ
    (PERF.md).  A pinned `num_bufs` is kept (clamped to the steps a
    CTA walks) and the tile or the CTAs an SM give way."""
    if min(E, M, K, N) < 1:
        raise ValueError(f"empty grouped matmul {E}x{M}x{K}x{N}")
    if num_bufs is not None and num_bufs < 1:
        raise ValueError("num_bufs >= 1")
    bm = 16
    while bm < min(M, GPP_TC_MAX_BLOCK_M):
        bm *= 2
    bn = GPP_TC_BLOCK_N
    units = E * -(-N // bn) * -(-M // bm)
    for ctas in (2, 1):
        budget = smem_budget // ctas
        for bk in GPP_TC_BLOCK_KS:
            shortest = units // min(units, ctas * H100_SMS) * -(-K // bk)
            G = num_bufs if num_bufs is not None else _ring_depth(
                bk * bn * 2, 2.0 * bm * bk * bn, H100_BF16_FLOPS)
            G = min(G, max(1, shortest))   # deeper than the steps idles
            if num_bufs is None:
                while G > 1 and grouped_tc_smem_bytes(bm, bk, G) > budget:
                    G -= 1
            smem = grouped_tc_smem_bytes(bm, bk, G)
            if smem <= budget:
                return GroupedTcPlan(E, M, K, N, bm, bn, bk, G,
                                     max(1, min(G - 1, bk)), ctas, smem)
    raise ValueError(f"gpp_matmul_grouped tensor-core ring of {num_bufs} "
                     f"does not fit {smem_budget} bytes of shared memory")


GPP_MM_TC_BLOCK_NS = (128, 64)    # gpp_matmul tensor-core columns a tile
GPP_MM_TC_BLOCK_KS = (256, 128)   # its k rows a step, planned first
GPP_MM_TC_CLUSTERS = (1, 2, 4, 8)     # its planned cluster sizes (portable)
GPP_MM_TC_MAX_CLUSTER = 16       # with the non-portable attribute (pins)
GPP_MM_TC_CTAS = 96              # the most CTAs a split takes (the sweep,
                                 # PERF.md: 64-96 CTAs of 64 KB steps beat
                                 # 128-192 at the path shapes; the H100
                                 # holds 15 clusters of 8, 30 of 4 at one
                                 # CTA an SM, so 96 are always resident)
GPP_MM_TC_MAX_RING = 2           # planned rings deeper than ping-pong ran
                                 # slower on the card (PERF.md)
SM_SMEM_BYTES = 233_472          # an SM's shared memory for its CTAs
CTA_SMEM_RESERVED = 1_024        # the system's share of it, per CTA
GPP_MM_TC_PART_PAD = 8           # floats after each partial row (bank
                                 # groups of the fragment stores)


@dataclasses.dataclass(frozen=True)
class MatmulTcClusterPlan:
    """`gpp_matmul`'s tensor-core route (bf16 x and W), cluster split-K.
    An output tile is block_m x block_n; each is one cluster of `cluster`
    (S) CTAs, grid (S, n_tiles, m_tiles).  CTA rank r walks k-slice r,
    `k_slice(r)`, a contiguous run of block_k-row k-steps, streaming the
    (block_k, block_n) W tile of each through one num_bufs-slot ring in
    `chunks` chunks, the x tile beside it in two slots.  Its 8 warps hold
    16 columns each and split every step's k rows into `k_groups`
    contiguous parts.  The f32 partials (one a k-group) go to the CTA's own
    shared memory over the ring; rank r then sums `rank_columns(r)` of the
    tile from ranks 0 .. S-1 in order, k-group by k-group, through
    distributed shared memory, and stores them."""

    M: int
    K: int
    N: int
    block_m: int
    block_n: int
    block_k: int
    cluster: int
    num_bufs: int
    chunks: int
    smem_bytes: int

    @property
    def m_tiles(self) -> int:
        return -(-self.M // self.block_m)

    @property
    def n_tiles(self) -> int:
        return -(-self.N // self.block_n)

    @property
    def num_k(self) -> int:
        return -(-self.K // self.block_k)

    @property
    def tiles(self) -> int:
        """Output tiles: one cluster each."""
        return self.m_tiles * self.n_tiles

    @property
    def ctas(self) -> int:
        return self.tiles * self.cluster

    @property
    def grid(self) -> "tuple[int, int, int]":
        """CUDA grid (cluster rank, n-tile, m-tile)."""
        return (self.cluster, self.n_tiles, self.m_tiles)

    @property
    def k_groups(self) -> int:
        """Parts of each step's k rows, one a warp group: 2 at block_n 64
        (4 warps along N), 1 at 128 (8)."""
        return 128 // self.block_n

    def k_slice(self, r: int) -> range:
        """The k-steps rank r walks: [floor(r num_k / S), floor((r+1)
        num_k / S))."""
        S, nk = self.cluster, self.num_k
        return range(r * nk // S, (r + 1) * nk // S)

    def cta_steps(self, r: int) -> int:
        return len(self.k_slice(r))

    def k_rows(self, r: int, g: int) -> "list[int]":
        """The k rows rank r's k-group g multiplies (rows < K), in order."""
        bk, part = self.block_k, self.block_k // self.k_groups
        return [k for s in self.k_slice(r)
                for k in range(s * bk + g * part, s * bk + (g + 1) * part)
                if k < self.K]

    def rank_columns(self, r: int) -> range:
        """The tile's columns rank r sums and stores."""
        w = self.block_n // self.cluster
        return range(r * w, (r + 1) * w)


def matmul_tc_smem_bytes(bm: int, bk: int, bn: int, G: int) -> int:
    """The larger of the G-slot bf16 W ring of (bk, bn) tiles with two bf16
    (bm, bk) x slots (rows swizzled, not padded) and the f32 partials that
    reuse it after the last step, (bm, bn + 8) a k-group
    (csrc/gpp_matmul.cu, gpp_mm_tc::smem_bytes)."""
    ring = G * bk * bn * 2 + 2 * bm * bk * 2
    partial = (128 // bn) * bm * (bn + GPP_MM_TC_PART_PAD) * 4
    return max(ring, partial)


def _tc_split(K: int, N: int) -> "tuple[int, int, int]":
    """(block_n, S, block_k) of the tensor-core route, from K and N alone:
    block_k 256, and for each block_n the largest cluster S (at most one
    k-step a rank) whose n_tiles x S CTAs stay within GPP_MM_TC_CTAS; the
    block_n with more CTAs wins, the wider on a tie.  Where even one CTA a
    tile is more, S = 1 at the block_n with fewer CTAs, and where those
    tiles are more than the SMs but at most twice as many, block_k 128:
    its 2-slot ring lets two CTAs share an SM at up to 64 rows, so every
    tile runs in one wave (at 256 rows one CTA fits an SM, and the tiles
    past the 132nd ran a second wave)."""
    bk = max(GPP_MM_TC_BLOCK_KS)
    num_k = -(-K // bk)
    best = None
    for bn in GPP_MM_TC_BLOCK_NS:
        n_tiles = -(-N // bn)
        S = max([c for c in GPP_MM_TC_CLUSTERS
                 if c <= num_k and n_tiles * c <= GPP_MM_TC_CTAS] or [1])
        ctas = n_tiles * S
        key = (ctas <= GPP_MM_TC_CTAS, ctas if ctas <= GPP_MM_TC_CTAS
               else -ctas)
        if best is None or key > best[0]:
            best = (key, (bn, S, bk))
    bn, S, bk = best[1]
    if S == 1 and H100_SMS < -(-N // bn) <= 2 * H100_SMS:
        bk = min(GPP_MM_TC_BLOCK_KS)
    return bn, S, bk


def plan_matmul_tc_sm90(M: int, K: int, N: int, *,
                        num_bufs: "int | None" = None,
                        block_n: "int | None" = None,
                        cluster: "int | None" = None,
                        block_k: "int | None" = None,
                        smem_budget: int = SMEM_BUDGET_BYTES
                        ) -> MatmulTcClusterPlan:
    """Plan for the tensor-core route of `gpp_matmul` (cluster split-K).

    block_n, the cluster size S and block_k come from K and N alone
    (`_tc_split`), never from M: the narrow projections of the serving
    paths (8-24 n-tiles of 128 columns) put 4 or 8 CTAs on each tile's k
    rows, so the SMs that one CTA a tile left idle each stream a slice of
    a few 64 KB steps.  block_m is M rounded up to 16, 32, 64 or 128 (one
    m-tile at every path shape, so W streams once a launch).  G comes from
    `plan_stream` at H100 rates, clamped to the longest slice and to
    GPP_MM_TC_MAX_RING, then shrunk until the ring fits the shared memory,
    down to in-situ.  A pinned `num_bufs` is kept and block_k halves until
    it fits; `block_n`, `cluster` (up to 16, the non-portable size) and
    `block_k` pins are for tests and sweeps.  Raises when nothing fits."""
    if min(M, K, N) < 1:
        raise ValueError(f"empty matmul {M}x{K}x{N}")
    if num_bufs is not None and num_bufs < 1:
        raise ValueError("num_bufs >= 1")
    if block_n is not None and block_n not in GPP_MM_TC_BLOCK_NS:
        raise ValueError(f"block_n is one of {GPP_MM_TC_BLOCK_NS}, got "
                         f"{block_n}")
    if block_k is not None and block_k not in GPP_MM_TC_BLOCK_KS:
        raise ValueError(f"block_k is one of {GPP_MM_TC_BLOCK_KS}, got "
                         f"{block_k}")
    if cluster is not None and cluster not in GPP_MM_TC_CLUSTERS + (
            GPP_MM_TC_MAX_CLUSTER,):
        raise ValueError(f"cluster is one of {GPP_MM_TC_CLUSTERS} or "
                         f"{GPP_MM_TC_MAX_CLUSTER}, got {cluster}")
    bn, S, bk = _tc_split(K, N)
    bn = block_n or bn
    S = cluster or S
    if block_k is not None:
        bks = (block_k,)
    elif num_bufs is not None:      # the split's block_k, or smaller ones
        bks = [b for b in GPP_MM_TC_BLOCK_KS if b <= bk]
    else:
        bks = (bk,)
    bm = 16
    while bm < min(M, GPP_TC_MAX_BLOCK_M):
        bm *= 2
    for bk in bks:
        num_k = -(-K // bk)
        if S > num_k:
            raise ValueError(f"a cluster of {S} leaves a rank no k-step of "
                             f"{bk} rows at K = {K}")
        G = num_bufs if num_bufs is not None else min(
            _ring_depth(bk * bn * 2, 2.0 * bm * bk * bn, H100_BF16_FLOPS),
            -(-num_k // S),                # deeper than a slice idles
            GPP_MM_TC_MAX_RING)
        if num_bufs is None:
            while G > 1 and matmul_tc_smem_bytes(bm, bk, bn,
                                                 G) > smem_budget:
                G -= 1
        smem = matmul_tc_smem_bytes(bm, bk, bn, G)
        if smem <= smem_budget:
            return MatmulTcClusterPlan(M, K, N, bm, bn, bk, S, G,
                                       max(1, min(G - 1, bk)), smem)
    raise ValueError(f"gpp_matmul tensor-core ring of {num_bufs} does not "
                     f"fit {smem_budget} bytes of shared memory")


H100_F32_FLOPS = 67e12             # f32 FMA on the CUDA cores (dense)
GPP_FMA_BLOCK_KS = (256, 128, 64, 32)   # FMA route k rows a step
GPP_FMA_STEP_S = 1.0e-6            # a step's fixed cost: its wait for one
                                   # memory round trip (gpp_fma_sweep.py)
GPP_FMA_SEG_S = 0.02e-6            # a split tile's fix-up, per segment read


def matmul_fma_smem_bytes(bm: int, bk: int, G: int, w_itemsize: int) -> int:
    """G-slot W ring of (bk, 64) tiles in W's own dtype + one f32 (bm, bk)
    x tile (csrc/gpp_matmul.cuh, gpp_fma::smem_bytes)."""
    return G * bk * GPP_BLOCK_N * w_itemsize + bm * bk * 4


def fma_two_ctas(bk: int) -> bool:
    """Whether two CTAs of the FMA route fit an SM at k rows `bk` a step
    whatever the rows and W: block_m 64, f32 W, a ring of 2."""
    smem = matmul_fma_smem_bytes(GPP_MAX_BLOCK_M, bk, GPP_MM_TC_MAX_RING, 4)
    return 2 * (smem + CTA_SMEM_RESERVED) <= SM_SMEM_BYTES


def _fma_block_k(E: int, K: int, N: int) -> int:
    """block_k of the FMA route, from E, K and N alone: the one whose
    one-CTA-an-SM cut of an m-tile (E x n_tiles tiles) has the least
    modelled time, a run's steps each streaming its f32 W tile at an SM's
    share of the memory rate after a fixed wait, plus the fix-up's read of
    a split tile's segments.  Ties go to the larger block_k (fewer
    segments).  A grouped launch (E > 1) takes only the block_ks at which
    two CTAs fit an SM (`fma_two_ctas`): it is the route's one launch with
    more than 64 rows on a path (prefill's 128 rows an expert, two m-tiles
    of 132 CTAs), which runs in one wave only at two CTAs an SM, and its
    block_k may not depend on the rows."""
    tiles = E * -(-N // GPP_BLOCK_N)
    best = None
    for bk in GPP_FMA_BLOCK_KS:
        if E > 1 and not fma_two_ctas(bk):
            continue
        num_k = -(-K // bk)
        P = min(tiles * num_k, H100_SMS)
        steps = -(-tiles * num_k // P)
        segs = 1 if steps >= num_k else -(-num_k // steps) + 1
        t = steps * (bk * GPP_BLOCK_N * 4 * H100_SMS / H100_HBM_BYTES_PER_S
                     + GPP_FMA_STEP_S) + (segs > 1) * segs * GPP_FMA_SEG_S
        if best is None or t < best[0]:
            best = (t, bk)
    return best[1]


@dataclasses.dataclass(frozen=True)
class MatmulFmaPlan:
    """The FMA route (f32 x, or f32 / int8 W) of `gpp_matmul` (E = 1) and
    `gpp_matmul_grouped` (E experts), split-K over persistent CTAs.  A tile
    is one (m-tile, expert, n-tile) of block_m x block_n (64) outputs,
    numbered m-tile outermost, then the expert, the n-tile inner (`tile`,
    `expert`); a unit is one (tile, k-step), numbered tile-major with the
    k-step inner.  `grid` persistent CTAs each walk a contiguous run of
    units, `cta_units(i)`, streaming the (block_k, block_n) W tile of each
    step through one num_bufs-slot ring in `chunks` chunks.  The CTAs that
    share a tile are its segments, `segments(t)`, and a split tile's f32
    partials are summed in segment order; each CTA has two workspace slots
    of block_m x block_n, one for the tile its run starts in and one for
    the tile it ends in.  With a grid of m_tiles x P0 CTAs, CTA mt * P0 +
    j walks m-tile mt's units exactly as CTA j walks them in the
    one-m-tile plan (floor((mt P0 + j) U0 / P0) = mt U0 + floor(j U0 /
    P0)), so every m-tile meets the same k-cuts and segments."""

    M: int
    K: int
    N: int
    block_m: int
    block_n: int
    block_k: int
    num_bufs: int
    chunks: int
    ctas_per_sm: int
    grid: int
    smem_bytes: int
    E: int = 1

    @property
    def m_tiles(self) -> int:
        return -(-self.M // self.block_m)

    @property
    def n_tiles(self) -> int:
        return -(-self.N // self.block_n)

    @property
    def num_k(self) -> int:
        return -(-self.K // self.block_k)

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.E * self.n_tiles

    @property
    def units(self) -> int:
        return self.tiles * self.num_k

    def tile(self, t: int) -> "tuple[int, int]":
        """(n-tile, m-tile) of tile t (of expert `expert(t)`)."""
        mt, r = divmod(t, self.E * self.n_tiles)
        return r % self.n_tiles, mt

    def expert(self, t: int) -> int:
        """The expert of tile t."""
        return t // self.n_tiles % self.E

    def unit(self, u: int) -> "tuple[int, int]":
        """(tile, k-step) of unit u."""
        return divmod(u, self.num_k)

    def cta_units(self, i: int) -> range:
        """The units CTA i walks: [floor(i*U/P), floor((i+1)*U/P))."""
        U, P = self.units, self.grid
        return range(i * U // P, (i + 1) * U // P)

    def cta_steps(self, i: int) -> int:
        return len(self.cta_units(i))

    def owner(self, u: int) -> int:
        """The CTA whose run holds unit u (the kernel's `owner`)."""
        U, P = self.units, self.grid
        return ((u + 1) * P + U - 1) // U - 1

    def segments(self, t: int) -> range:
        """The CTAs that share tile t, in segment (= k) order."""
        u = t * self.num_k
        return range(self.owner(u), self.owner(u + self.num_k - 1) + 1)

    @functools.cached_property
    def max_segs(self) -> int:
        """The most CTAs that share one tile (1: no tile is split)."""
        return max(len(self.segments(t)) for t in range(self.tiles))

    def slot(self, i: int, t: int) -> int:
        """CTA i's workspace slot for its partial of tile t: 2 i for the
        tile its run starts in, 2 i + 1 for the one it ends in."""
        return 2 * i + (self.cta_units(i).start < t * self.num_k)

    @property
    def workspace_floats(self) -> int:
        """f32 of the partials' workspace: 0 when no tile is split."""
        if self.max_segs == 1:
            return 0
        return 2 * self.grid * self.block_m * self.block_n


def plan_matmul_fma_sm90(M: int, K: int, N: int, *, w_itemsize: int,
                         E: int = 1,
                         num_bufs: "int | None" = None,
                         block_k: "int | None" = None,
                         grid: "int | None" = None,
                         smem_budget: int = SMEM_BUDGET_BYTES
                         ) -> MatmulFmaPlan:
    """Plan for the FMA route (f32 x, or f32 / int8 W) of `gpp_matmul` (E
    = 1) and of `gpp_matmul_grouped` (E experts of M rows each).

    block_k (256, 128, 64 or 32; `_fma_block_k`) and the P0 CTAs that cut
    one m-tile's units come from E, K and N alone, never from M or W's
    dtype: P0 is at most one CTA an SM (132) for one product, two (264)
    for a grouped launch, whose block_k fits two an SM (the sweep: 264
    CTAs of half the run beat 132 at deepseek's decode, PERF.md).  block_m
    (4 row groups x a power of two rows a thread, 4-64) is the smallest
    whose m-tiles, P0 CTAs each, fit those CTAs at once, and
    the grid is m_tiles x P0: at deepseek's router (P0 = 32) decode's 4
    rows take one m-tile of 4, verify's 20 three of 8, prefill's 32 four
    of 8, so each fix-up reads 32 partials of 1-2 KB, not of 8 KB; at the
    wide projections (P0 = 132) and the experts (P0 = 264) block_m covers
    M <= 64 in one m-tile, as W is then read once, and 128 rows an expert
    take two m-tiles of 64 (W read twice: that launch is bound by its
    FMAs, not its bytes).  Every m-tile is cut alike (`MatmulFmaPlan`), so
    a row meets the same k-cuts, the same segments and the same order of
    sums at any M: decode, verify and prefill give it the same bits, and a
    bf16 W widened in the kernel gives the bits of its f32 copy.  G comes
    from `plan_stream` at the H100's f32 rate, clamped to the longest run
    and to GPP_MM_TC_MAX_RING, then shrunk until the ring fits.  A pinned
    `num_bufs` is kept and block_k shrinks until it fits; `block_k` and
    `grid` (all CTAs) pins are for tests and sweeps.  Raises when nothing
    fits."""
    if min(E, M, K, N) < 1:
        raise ValueError(f"empty matmul {E}x{M}x{K}x{N}")
    if num_bufs is not None and num_bufs < 1:
        raise ValueError("num_bufs >= 1")
    if block_k is not None and block_k not in GPP_FMA_BLOCK_KS:
        raise ValueError(f"block_k is one of {GPP_FMA_BLOCK_KS}, got "
                         f"{block_k}")
    if grid is not None and grid < 1:
        raise ValueError("grid >= 1")
    if w_itemsize not in (1, 2, 4):
        raise ValueError(f"w_itemsize is 1, 2 or 4, got {w_itemsize}")
    bn = GPP_BLOCK_N
    n_tiles = E * -(-N // bn)                  # an m-tile's tiles
    slots = H100_SMS * (2 if E > 1 else 1)     # CTAs held at once
    planned_bk = _fma_block_k(E, K, N)
    if block_k is not None:
        bks = (block_k,)
    else:       # the planned block_k, or smaller ones where a pinned ring
        bks = [bk for bk in GPP_FMA_BLOCK_KS if bk <= planned_bk]
    for bk in bks:
        per_m = n_tiles * -(-K // bk)
        P0 = min(per_m, slots)
        bm = 4
        while bm < GPP_MAX_BLOCK_M and -(-M // bm) * P0 > slots:
            bm *= 2
        m_tiles = -(-M // bm)
        units = m_tiles * per_m
        P = min(grid if grid is not None else m_tiles * P0, units)
        G = num_bufs if num_bufs is not None else min(
            _ring_depth(bk * bn * w_itemsize, 2.0 * bm * bk * bn,
                        H100_F32_FLOPS),
            -(-units // P),                # deeper than a run idles
            GPP_MM_TC_MAX_RING)
        if num_bufs is None:
            while G > 1 and matmul_fma_smem_bytes(bm, bk, G,
                                                  w_itemsize) > smem_budget:
                G -= 1
        smem = matmul_fma_smem_bytes(bm, bk, G, w_itemsize)
        if smem <= smem_budget:
            ctas = min(2, SM_SMEM_BYTES // (smem + CTA_SMEM_RESERVED))
            return MatmulFmaPlan(M, K, N, bm, bn, bk, G,
                                 max(1, min(G - 1, bk)), ctas, P, smem, E)
    raise ValueError(f"gpp_matmul FMA ring of {num_bufs} does not fit "
                     f"{smem_budget} bytes of shared memory")


PA_FMA_ROWS = 16          # query rows of a tile: 4 warps x 4 rows
PA_FMA_MAX_PIECE = 32     # keys of a piece the q.k thread layout takes
PA_FMA_PIECE = 16         # the planned piece, at most (GQA; sweep)
PA_FMA_MLA_PIECE = 8      # the same for MLA: 16 heads x 1088 wide a key
PA_FMA_MAX_SPLITS = 32    # runs a lane's pieces are cut into, at most
PA_FMA_MAX_HEAD_DIM = 256  # GQA value columns: 32 lanes x 8
PA_FMA_MAX_LATENT = 512    # MLA value columns: 32 lanes x 16


def paged_attn_fma_row_bytes(width: int, rope: int, kv_itemsize: int) -> int:
    """Shared-memory bytes of one q, key or value row of the FMA paged-
    attention kernel (csrc/paged_attention.cu; the launch checks it): the
    width (MLA: c_kv, then k_rope) with each part zero-padded to whole 16-byte
    chunks, then the row padded to 64 mod 128 bytes, so the two key
    groups one phase of a 16-byte load serves (rows t and t + 1) meet no
    bank twice."""
    ch = 16 // kv_itemsize
    kw = (round_up(width, ch) + round_up(rope, ch)) * kv_itemsize
    return round_up(max(kw - 64, 0), 128) + 64


def paged_attn_fma_smem_bytes(piece: int, width: int, rope: int,
                              kv_itemsize: int, G: int, mla: bool) -> int:
    """The FMA kernel's shared memory (fma_attn::smem_bytes): the 16-row q
    tile, the G-slot ring (a slot: the piece's key rows, MLA c_kv | k_rope; GQA
    its K rows, then its V rows) and each warp's p rows (f32, piece x
    4)."""
    rb = paged_attn_fma_row_bytes(width, rope if mla else 0, kv_itemsize)
    slot = piece * rb * (1 if mla else 2)
    return PA_FMA_ROWS * rb + G * slot + PA_FMA_ROWS * piece * 4


def _pieces_of(block_size: int, cap: int) -> "list[int]":
    """Powers of two dividing block_size, at most `cap`, largest first."""
    out, p = [], 1
    while p <= min(cap, block_size):
        if block_size % p == 0:
            out.append(p)
        p *= 2
    return out[::-1]


def paged_attn_fma_shape_error(block_size: int, width: int, rope: int,
                               kv_itemsize: int, mla: bool,
                               num_bufs: "int | None" = None,
                               smem_budget: int = SMEM_BUDGET_BYTES
                               ) -> "str | None":
    """Why the FMA paged-attention kernel cannot take this pool shape, or
    None: the value width (GQA head_dim <= 256, MLA latent <= 512) in
    multiples of 8 (the merge's float4 columns), and some piece of the
    block whose ring of num_bufs (or 1) slots fits beside the q tile."""
    cap = PA_FMA_MAX_LATENT if mla else PA_FMA_MAX_HEAD_DIM
    what = (f"{'MLA' if mla else 'GQA'} pools of {block_size}-token blocks "
            f"at {'latent' if mla else 'head_dim'} {width}"
            + (f" + rope {rope}" if mla else ""))
    if block_size < 1 or width < 8 or width > cap or width % 8 or rope < 0:
        return (f"the FMA paged-attention kernel takes value widths of 8-"
                f"{cap} in multiples of 8, not {what}")
    if not any(paged_attn_fma_smem_bytes(p, width, rope, kv_itemsize,
                                         num_bufs or 1, mla) <= smem_budget
               for p in _pieces_of(block_size, PA_FMA_MAX_PIECE)):
        return (f"no piece of {what} fits a ring of {num_bufs or 1} slots "
                f"in {smem_budget} bytes of shared memory")
    return None


@dataclasses.dataclass(frozen=True)
class PagedAttnFmaPlan:
    """The FMA paged-attention kernel (f32, and bf16 where no tensor-core
    kernel takes the shape), GQA / window or MLA: grid (kv_splits,
    row_tiles, batch x kv_heads); CTA (s, t, b * KVH + h) owns lane b's KV
    head h (MLA: the one shared head), its 16 query rows [16 t, 16 t + 16)
    of the rep x S (head-major) and the pieces of run s (`run`): a lane's
    keys [0, MB * bs) cut into pieces of `piece` tokens, the pieces cut
    into kv_splits runs (`kv_runs`).  A run's live pieces stream through a
    num_bufs-slot ring in `chunks` chunks.  With kv_splits > 1 its
    partial goes to a workspace of `workspace_floats` f32, which the merge
    kernel reads."""

    batch: int
    kv_heads: int
    rows: int
    max_blocks: int
    block_size: int
    width: int          # the value width: GQA head_dim, MLA latent
    rope: int           # MLA's rope width (0 for GQA)
    mla: bool
    piece: int
    row_tiles: int
    kv_splits: int
    num_bufs: int
    chunks: int
    row_bytes: int
    smem_bytes: int

    @property
    def pieces(self) -> int:
        return self.max_blocks * (self.block_size // self.piece)

    @property
    def grid(self) -> "tuple[int, int, int]":
        return (self.kv_splits, self.row_tiles, self.batch * self.kv_heads)

    @property
    def units(self) -> int:
        """(lane, KV head, row tile) units: the merge kernel's."""
        return self.batch * self.kv_heads * self.row_tiles

    @property
    def ctas(self) -> int:
        return self.units * self.kv_splits

    def run(self, split: int) -> range:
        """The pieces run `split` walks (piece i: tokens [i P, i P + P))."""
        return kv_runs(self.pieces, self.kv_splits)[split]

    def cta(self, lane: int, head: int, tile: int, split: int) -> int:
        """The kernel's linear CTA index (its issue-order record key)."""
        return (((lane * self.kv_heads + head) * self.row_tiles + tile)
                * self.kv_splits + split)

    def workspace_floats(self) -> int:
        if self.kv_splits == 1:
            return 0
        return self.ctas * PA_FMA_ROWS * (self.width + 2)


def fma_splits(pieces: int) -> int:
    """The runs the FMA kernel cuts a lane's pieces into: min(pieces,
    32), from the table width, the block size and the widths alone (never
    the batch, S or the positions), so a row meets the same runs, and
    rounds the same bits, at decode, verify and prefill."""
    return max(1, min(pieces, PA_FMA_MAX_SPLITS))


def plan_paged_attn_fma_sm90(*, batch: int, kv_heads: int, rows: int,
                             block_size: int, max_blocks: int, width: int,
                             kv_itemsize: int, mla: bool = False,
                             rope: int = 0,
                             num_bufs: "int | None" = None,
                             kv_splits: "int | None" = None,
                             piece: "int | None" = None,
                             smem_budget: int = SMEM_BUDGET_BYTES
                             ) -> PagedAttnFmaPlan:
    """Plan for the FMA paged-attention kernel (csrc/paged_attention.cu).

    rows = rep x S query rows a (lane, KV head) (MLA: 16 heads x S), cut
    into 16-row tiles.  The piece P is the largest power of two dividing
    block_size that is at most 16 (GQA) or 8 (MLA: a lane is one unit of
    16 heads on 576 + 512 columns, so it wants more, shorter runs;
    `scripts/fma_attn_sweep.py`; a pinned piece may be up to 32)
    and whose ring of num_bufs (or 1) slots fits beside the q tile, so a
    block larger than the shared memory holds streams piece by piece and
    a live block's dead tokens past P are not copied.  The pieces are cut
    into `fma_splits` runs; neither P nor the cut reads the batch, S or
    the positions.  The ring depth comes from `plan_stream` at the H100's
    f32 rate (a piece's bytes against its flash step over 16 rows),
    clamped to the longest run and to what fits.  Pins (num_bufs,
    kv_splits, piece) are kept or raise; raises, naming the shape, where
    the kernel cannot take it."""
    if min(batch, kv_heads, rows, max_blocks) < 1:
        raise ValueError(f"empty paged attention: batch {batch}, kv_heads "
                         f"{kv_heads}, rows {rows}, max_blocks {max_blocks}")
    if mla and kv_heads != 1:
        raise ValueError("MLA has one shared KV head")
    if num_bufs is not None and num_bufs < 1:
        raise ValueError("num_bufs >= 1")
    err = paged_attn_fma_shape_error(block_size, width, rope, kv_itemsize,
                                     mla, num_bufs, smem_budget)
    if err is not None:
        raise ValueError(err)
    rope = rope if mla else 0

    def smem_of(p, g):
        return paged_attn_fma_smem_bytes(p, width, rope, kv_itemsize, g, mla)

    if piece is not None:
        if piece not in _pieces_of(block_size, PA_FMA_MAX_PIECE):
            raise ValueError(f"piece {piece} is not a power of two <= "
                             f"{PA_FMA_MAX_PIECE} dividing block size "
                             f"{block_size}")
        cands = [piece]
    else:
        cands = _pieces_of(block_size,
                           PA_FMA_MLA_PIECE if mla else PA_FMA_PIECE)
    P = next((p for p in cands if smem_of(p, num_bufs or 1) <= smem_budget),
             None)
    if P is None:
        raise ValueError(f"a piece of {piece} tokens with a ring of "
                         f"{num_bufs or 1} slots does not fit {smem_budget} "
                         f"bytes of shared memory")
    pieces = max_blocks * (block_size // P)
    ks = kv_splits if kv_splits is not None else fma_splits(pieces)
    longest = max(len(r) for r in kv_runs(pieces, ks))
    dk = width + rope
    data = P * (dk if mla else 2 * width) * kv_itemsize
    G = num_bufs if num_bufs is not None else min(
        _ring_depth(data, 2.0 * PA_FMA_ROWS * P * (dk + width),
                    H100_F32_FLOPS), max(1, longest))
    while num_bufs is None and G > 1 and smem_of(P, G) > smem_budget:
        G -= 1
    return PagedAttnFmaPlan(
        batch, kv_heads, rows, max_blocks, block_size, width, rope, mla, P,
        -(-rows // PA_FMA_ROWS), ks, G, max(1, min(G - 1, P)),
        paged_attn_fma_row_bytes(width, rope, kv_itemsize), smem_of(P, G))


PA_MLA_TC_ROWS = 16          # query rows of a tile: one mma m16 tile
PA_MLA_TC_WARPS = 4          # 512 latent columns: 128 a warp
PA_MLA_TC_MAX_LATENT = 512
PA_MLA_TC_MAX_BLOCK = 64
PA_MLA_TC_MAX_CTAS_PER_SM = 4
PA_MLA_TC_CTAS_PER_SM = 2    # the split aims for two CTAs an SM (sweep)


def kv_runs(max_blocks: int, kv_splits: int) -> "list[range]":
    """The runs of logical blocks (or, in the FMA kernel, pieces) the
    split-KV kernels' CTAs walk: run s is [s * MB // ks, (s + 1) * MB //
    ks), so runs differ by at most one and together cover [0, MB) once."""
    if not 1 <= kv_splits <= max_blocks:
        raise ValueError(f"kv_splits {kv_splits} not in [1, {max_blocks}]")
    return [range(s * max_blocks // kv_splits,
                  (s + 1) * max_blocks // kv_splits)
            for s in range(kv_splits)]


def mla_tc_row_bytes(latent: int, rope: int) -> int:
    """Shared-memory bytes of one key (or q) row of the tensor-core MLA
    kernel: the latent zero-padded to a multiple of 128 columns, then the
    rope part to one of 64, in bf16 — a whole number of 128-byte swizzle
    groups (1152 bytes at 512 + 64, no padding)."""
    return (round_up(latent, 128) + round_up(rope, 64)) * 2


def mla_tc_smem_bytes(block_size: int, latent: int, rope: int, G: int,
                      warps: int) -> int:
    """The q tile, the G-slot ring of key rows and the warps' partial
    logits (f32, 16 x block_size each) (csrc/paged_attention.cu,
    mla_tc::smem_bytes)."""
    rb = mla_tc_row_bytes(latent, rope)
    return (PA_MLA_TC_ROWS * rb + G * block_size * rb
            + warps * PA_MLA_TC_ROWS * block_size * 4)


def mla_tc_takes(block_size: int, latent: int, rope: int) -> bool:
    """Whether the tensor-core MLA kernel takes this pool shape: blocks of
    16, 32, 48 or 64 tokens (whole m16 / n8 tiles, at most 64 keys a ring
    slot), latent and rope widths in multiples of 8 (16-byte copies),
    latent <= 512 (four warps of 128 columns)."""
    return (block_size % 16 == 0 and 16 <= block_size <= PA_MLA_TC_MAX_BLOCK
            and latent % 8 == 0 and rope % 8 == 0 and rope >= 0
            and 8 <= latent <= PA_MLA_TC_MAX_LATENT)


@dataclasses.dataclass(frozen=True)
class MlaTcPlan:
    """The tensor-core MLA paged-attention kernel (bf16): grid (kv_splits,
    row_tiles, batch); CTA (s, t, b) owns lane b's 16 query rows
    [16 t, 16 t + 16) and the logical blocks of run s (`run`), whose live
    blocks stream through a num_bufs-slot ring in `chunks` chunks.  With
    kv_splits > 1 its partial goes to a workspace of `workspace_floats`
    f32, which the merge kernel reads."""

    batch: int
    rows: int
    max_blocks: int
    block_size: int
    row_tiles: int
    kv_splits: int
    num_bufs: int
    chunks: int
    warps: int
    ctas_per_sm: int
    smem_bytes: int

    @property
    def grid(self) -> "tuple[int, int, int]":
        return (self.kv_splits, self.row_tiles, self.batch)

    @property
    def ctas(self) -> int:
        return self.kv_splits * self.row_tiles * self.batch

    def run(self, split: int) -> range:
        return kv_runs(self.max_blocks, self.kv_splits)[split]

    def cta(self, lane: int, tile: int, split: int) -> int:
        """The kernel's linear CTA index (its issue-order record key)."""
        return (lane * self.row_tiles + tile) * self.kv_splits + split

    def workspace_floats(self, latent: int) -> int:
        if self.kv_splits == 1:
            return 0
        return (self.batch * self.row_tiles * self.kv_splits
                * PA_MLA_TC_ROWS * (latent + 2))


def plan_paged_attn_mla_tc_sm90(*, batch: int, rows: int, block_size: int,
                                max_blocks: int, latent: int, rope: int,
                                num_bufs: "int | None" = None,
                                kv_splits: "int | None" = None,
                                warps: int = PA_MLA_TC_WARPS,
                                smem_budget: int = SMEM_BUDGET_BYTES
                                ) -> MlaTcPlan:
    """Plan for the tensor-core MLA kernel (csrc/paged_attention.cu).

    rows = heads x queries a lane (16 S), cut into 16-row tiles.  With
    units = batch x row tiles, kv_splits = min(MB, ceil(2 * 132 / units))
    runs a unit give two CTAs an SM where the blocks allow: on deepseek's
    path (MB = 8) every phase splits into 8 runs of one block (32 / 256 /
    160 CTAs at decode / prefill / verify), which the sweep found fastest
    or within 5% of it (PERF.md).  The ring depth comes from `plan_stream`
    (deep: a block is 18 KB of bytes against a few hundred FLOPs) clamped
    to the longest run, so a run's blocks are all in flight from its first
    step; then it shrinks so that ceil(CTAs / 132) CTAs (at most 4) share
    an SM's shared memory.  A pinned num_bufs or kv_splits is kept (the
    CTAs an SM then give way); raises when it cannot fit."""
    if min(batch, rows, max_blocks) < 1:
        raise ValueError(f"empty MLA attention: batch {batch}, rows {rows}, "
                         f"max_blocks {max_blocks}")
    if not mla_tc_takes(block_size, latent, rope):
        raise ValueError(f"the tensor-core MLA kernel takes block sizes of "
                         f"16, 32, 48 or 64 tokens and latent / rope widths "
                         f"that are multiples of 8 (latent <= "
                         f"{PA_MLA_TC_MAX_LATENT}), got block size "
                         f"{block_size}, latent {latent}, rope {rope}")
    if warps not in (4, 8):
        raise ValueError("warps is 4 or 8")
    if num_bufs is not None and num_bufs < 1:
        raise ValueError("num_bufs >= 1")
    row_tiles = -(-rows // PA_MLA_TC_ROWS)
    units = batch * row_tiles
    ks = kv_splits if kv_splits is not None else \
        min(max_blocks,
            max(1, -(-PA_MLA_TC_CTAS_PER_SM * H100_SMS // units)))
    longest = max(len(r) for r in kv_runs(max_blocks, ks))
    ctas = units * ks
    rb = mla_tc_row_bytes(latent, rope)
    G = num_bufs if num_bufs is not None else _ring_depth(
        block_size * rb,
        2.0 * PA_MLA_TC_ROWS * block_size * (latent + rope + latent),
        H100_BF16_FLOPS)
    G = min(G, max(1, longest))        # deeper than the run idles

    def smem_of(g):
        return mla_tc_smem_bytes(block_size, latent, rope, g, warps)

    per_sm = min(PA_MLA_TC_MAX_CTAS_PER_SM, -(-ctas // H100_SMS))
    if num_bufs is None:
        while G > 1 and smem_of(G) > smem_budget // per_sm:
            G -= 1
    smem = smem_of(G)
    per_sm = min(per_sm, smem_budget // smem)
    if per_sm < 1:
        raise ValueError(f"tensor-core MLA ring of {G} needs {smem} bytes of "
                         f"shared memory (budget {smem_budget})")
    return MlaTcPlan(batch, rows, max_blocks, block_size, row_tiles, ks, G,
                     max(1, min(G - 1, block_size)), warps, per_sm, smem)


PA_GQA_TC_ROWS = 16           # query rows of a tile: one mma m16 tile
PA_GQA_TC_WARPS = 4           # q.k k-steps and p.v columns split over them
PA_GQA_TC_HEAD_DIMS = (64, 128, 256)
PA_GQA_TC_MAX_BLOCK = 64
PA_GQA_TC_MAX_SPLITS = 8      # runs a lane's blocks are cut into, at most
PA_GQA_TC_MAX_CTAS_PER_SM = 4


def gqa_tc_takes(block_size: int, head_dim: int) -> bool:
    """Whether the tensor-core GQA / window kernel takes this pool shape:
    head_dim 64, 128 or 256 (whole k16 steps over four warps, rows of whole
    128-byte swizzle groups) and blocks of 16, 32, 48 or 64 tokens (whole
    m16 / n8 tiles, at most 64 keys a ring slot)."""
    return (head_dim in PA_GQA_TC_HEAD_DIMS and block_size % 16 == 0
            and 16 <= block_size <= PA_GQA_TC_MAX_BLOCK)


def gqa_tc_splits(max_blocks: int) -> int:
    """The runs the tensor-core GQA kernel cuts a lane's logical blocks
    into (`kv_runs`): min(MB, 8), from the table width alone, so a row
    meets the same runs, and rounds the same bits, at decode, verify and
    prefill whatever the batch (one block a run at qwen's MB = 8)."""
    return max(1, min(max_blocks, PA_GQA_TC_MAX_SPLITS))


def gqa_tc_smem_bytes(block_size: int, head_dim: int, G: int) -> int:
    """The q tile, the G-slot ring (a slot: the block's K rows, then its V
    rows, head_dim bf16 each) and the warps' partial logits (f32, 16 x
    block_size each) (csrc/paged_attention.cu, gqa_tc::smem_bytes)."""
    rb = head_dim * 2
    return (PA_GQA_TC_ROWS * rb + G * 2 * block_size * rb
            + PA_GQA_TC_WARPS * PA_GQA_TC_ROWS * block_size * 4)


@dataclasses.dataclass(frozen=True)
class GqaTcPlan:
    """The tensor-core GQA / window paged-attention kernel (bf16): grid
    (kv_splits, row_tiles, batch x kv_heads); CTA (s, t, b * KVH + h) owns
    lane b's KV head h, its 16 query rows [16 t, 16 t + 16) of the rep x S
    (head-major) and the logical blocks of run s (`run`), whose live
    blocks stream through a num_bufs-slot ring in `chunks` chunks.  With
    kv_splits > 1 its partial goes to a workspace of `workspace_floats`
    f32, which the merge kernel reads."""

    batch: int
    kv_heads: int
    rows: int
    max_blocks: int
    block_size: int
    head_dim: int
    row_tiles: int
    kv_splits: int
    num_bufs: int
    chunks: int
    ctas_per_sm: int
    smem_bytes: int

    @property
    def grid(self) -> "tuple[int, int, int]":
        return (self.kv_splits, self.row_tiles, self.batch * self.kv_heads)

    @property
    def units(self) -> int:
        """(lane, KV head, row tile) units: the merge kernel's."""
        return self.batch * self.kv_heads * self.row_tiles

    @property
    def ctas(self) -> int:
        return self.units * self.kv_splits

    def run(self, split: int) -> range:
        return kv_runs(self.max_blocks, self.kv_splits)[split]

    def cta(self, lane: int, head: int, tile: int, split: int) -> int:
        """The kernel's linear CTA index (its issue-order record key)."""
        return (((lane * self.kv_heads + head) * self.row_tiles + tile)
                * self.kv_splits + split)

    def workspace_floats(self) -> int:
        if self.kv_splits == 1:
            return 0
        return self.ctas * PA_GQA_TC_ROWS * (self.head_dim + 2)


def plan_paged_attn_gqa_tc_sm90(*, batch: int, kv_heads: int, rows: int,
                                block_size: int, max_blocks: int,
                                head_dim: int,
                                num_bufs: "int | None" = None,
                                kv_splits: "int | None" = None,
                                smem_budget: int = SMEM_BUDGET_BYTES
                                ) -> GqaTcPlan:
    """Plan for the tensor-core GQA / window kernel (csrc/paged_attention.cu).

    rows = rep x S query rows a (lane, KV head), cut into 16-row tiles.
    The runs are `gqa_tc_splits(max_blocks)`: unlike the MLA planner's
    (which grows its split with fewer units), the cut reads neither the
    batch nor S, so a row's partials, and the bits of its output, are the
    same at decode and verify.  The ring depth comes from `plan_stream`
    (a block's K and V against its flash step) clamped to the longest run,
    then shrinks so that ceil(CTAs / 132) CTAs (at most 4) share an SM's
    shared memory; the depth changes no arithmetic.  A pinned num_bufs or
    kv_splits is kept (the CTAs an SM then give way); raises when it
    cannot fit or the kernel does not take the shape."""
    if min(batch, kv_heads, rows, max_blocks) < 1:
        raise ValueError(f"empty GQA attention: batch {batch}, kv_heads "
                         f"{kv_heads}, rows {rows}, max_blocks {max_blocks}")
    if not gqa_tc_takes(block_size, head_dim):
        raise ValueError(f"the tensor-core GQA kernel takes head_dim "
                         f"{PA_GQA_TC_HEAD_DIMS} and blocks of 16, 32, 48 or "
                         f"64 tokens, got head_dim {head_dim}, block size "
                         f"{block_size}")
    if num_bufs is not None and num_bufs < 1:
        raise ValueError("num_bufs >= 1")
    row_tiles = -(-rows // PA_GQA_TC_ROWS)
    ks = kv_splits if kv_splits is not None else gqa_tc_splits(max_blocks)
    longest = max(len(r) for r in kv_runs(max_blocks, ks))
    ctas = batch * kv_heads * row_tiles * ks
    G = num_bufs if num_bufs is not None else _ring_depth(
        block_size * head_dim * 2 * 2,
        2.0 * PA_GQA_TC_ROWS * block_size * head_dim * 2, H100_BF16_FLOPS)
    G = min(G, max(1, longest))        # deeper than the run idles

    def smem_of(g):
        return gqa_tc_smem_bytes(block_size, head_dim, g)

    per_sm = min(PA_GQA_TC_MAX_CTAS_PER_SM, -(-ctas // H100_SMS))
    if num_bufs is None:
        while G > 1 and smem_of(G) > smem_budget // per_sm:
            G -= 1
    smem = smem_of(G)
    per_sm = min(per_sm, smem_budget // smem)
    if per_sm < 1:
        raise ValueError(f"tensor-core GQA ring of {G} needs {smem} bytes of "
                         f"shared memory (budget {smem_budget})")
    return GqaTcPlan(batch, kv_heads, rows, max_blocks, block_size, head_dim,
                     row_tiles, ks, G, max(1, min(G - 1, block_size)), per_sm,
                     smem)
