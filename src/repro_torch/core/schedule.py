"""GPP planners: the reference's stream/serve planners plus sm_90 ring plans.

`round_up`, `plan_stream`, `plan_serve_chunk`, `plan_verify_budget` and
`tokens_per_step_cov` are copies of `repro.core.schedule`.  The TPU tile
planners (v5e rates, ~100 MiB VMEM budget, (8, 128) tiling) do not carry
over; in their place `plan_matmul_sm90` (the FMA route of `gpp_matmul`),
`plan_matmul_tc_sm90` (its tensor-core route), `plan_grouped_sm90` and
`plan_grouped_tc_sm90` (the grouped kernel's two routes),
`plan_paged_attn_sm90` and `plan_paged_attn_mla_tc_sm90` pick the tile
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

# NVIDIA H100 SXM data sheet (dense, 700 W)
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
H100_SMS = 132
SMEM_BUDGET_BYTES = 232_448          # 227 KB dynamic shared memory per block
MAX_RING = 8


def round_up(x: int, mult: int) -> int:
    """Smallest multiple of `mult` >= x (tile, block, and chunk sizing)."""
    return ((x + mult - 1) // mult) * mult


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
# sm_90 plans for the CUDA kernels
# ---------------------------------------------------------------------------

GPP_BLOCK_N = 64         # output columns per CTA (one per thread column)
GPP_BLOCK_K = 256        # weight-tile rows per k-step: each step's wait
                         # covers one memory round trip, so fewer, larger
                         # steps stream W faster at small M
GPP_MAX_BLOCK_M = 64     # rows per CTA: 4 row groups x <= 16 rows/thread


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """Tiles and ring of one `gpp_matmul` launch.  Each CTA owns one
    (block_m, block_n) output tile and walks its num_k k-steps; the W tiles
    of those steps stream through a num_bufs-slot ring in `chunks` chunks."""

    block_m: int
    block_n: int
    block_k: int
    num_bufs: int
    chunks: int
    smem_bytes: int

    def grid(self, M: int, N: int, K: int) -> "tuple[int, int, int]":
        return (-(-M // self.block_m), -(-N // self.block_n),
                -(-K // self.block_k))


def gpp_smem_bytes(bm: int, bn: int, bk: int, G: int, w_itemsize: int) -> int:
    """W ring (raw weight dtype) + one f32 x tile."""
    return G * bk * bn * w_itemsize + bm * bk * 4


def _ring_depth(block_bytes: float, flops: float, flops_per_s: float) -> int:
    return plan_stream(block_bytes=block_bytes, compute_flops=flops,
                       flops_per_s=flops_per_s,
                       transfer_bytes_per_s=H100_HBM_BYTES_PER_S).ring_depth


def plan_matmul_sm90(M: int, K: int, N: int, *, w_itemsize: int,
                     num_bufs: "int | None" = None,
                     smem_budget: int = SMEM_BUDGET_BYTES,
                     runs: int = 1) -> MatmulPlan:
    """Tiles + ring depth for `gpp_matmul` on an H100 (module docstring).

    A planned ring shrinks to fit the shared-memory budget, down to
    ping-pong; a pinned `num_bufs` is kept and the tile's k rows halve
    instead.  Raises when even 16 rows a step do not fit.  `runs` is the
    number of k-walks one CTA makes back to back on one ring (experts per
    CTA in the grouped kernel), which bounds how deep a ring can fill."""
    if min(M, K, N) < 1:
        raise ValueError(f"empty matmul {M}x{K}x{N}")
    if num_bufs is not None and num_bufs < 1:
        raise ValueError("num_bufs >= 1")
    # block_m = 4 row groups x a power-of-two rows per thread (the kernel's
    # compile-time count), the smallest that covers M, at most 64
    bm = 4
    while bm < min(M, GPP_MAX_BLOCK_M):
        bm *= 2
    bn = GPP_BLOCK_N
    bk = min(GPP_BLOCK_K, K)
    while True:
        num_k = -(-K // bk)
        G = num_bufs if num_bufs is not None else _ring_depth(
            bk * bn * w_itemsize, 2.0 * bm * bk * bn, H100_BF16_FLOPS)
        G = min(G, max(1, runs * num_k))   # deeper than the steps idles
        if num_bufs is None:
            while G > 2 and gpp_smem_bytes(bm, bn, bk, G,
                                           w_itemsize) > smem_budget:
                G -= 1
        smem = gpp_smem_bytes(bm, bn, bk, G, w_itemsize)
        if smem <= smem_budget:
            return MatmulPlan(bm, bn, bk, G, max(1, min(G - 1, bk)), smem)
        if bk <= 16:
            raise ValueError(f"gpp_matmul ring of {G} needs {smem} bytes of "
                             f"shared memory (budget {smem_budget})")
        bk //= 2


@dataclasses.dataclass(frozen=True)
class GroupedPlan:
    """`gpp_matmul_grouped`: each CTA owns one (block_m, block_n) tile
    position for `experts_per_cta` consecutive experts and walks their
    k-steps expert-major on one ring, so expert e+1's first W tiles stream
    while expert e's last ones compute (the reference's expert-outermost
    global step order)."""

    tile: MatmulPlan
    experts_per_cta: int

    def grid(self, E: int, M: int, N: int) -> "tuple[int, int, int]":
        """CUDA grid (n tiles, m tiles, expert runs)."""
        return (-(-N // self.tile.block_n), -(-M // self.tile.block_m),
                -(-E // self.experts_per_cta))


def plan_grouped_sm90(E: int, M: int, K: int, N: int, *, w_itemsize: int,
                      num_bufs: "int | None" = None,
                      smem_budget: int = SMEM_BUDGET_BYTES) -> GroupedPlan:
    """Plan for `gpp_matmul_grouped`: the flat kernel's tiles per expert,
    and experts per CTA so that the grid keeps about two CTAs per SM (more
    experts a CTA means fewer ring fills, fewer means more CTAs)."""
    if E < 1:
        raise ValueError("E >= 1")
    bm = plan_matmul_sm90(M, K, N, w_itemsize=w_itemsize,
                          num_bufs=num_bufs, smem_budget=smem_budget).block_m
    per_expert = -(-M // bm) * -(-N // GPP_BLOCK_N)
    epc = max(1, min(E, per_expert * E // (2 * H100_SMS)))
    tile = plan_matmul_sm90(M, K, N, w_itemsize=w_itemsize,
                            num_bufs=num_bufs, smem_budget=smem_budget,
                            runs=epc)
    return GroupedPlan(tile, epc)


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
    CTA walks, as `plan_matmul_sm90` does) and the tile or the CTAs an SM
    give way."""
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


GPP_MM_TC_BLOCK_KS = (256, 128)   # gpp_matmul tensor-core k rows a step,
                                   # largest (planned) first; 128 only
                                   # where a pinned ring needs it
GPP_MM_TC_MAX_RING = 2           # planned rings deeper than ping-pong ran
                                 # slower on the card (PERF.md)
SM_SMEM_BYTES = 233_472          # an SM's shared memory for its CTAs
CTA_SMEM_RESERVED = 1_024        # the system's share of it, per CTA


@dataclasses.dataclass(frozen=True)
class MatmulTcPlan:
    """`gpp_matmul`'s tensor-core route (bf16 x and W), stream-K.  A tile is
    one (n-tile, m-tile) of block_m x block_n outputs, numbered n-major with
    the m-tile innermost; a unit is one (tile, k-step), numbered tile-major
    with the k-step inner.  `grid` persistent CTAs each walk a contiguous
    run of units, `cta_units(i)`, streaming the (block_k, block_n) W tile
    of each step through one num_bufs-slot ring in `chunks` chunks, the x
    tile beside it in two slots.  The CTAs that share a tile are its
    segments, `segments(t)`; a split tile's f32 partials go to workspace
    slot (tile, segment), `max_segs` slots a tile."""

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
        return self.m_tiles * self.n_tiles

    @property
    def units(self) -> int:
        return self.tiles * self.num_k

    def tile(self, t: int) -> "tuple[int, int]":
        """(n-tile, m-tile) of tile t."""
        return divmod(t, self.m_tiles)

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
        """Workspace slots a tile: the most CTAs that share one."""
        return max(len(self.segments(t)) for t in range(self.tiles))

    @property
    def workspace_floats(self) -> int:
        """f32 of the partials' workspace: 0 when no tile is split."""
        segs = self.max_segs
        if segs == 1:
            return 0
        return self.tiles * segs * self.block_m * self.block_n


def matmul_tc_smem_bytes(bm: int, bk: int, G: int) -> int:
    """G-slot bf16 W ring of (bk, 128) tiles + two bf16 (bm, bk) x slots;
    rows swizzled, not padded (csrc/gpp_matmul.cu, smem_bytes)."""
    return G * bk * GPP_TC_BLOCK_N * 2 + 2 * bm * bk * 2


def plan_matmul_tc_sm90(M: int, K: int, N: int, *,
                        num_bufs: "int | None" = None,
                        block_k: "int | None" = None,
                        grid: "int | None" = None,
                        smem_budget: int = SMEM_BUDGET_BYTES) -> MatmulTcPlan:
    """Plan for the tensor-core route of `gpp_matmul` (stream-K).

    block_m is the smallest of 16, 32, 64, 128 that covers M (M rounded up
    to 16 at every path shape, so each W tile streams once a launch);
    block_n 128; block_k 256; grid = min(units, 132): one CTA an SM, each
    with a run of whole 64 KB W tiles.  The sweep (scripts/gpp_tc_sweep.py,
    PERF.md) found this within 3% of the best tile and grid summed over the
    paths' decode and prefill shapes: at these few-MB weights a launch is a
    handful of round trips, and fewer, larger steps and fewer segments a
    tile (each a partial the fix-up reads) beat two CTAs an SM of 16 KB
    steps.  G comes from `plan_stream` at H100 rates (deep: at 16 rows a
    tile's bytes take ~18x its FLOPs' time), clamped to the longest run and
    to GPP_MM_TC_MAX_RING (the same sweep: G = 3 and 4 slower than 2 at
    every run length, up to 47%), then shrunk until the ring fits the
    shared memory, down to in-situ.  A
    pinned `num_bufs` is kept and block_k halves until it fits; `block_k`
    and `grid` pins are for tests and sweeps.  `ctas_per_sm` is what the
    shared memory lets an SM hold (at most 2: 256 threads of <= 128
    registers).  Raises when nothing fits."""
    if min(M, K, N) < 1:
        raise ValueError(f"empty matmul {M}x{K}x{N}")
    if num_bufs is not None and num_bufs < 1:
        raise ValueError("num_bufs >= 1")
    if block_k is not None and block_k not in GPP_MM_TC_BLOCK_KS:
        raise ValueError(f"block_k is one of {GPP_MM_TC_BLOCK_KS}, got "
                         f"{block_k}")
    if grid is not None and grid < 1:
        raise ValueError("grid >= 1")
    bm = 16
    while bm < min(M, GPP_TC_MAX_BLOCK_M):
        bm *= 2
    bn = GPP_TC_BLOCK_N
    tiles = -(-M // bm) * -(-N // bn)
    bks = (block_k,) if block_k is not None else GPP_MM_TC_BLOCK_KS
    for bk in bks:
        units = tiles * -(-K // bk)
        P = min(units, grid if grid is not None else H100_SMS)
        G = num_bufs if num_bufs is not None else min(
            _ring_depth(bk * bn * 2, 2.0 * bm * bk * bn, H100_BF16_FLOPS),
            -(-units // P),                # deeper than a run idles
            GPP_MM_TC_MAX_RING)
        if num_bufs is None:
            while G > 1 and matmul_tc_smem_bytes(bm, bk, G) > smem_budget:
                G -= 1
        smem = matmul_tc_smem_bytes(bm, bk, G)
        if smem <= smem_budget:
            ctas = min(2, SM_SMEM_BYTES // (smem + CTA_SMEM_RESERVED))
            return MatmulTcPlan(M, K, N, bm, bn, bk, G,
                                max(1, min(G - 1, bk)), ctas, P, smem)
    raise ValueError(f"gpp_matmul tensor-core ring of {num_bufs} does not "
                     f"fit {smem_budget} bytes of shared memory")


PA_ROWS_PER_CTA = 32     # query rows (rep * S) one CTA holds
PA_MLA_ROWS_PER_CTA = 16  # MLA: one query's 16 heads (f32 q, acc 576/512 wide)
PA_MAX_HEAD_DIM = 256


@dataclasses.dataclass(frozen=True)
class PagedAttnPlan:
    """Ring of one paged-attention launch: grid (B, KVH, row_splits), each
    CTA holding `rows_per_cta` query rows and walking its lane's logical
    blocks through two num_bufs-slot rings (K and V) in `chunks` chunks."""

    rows_per_cta: int
    row_splits: int
    num_bufs: int
    chunks: int
    smem_bytes: int


def paged_attn_row_bytes(head_dim: int, kv_itemsize: int) -> int:
    """Shared-memory bytes of one K/V row: 16-byte aligned plus 16 bytes of
    padding so neighbouring rows fall in different banks."""
    return round_up(head_dim * kv_itemsize, 16) + 16


def paged_attn_smem_bytes(G: int, bs: int, head_dim: int, kv_itemsize: int,
                          rows: int, rope_dim: int = 0) -> int:
    """Two rings + f32 q (rows x dk), acc (rows x dv), p (rows x bs),
    m/l/corr.  GQA (rope_dim 0): K and V rings of head_dim, dk = dv =
    head_dim.  MLA: a c_kv ring of head_dim (the latent width, which is
    also the value) and a k_rope ring of rope_dim; dk = head_dim +
    rope_dim, dv = head_dim."""
    db = rope_dim or head_dim
    dk, dv = (head_dim + rope_dim, head_dim) if rope_dim else \
        (head_dim, head_dim)
    ring = G * bs * (paged_attn_row_bytes(head_dim, kv_itemsize)
                     + paged_attn_row_bytes(db, kv_itemsize))
    return ring + rows * (dk + dv) * 4 + rows * bs * 4 + 3 * rows * 4


def plan_paged_attn_sm90(*, rows: int, block_size: int, head_dim: int,
                         kv_itemsize: int, max_blocks: int,
                         num_bufs: "int | None" = None, rope_dim: int = 0,
                         smem_budget: int = SMEM_BUDGET_BYTES) -> PagedAttnPlan:
    """Ring depth for the paged-attention kernel: one KV block (both
    rings' rows) is the streamed tile, the flash step over the CTA's query
    rows is the compute.  rope_dim > 0 plans the MLA form (head_dim is then
    the latent width): 16 query rows a CTA, since its f32 q and acc rows
    are 576 and 512 wide."""
    if not rope_dim and head_dim > PA_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {head_dim} > {PA_MAX_HEAD_DIM}")
    rt = min(rows, PA_MLA_ROWS_PER_CTA if rope_dim else PA_ROWS_PER_CTA)
    splits = -(-rows // rt)
    dk = head_dim + rope_dim
    dv = head_dim
    G = num_bufs if num_bufs is not None else _ring_depth(
        block_size * (head_dim + (rope_dim or head_dim)) * kv_itemsize,
        2.0 * rt * block_size * (dk + dv), H100_BF16_FLOPS)
    if G < 1:
        raise ValueError("num_bufs >= 1")
    G = min(G, max(1, max_blocks))

    def smem_of(g):
        return paged_attn_smem_bytes(g, block_size, head_dim, kv_itemsize,
                                     rt, rope_dim)

    while G > 1 and smem_of(G) > smem_budget:
        if num_bufs is not None:
            raise ValueError(f"ring of {num_bufs} exceeds the shared-memory "
                             f"budget of {smem_budget} bytes")
        G -= 1
    smem = smem_of(G)
    if smem > smem_budget:
        raise ValueError(f"paged attention at block size {block_size} needs "
                         f"{smem} bytes of shared memory (budget "
                         f"{smem_budget})")
    return PagedAttnPlan(rt, splits, G, max(1, min(G - 1, block_size)), smem)


PA_MLA_TC_ROWS = 16          # query rows of a tile: one mma m16 tile
PA_MLA_TC_WARPS = 4          # 512 latent columns: 128 a warp
PA_MLA_TC_MAX_LATENT = 512
PA_MLA_TC_MAX_BLOCK = 64
PA_MLA_TC_MAX_CTAS_PER_SM = 4
PA_MLA_TC_CTAS_PER_SM = 2    # the split aims for two CTAs an SM (sweep)


def kv_runs(max_blocks: int, kv_splits: int) -> "list[range]":
    """The runs of logical blocks the split-KV MLA kernel's CTAs walk:
    run s is [s * MB // ks, (s + 1) * MB // ks), so runs differ by at most
    one block and together cover [0, MB) once."""
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


def mla_fma_takes(block_size: int, latent: int, rope: int,
                  kv_itemsize: int) -> bool:
    """Whether the FMA MLA kernel's in-situ ring fits the shared memory
    with a full tile of query rows: 229,568 of 232,448 bytes at deepseek's
    512 + 64 in bf16 at block size 128; block size 256 does not fit."""
    return paged_attn_smem_bytes(1, block_size, latent, kv_itemsize,
                                 PA_MLA_ROWS_PER_CTA, rope) <= SMEM_BUDGET_BYTES


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
