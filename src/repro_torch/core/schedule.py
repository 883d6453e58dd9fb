"""GPP planners: the reference's stream/serve planners plus sm_90 ring plans.

`round_up`, `plan_stream`, `plan_serve_chunk`, `plan_verify_budget` and
`tokens_per_step_cov` are copies of `repro.core.schedule`.  The TPU tile
planners (v5e rates, ~100 MiB VMEM budget, (8, 128) tiling) do not carry
over; in their place `plan_matmul_sm90` and `plan_paged_attn_sm90` pick the
tile sizes and the shared-memory ring depth G of the two CUDA kernels:

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
import math
import statistics

# NVIDIA H100 SXM data sheet (dense, 700 W)
H100_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
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
                     smem_budget: int = SMEM_BUDGET_BYTES) -> MatmulPlan:
    """Tiles + ring depth for `gpp_matmul` on an H100 (module docstring).

    A planned ring shrinks to fit the shared-memory budget, down to
    ping-pong; a pinned `num_bufs` is kept and the tile's k rows halve
    instead.  Raises when even 16 rows a step do not fit."""
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
        G = min(G, max(1, num_k))   # a ring deeper than the step count idles
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


PA_ROWS_PER_CTA = 32     # query rows (rep * S) one CTA holds
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
                          rows: int) -> int:
    """K and V rings + f32 q, acc (rows x hd), p (rows x bs), m/l/corr."""
    ring = 2 * G * bs * paged_attn_row_bytes(head_dim, kv_itemsize)
    return ring + rows * head_dim * 4 * 2 + rows * bs * 4 + 3 * rows * 4


def plan_paged_attn_sm90(*, rows: int, block_size: int, head_dim: int,
                         kv_itemsize: int, max_blocks: int,
                         num_bufs: "int | None" = None,
                         smem_budget: int = SMEM_BUDGET_BYTES) -> PagedAttnPlan:
    """Ring depth for the paged-attention kernel: one KV block (K + V rows
    of one head) is the streamed tile, the flash step over the CTA's query
    rows is the compute."""
    if head_dim > PA_MAX_HEAD_DIM:
        raise ValueError(f"head_dim {head_dim} > {PA_MAX_HEAD_DIM}")
    rt = min(rows, PA_ROWS_PER_CTA)
    splits = -(-rows // rt)
    G = num_bufs if num_bufs is not None else _ring_depth(
        2 * block_size * head_dim * kv_itemsize,
        2.0 * rt * block_size * 2 * head_dim, H100_BF16_FLOPS)
    if G < 1:
        raise ValueError("num_bufs >= 1")
    G = min(G, max(1, max_blocks))
    while G > 1 and paged_attn_smem_bytes(
            G, block_size, head_dim, kv_itemsize, rt) > smem_budget:
        if num_bufs is not None:
            raise ValueError(f"ring of {num_bufs} exceeds the shared-memory "
                             f"budget of {smem_budget} bytes")
        G -= 1
    smem = paged_attn_smem_bytes(G, block_size, head_dim, kv_itemsize, rt)
    if smem > smem_budget:
        raise ValueError(f"paged attention needs {smem} bytes of shared "
                         f"memory (budget {smem_budget})")
    return PagedAttnPlan(rt, splits, G, max(1, min(G - 1, block_size)), smem)
