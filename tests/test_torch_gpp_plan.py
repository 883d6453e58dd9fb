"""The tensor-core route of the port's `gpp_matmul` (cluster split-K), on
the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py); what
surrounds it is plain Python and is checked here:
  * `core.schedule.plan_matmul_tc_sm90` at every projection shape of both
    serving paths (qwen1.5-0.5b and deepseek-v2-lite-16b; M = 4 / 32 / 20
    rows at decode / prefill / verify): every (tile, k-step) is walked by
    exactly one rank of the tile's cluster, the k-slices are contiguous,
    in rank order and differ by at most one step, every k row is
    multiplied by exactly one (rank, k-group), the ranks' columns cover
    the tile once, the ring and the partials that reuse it fit the shared
    memory, a pinned ring is kept, and what cannot run raises; where one
    CTA a tile is more tiles than SMs (the wide gate/up of qwen2-7b and
    kimi-k2), two CTAs share an SM so every tile runs in one wave;
  * `kernels.ref.dense_cluster_ref` — the plain replay of the kernel's
    split and its rank-order sum — against the JAX package's `gpp_matmul`
    in Pallas interpret mode on the same numpy inputs, at f32 (1e-5) and
    bf16 (2e-2), with k-slices of 2-3 steps, clusters of 2-16, ragged M, K
    and N, and every activation with bias and scale;
  * a transliteration of the ring's step loop over rank 0's planned slice
    issues exactly `chunk_issue_schedule`, with each step's x tile landed
    at its wait;
  * the dtype route.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gpp_matmul as jgm
from repro_torch.core import schedule as sched
from repro_torch.kernels import gpp_matmul as gm
from repro_torch.kernels.ref import (chunk_issue_schedule, dense_cluster_ref,
                                     dense_ref)

from _torch_parity import np32, ring_replay, t

pytestmark = pytest.mark.tier1

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# (K, N) of every bf16 projection on the two serving paths
PROJ = {"qwen qkvo": (1024, 1024), "qwen gate_up": (1024, 2816),
        "qwen down": (2816, 1024), "ds q": (2048, 3072),
        "ds kv_down": (2048, 576), "ds o": (2048, 2048),
        "ds shared_gate_up": (2048, 2816), "ds shared_down": (2816, 2048),
        "ds dense_gate_up": (2048, 10944), "ds dense_down": (10944, 2048)}
PHASE_M = {"decode": 4, "prefill": 32, "verify": 20}
PATH_SHAPES = [(M, K, N) for M in PHASE_M.values() for K, N in PROJ.values()]
RAGGED_SHAPES = [(7, 300, 130), (200, 1000, 1001), (1, 64, 8),
                 (129, 4096, 300)]


def _fits(plan):
    # the ring, and the partials that reuse it, fit a CTA's 227 KB
    ring = (plan.num_bufs * plan.block_k * plan.block_n * 2
            + 2 * plan.block_m * plan.block_k * 2)
    partial = plan.k_groups * plan.block_m * (plan.block_n + 8) * 4
    assert plan.smem_bytes == max(ring, partial) == \
        sched.matmul_tc_smem_bytes(plan.block_m, plan.block_k, plan.block_n,
                                   plan.num_bufs)
    assert plan.smem_bytes <= sched.SMEM_BUDGET_BYTES


def cluster_checks(plan):
    """What every plan of the tensor-core route must hold: each tile's
    k-steps walked once, by contiguous slices in rank order that differ by
    at most one step and leave no rank empty; each k row below K multiplied
    by exactly one (rank, k-group); the ranks' columns covering the tile
    once, four at a time (the kernel's float4 sum)."""
    S = plan.cluster
    assert plan.grid == (S, plan.n_tiles, plan.m_tiles)
    assert plan.ctas == S * plan.tiles
    walked = [k for r in range(S) for k in plan.k_slice(r)]
    assert walked == list(range(plan.num_k))
    sizes = {plan.cta_steps(r) for r in range(S)}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert plan.k_groups == 128 // plan.block_n
    rows = [k for r in range(S) for g in range(plan.k_groups)
            for k in plan.k_rows(r, g)]
    assert sorted(rows) == list(range(plan.K))
    cols = [c for r in range(S) for c in plan.rank_columns(r)]
    assert cols == list(range(plan.block_n))
    assert len(plan.rank_columns(0)) % 4 == 0


@pytest.mark.parametrize("shape", PATH_SHAPES + RAGGED_SHAPES)
def test_units_walked_once_in_balanced_runs(shape):
    M, K, N = shape
    plan = sched.plan_matmul_tc_sm90(M, K, N)
    # a portable cluster, tiles of 64 or 128 columns, a known block_k
    assert plan.cluster in sched.GPP_MM_TC_CLUSTERS and plan.cluster <= 8
    assert plan.block_n in (64, 128)
    assert plan.block_k in sched.GPP_MM_TC_BLOCK_KS
    _fits(plan)
    # block_m covers M up to 128 (M rounded up to 16 at the path's M)
    assert plan.block_m >= min(M, 128) and plan.block_m % 16 == 0
    assert plan.m_tiles == -(-M // 128)
    # a planned ring is no deeper than the longest slice, nor than 2
    assert plan.num_bufs <= max(plan.cta_steps(r)
                                for r in range(plan.cluster))
    assert plan.num_bufs <= sched.GPP_MM_TC_MAX_RING
    assert plan.chunks == max(1, min(plan.num_bufs - 1, plan.block_k))
    cluster_checks(plan)


def test_plan_at_the_path_shapes():
    # qwen's q/k/v/o: 16 tiles of 64 columns in clusters of 4, 64 CTAs of
    # one 32 KB step each, in situ
    qkvo = sched.plan_matmul_tc_sm90(32, 1024, 1024)
    assert (qkvo.block_m, qkvo.block_n, qkvo.block_k) == (32, 64, 256)
    assert (qkvo.cluster, qkvo.tiles, qkvo.ctas) == (4, 16, 64)
    assert (qkvo.num_bufs, qkvo.chunks) == (1, 1)
    assert {qkvo.cta_steps(r) for r in range(4)} == {1}
    # layer 0's down projection: 16 tiles of 128 in clusters of 4, slices
    # of 10-11 of the 43 steps of 256 rows, on a ping-pong ring
    # (plan_stream's 8, clamped to the measured best, 2)
    down = sched.plan_matmul_tc_sm90(4, 10944, 2048)
    assert (down.block_n, down.cluster, down.block_k) == (128, 4, 256)
    assert (down.num_k, down.ctas, down.num_bufs) == (43, 64, 2)
    assert {down.cta_steps(r) for r in range(4)} == {10, 11}
    # at most GPP_MM_TC_CTAS CTAs wherever one CTA a tile leaves room
    for M, K, N in PATH_SHAPES:
        p = sched.plan_matmul_tc_sm90(M, K, N)
        assert p.ctas <= sched.GPP_MM_TC_CTAS
        assert p.block_k == 256
    # decode: 16 rows a tile, prefill and verify 32
    for M, bm in ((4, 16), (32, 32), (20, 32)):
        assert sched.plan_matmul_tc_sm90(M, 1024, 2816).block_m == bm


# (K, N) with more 128-column tiles than SMs but at most twice as many:
# qwen2-7b's and kimi-k2's gate/up, the GeMM sequence's 8 folded rounds
WIDE = {"qwen2 gate_up": (3584, 18944), "kimi gate_up": (7168, 18432),
        "gemm sequence": (4096, 8 * 4096)}


@pytest.mark.parametrize("M", (4, 8, 20, 32, 64))
@pytest.mark.parametrize("proj", WIDE)
def test_wide_projection_runs_in_one_wave(proj, M):
    # one CTA a tile at k-steps of 128 rows: two CTAs of the 2-slot ring
    # share an SM, so the card holds every tile at once
    K, N = WIDE[proj]
    plan = sched.plan_matmul_tc_sm90(M, K, N)
    assert (plan.cluster, plan.block_n, plan.block_k) == (1, 128, 128)
    assert plan.num_bufs == 2
    assert sched.H100_SMS < plan.tiles <= 2 * sched.H100_SMS
    assert 2 * (plan.smem_bytes + sched.CTA_SMEM_RESERVED) <= \
        sched.SM_SMEM_BYTES
    _fits(plan)
    cluster_checks(plan)
    # narrower: block_k stays 256 (gemma3-12b's gate/up, 120 tiles)
    assert sched.plan_matmul_tc_sm90(M, 3840, 15360).block_k == 256


@pytest.mark.parametrize("G", (1, 2, 3, 4, 6))
def test_pinned_ring_is_kept(G):
    for shape in PATH_SHAPES:
        plan = sched.plan_matmul_tc_sm90(*shape, num_bufs=G)
        planned = sched.plan_matmul_tc_sm90(*shape)
        assert plan.num_bufs == G
        assert plan.chunks == max(1, min(G - 1, plan.block_k))
        # the split stays; block_k halves only where the ring cannot fit
        assert (plan.block_n, plan.cluster) == (planned.block_n,
                                                planned.cluster)
        assert plan.block_k <= planned.block_k
        _fits(plan)
        cluster_checks(plan)


def test_pins_for_sweeps():
    p = sched.plan_matmul_tc_sm90(4, 1024, 2816, block_n=64, cluster=2,
                                  block_k=128)
    assert (p.block_n, p.cluster, p.block_k) == (64, 2, 128)
    assert p.grid == (2, 44, 1)
    cluster_checks(p)
    # clusters of 16 (the non-portable size) only when pinned
    wide = sched.plan_matmul_tc_sm90(4, 2048, 1024, cluster=16, block_k=128)
    assert (wide.cluster, wide.num_k) == (16, 16)
    cluster_checks(wide)


def test_plan_rejects_what_cannot_run():
    # no kernel instance at these tiles, steps or clusters; a ring of 16
    # fits no block_k; a cluster wider than the k-steps leaves a rank empty
    for kw in (dict(num_bufs=0), dict(block_k=64), dict(block_k=96),
               dict(block_n=32), dict(block_n=256), dict(cluster=3),
               dict(cluster=32), dict(num_bufs=16),
               dict(cluster=16, block_k=256)):
        with pytest.raises(ValueError):
            sched.plan_matmul_tc_sm90(4, 1024, 2816, **kw)
    with pytest.raises(ValueError):
        sched.plan_matmul_tc_sm90(0, 1024, 2816)
    with pytest.raises(ValueError):            # a pinned ring that cannot fit
        sched.plan_matmul_tc_sm90(4, 1024, 2816, num_bufs=8,
                                  smem_budget=60_000)


# (M, K, N, pins): k-slices of 2-3 steps, clusters of 2-16, both tile
# widths, at ragged M, K and N
SPLITS = [(5, 600, 260, dict(block_n=64, cluster=4, block_k=128)),
          (20, 600, 130, dict(block_n=128, cluster=2, block_k=128)),
          (37, 2048, 384, dict(block_n=64, cluster=8, block_k=128)),
          (7, 4000, 1001, dict(block_n=128, cluster=16, block_k=128)),
          (130, 400, 200, dict(block_n=64, cluster=2, block_k=128))]


def _split_plan(M, K, N, pins):
    plan = sched.plan_matmul_tc_sm90(M, K, N, **pins)
    assert (plan.block_n, plan.cluster, plan.block_k) == \
        (pins["block_n"], pins["cluster"], pins["block_k"])
    # some rank's slice holds several steps
    assert max(plan.cta_steps(r) for r in range(plan.cluster)) >= 2
    cluster_checks(plan)
    return plan


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    s = (rng.random(N) * 2 + 0.5).astype(np.float32)
    return x, w, b, s


@pytest.mark.parametrize("case", SPLITS)
def test_split_replay_matches_jax_f32(case):
    plan = _split_plan(*case)
    M, K, N, _ = case
    x, w, b, s = _inputs(M, K, N, 0)
    want = jgm.gpp_matmul(jnp.asarray(x), jnp.asarray(w),
                          bias=jnp.asarray(b), w_scale=jnp.asarray(s),
                          activation="silu", interpret=True)
    got = dense_cluster_ref(t(x), t(w), plan, bias=t(b), w_scale=t(s),
                            activation="silu")
    np.testing.assert_allclose(np32(got), np32(want), **F32)


@pytest.mark.parametrize("case", SPLITS)
def test_split_replay_matches_jax_bf16(case):
    plan = _split_plan(*case)
    M, K, N, _ = case
    x, w, b, _ = _inputs(M, K, N, 1)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jgm.gpp_matmul(xb, wb, bias=jnp.asarray(b), activation="gelu",
                          interpret=True)
    got = dense_cluster_ref(t(xb), t(wb), plan, bias=t(b),
                            activation="gelu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), **BF16)


@pytest.mark.parametrize("act", ("relu", "gelu", "silu", "tanh", "sigmoid",
                                 "none", None))
def test_split_replay_epilogue(act):
    # every activation after bias and per-column scale, on a split plan
    M, K, N, pins = SPLITS[0]
    plan = _split_plan(M, K, N, pins)
    x, w, b, s = _inputs(M, K, N, 2)
    want = jgm.gpp_matmul(jnp.asarray(x), jnp.asarray(w),
                          bias=jnp.asarray(b), w_scale=jnp.asarray(s),
                          activation=act, interpret=True)
    got = dense_cluster_ref(t(x), t(w), plan, bias=t(b), w_scale=t(s),
                            activation=act)
    np.testing.assert_allclose(np32(got), np32(want), **F32)
    # and the split sums to the unsplit plain version
    np.testing.assert_allclose(
        np32(got), np32(dense_ref(t(x), t(w), bias=t(b), w_scale=t(s),
                                  activation=act)), **F32)


def test_split_replay_at_a_path_shape():
    # the planned split at deepseek's decode kv down-projection (9 tiles of
    # 64 columns in clusters of 8, two k-groups) against the plain version,
    # at a seed's random weights
    plan = sched.plan_matmul_tc_sm90(4, 2048, 576)
    assert (plan.block_n, plan.cluster, plan.k_groups) == (64, 8, 2)
    x, w, b, _ = _inputs(4, 2048, 576, 3)
    got = dense_cluster_ref(t(x), t(w), plan, bias=t(b))
    np.testing.assert_allclose(np32(got), np32(dense_ref(t(x), t(w),
                                                         bias=t(b))),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("G", (None, 1, 2, 3, 4))
@pytest.mark.parametrize("shape", PATH_SHAPES[:10:3] + [(4, 10944, 2048)]
                         + [s[:3] for s in SPLITS[:2]])
def test_cta0_replay_is_the_chunk_schedule(shape, G):
    plan = sched.plan_matmul_tc_sm90(*shape, num_bufs=G)
    S, Gp, C = plan.cta_steps(0), plan.num_bufs, plan.chunks
    order, x_at, chunk_groups, landed = ring_replay(S, Gp, C)
    assert order == chunk_issue_schedule(S, Gp, C)
    assert order == jgm.chunk_issue_schedule(S, Gp, C)
    for s in range(S):
        # every W chunk of step s and its x tile have landed at its wait;
        # the x tile goes out at most one step ahead, into slot s % 2
        assert all(g < landed[s] for g in chunk_groups[s])
        at, group = x_at[s]
        assert group < landed[s] and s - 1 <= at <= s


def test_issue_record_run_crosses_tile_and_split_boundaries():
    # the card test's pinned plan (tests/test_torch_cuda.py): in clusters
    # of 2 at 128-row steps, rank 0 walks k-steps 0-7 of its tile and rank
    # 1 continues at step 8
    plan = sched.plan_matmul_tc_sm90(4, 2048, 1024, cluster=2, block_k=128)
    assert list(plan.k_slice(0)) == list(range(8))
    assert list(plan.k_slice(1)) == list(range(8, 16))
    assert plan.cta_steps(0) == 8


@pytest.mark.parametrize("x_dtype,w_dtype,route", [
    (torch.bfloat16, torch.bfloat16, "tc"),
    (torch.float32, torch.float32, "fma"),
    (torch.float32, torch.int8, "fma"),
    (torch.bfloat16, torch.int8, "fma"),
    (torch.float32, torch.bfloat16, "fma"),
    (torch.bfloat16, torch.float32, "fma"),
])
def test_dtype_route(x_dtype, w_dtype, route):
    assert gm.gpp_route(x_dtype, w_dtype) == route
    # no kernel for a CPU tensor, on either route
    x = torch.zeros(4, 64, dtype=x_dtype)
    w = torch.zeros(64, 128, dtype=w_dtype)
    with pytest.raises(ValueError, match="CUDA"):
        gm.gpp_matmul(x, w)


def test_launch_plan_is_cached_per_shape():
    # the wrapper plans a shape once a process, pins and all
    gm._tc_plan.cache_clear()
    a = gm._plan("tc", 4, 1024, 2816, 2, None)
    assert gm._plan("tc", 4, 1024, 2816, 2, None) is a
    assert a == sched.plan_matmul_tc_sm90(4, 1024, 2816)
    pinned = gm._plan("tc", 4, 1024, 2816, 2, None, cluster=2)
    assert pinned.cluster == 2 and pinned is not a
    assert gm._tc_plan.cache_info().currsize == 2


# (block_n, block_k, cluster, G) planned at every bf16 projection (K, N) of
# the six served archs (chip_smoke.GPP_SHAPES) before the planner weighed
# waves: the same at 4 (decode), 16 (the draft model's window), 20
# (verify) and 32 (prefill) rows, so no serving path's plan moves
SERVING_PLANS = {
    (1024, 1024): (64, 256, 4, 1), (1024, 2816): (128, 256, 4, 1),
    (2048, 576): (64, 256, 8, 1), (2048, 2048): (128, 256, 4, 2),
    (2048, 2816): (128, 256, 4, 2), (2048, 3072): (128, 256, 4, 2),
    (2048, 7168): (128, 256, 1, 2), (2048, 10944): (128, 256, 1, 2),
    (2560, 640): (64, 256, 8, 2), (2560, 2560): (128, 256, 4, 2),
    (2560, 6912): (128, 256, 1, 2), (2816, 1024): (128, 256, 8, 2),
    (2816, 2048): (128, 256, 4, 2), (3584, 512): (64, 256, 8, 2),
    (3584, 3584): (128, 256, 2, 2), (3584, 18944): (128, 128, 1, 2),
    (3840, 2048): (128, 256, 4, 2), (3840, 4096): (128, 256, 2, 2),
    (3840, 15360): (128, 256, 1, 2), (4096, 3840): (128, 256, 2, 2),
    (6912, 2560): (128, 256, 4, 2), (7168, 1024): (128, 256, 8, 2),
    (7168, 2048): (128, 256, 4, 2), (7168, 8192): (128, 256, 1, 2),
    (7168, 18432): (128, 128, 1, 2), (8192, 7168): (128, 256, 1, 2),
    (10944, 2048): (128, 256, 4, 2), (15360, 3840): (128, 256, 2, 2),
    (18432, 7168): (128, 256, 1, 2), (18944, 3584): (128, 256, 2, 2)}


@pytest.mark.parametrize("M", (4, 16, 20, 32))
def test_serving_plans_are_pinned(M):
    for (K, N), want in SERVING_PLANS.items():
        p = sched.plan_matmul_tc_sm90(M, K, N)
        assert (p.block_n, p.block_k, p.cluster, p.num_bufs) == want, (K, N)
        assert p.block_m == (16 if M <= 16 else 32)
        # every serving plan runs its clusters in one wave
        assert sched.tc_waves(p.tiles, p.cluster, p.smem_bytes) == 1


@pytest.mark.parametrize("M,G", ((8, 2), (128, 1)))
def test_ring_depth_weighs_waves(M, G):
    # the GeMM sequence (8 folded rounds of 4096 x 4096, 256 tiles of 128
    # columns): at 8 rows the 2-slot ring (72 KB) holds three CTAs an SM,
    # all 256 tiles at once; at 128 rows it (128 KB) holds one, two waves,
    # while in situ (96 KB) holds two, one wave, so in situ is planned
    K, N = WIDE["gemm sequence"]
    p = sched.plan_matmul_tc_sm90(M, K, N)
    assert p.num_bufs == G and p.tiles == 256
    assert sched.tc_waves(p.tiles, p.cluster, p.smem_bytes) == 1
    two = sched.matmul_tc_smem_bytes(p.block_m, p.block_k, p.block_n, 2)
    assert sched.tc_waves(p.tiles, 1, two) == (1 if M == 8 else 2)
    assert sched.tc_ctas_per_sm(p.smem_bytes) == (3 if M == 8 else 2)
    # a pinned ring is kept whatever its waves
    assert sched.plan_matmul_tc_sm90(M, K, N, num_bufs=2).num_bufs == 2


# (block_n, block_k, cluster, G) planned at every bf16 projection (K, N) of
# the dense-cache paths (chip_smoke.DENSE_GPP): zamba2's w_in / w_bc / w_dt
# (N = 10240 / 128 / 32) and w_out (K = 5120), its shared block; xlstm's
# gates (N = 4), its 2048-wide projections (the sigmoid output gates, and
# w_o, 4 heads of 512 contracted as one 2048-row K); musicgen's gelu up and
# its down; llama-3.2-vision's q / o, k / v, gate and down.  The same at 4
# (decode), 15 (a prompt), 16, 20, 32 and 128 (a 4 x 32 step prefill)
# rows but for G, which is 1 (in situ) at 128 rows but at two shapes
DENSE_PLANS = {
    (2560, 10240): (128, 256, 1, 2), (2560, 128): (64, 256, 8, 2),
    (2560, 32): (128, 256, 8, 2), (5120, 2560): (128, 256, 4, 2),
    (2560, 2560): (128, 256, 4, 2), (10240, 2560): (128, 256, 4, 2),
    (2048, 2048): (128, 256, 4, 2), (2048, 4): (128, 256, 8, 1),
    (2048, 8192): (128, 256, 1, 2), (8192, 2048): (128, 256, 4, 2),
    (4096, 4096): (128, 256, 2, 2), (4096, 1024): (128, 256, 8, 2),
    (4096, 14336): (128, 256, 1, 2), (14336, 4096): (128, 256, 2, 2)}
SAME_G_AT_128 = {(2560, 128), (2048, 4)}


@pytest.mark.parametrize("M", (4, 15, 16, 20, 32, 128))
def test_dense_path_plans_are_pinned(M):
    for (K, N), (bn, bk, S, G) in DENSE_PLANS.items():
        p = sched.plan_matmul_tc_sm90(M, K, N)
        if M == 128 and (K, N) not in SAME_G_AT_128:
            G = 1
        assert (p.block_n, p.block_k, p.cluster, p.num_bufs) == \
            (bn, bk, S, G), (M, K, N)
        assert p.block_m == (16 if M <= 16 else 32 if M <= 32 else 128)
        assert sched.tc_waves(p.tiles, p.cluster, p.smem_bytes) == 1
        # every rank has k-steps; the tiles pad N by less than one tile
        assert p.cluster <= p.num_k and p.n_tiles * p.block_n < N + 128


def test_cross_kv_plan_is_pinned():
    # llama-3.2-vision's cross K / V project 4 x 1600 patch embeddings
    # (6400 rows) at every step: 50 m-tiles of 128 rows, clusters of 8 over
    # K = 4096, in situ (192 KB of shared memory, one CTA an SM)
    p = sched.plan_matmul_tc_sm90(6400, 4096, 1024)
    assert (p.block_m, p.block_n, p.block_k, p.cluster, p.num_bufs) == \
        (128, 128, 256, 8, 1)
    assert p.m_tiles == 50 and p.tiles == 400
    assert sched.tc_waves(p.tiles, p.cluster, p.smem_bytes) == 25


@pytest.mark.parametrize("K,N", ((2560, 32000), (2048, 50304),
                                 (4096, 128256), (2048, 2048)))
def test_dense_path_head_plans_are_pinned(K, N):
    # the f32 logits heads of zamba2, xlstm, llama-3.2-vision and musicgen
    # on the FMA route (f32 x against the bf16 table): block_k 256, all
    # 132 SMs, a 2-slot ring, and the same k-cuts at 1 and 4 rows
    plans = [sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=2)
             for M in (1, 4)]
    for p in plans:
        assert (p.block_m, p.block_k, p.grid, p.num_bufs) == (4, 256, 132, 2)
    assert [plans[0].cta_units(i) for i in range(132)] == \
        [plans[1].cta_units(i) for i in range(132)]
