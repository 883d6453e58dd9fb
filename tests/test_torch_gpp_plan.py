"""The tensor-core route of the port's `gpp_matmul` (stream-K), on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py); what
surrounds it is plain Python and is checked here:
  * `core.schedule.plan_matmul_tc_sm90` at every projection shape of both
    serving paths (qwen1.5-0.5b and deepseek-v2-lite-16b; M = 4 / 32 / 20
    rows at decode / prefill / verify): every (tile, k-step) unit is walked
    by exactly one CTA, runs differ by at most one unit, the CTAs that
    share a tile are its segments in k order, the ring fits the shared
    memory that many CTAs an SM share, a pinned ring is kept, and what
    cannot run raises;
  * `kernels.ref.dense_split_ref` — the plain replay of the kernel's
    stream-K split and fixed-order fix-up — against the JAX package's
    `gpp_matmul` in Pallas interpret mode on the same numpy inputs, at f32
    (1e-5) and bf16 (2e-2), with runs that cross tiles, tiles split over
    2-3 CTAs, ragged M, K and N, and every activation with bias and scale;
  * a transliteration of the ring's step loop over CTA 0's planned run
    issues exactly `chunk_issue_schedule`, with each step's x tile landed
    at its wait;
  * the dtype route.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gpp_matmul as jgm
from repro_torch.core import schedule as sched
from repro_torch.kernels import gpp_matmul as gm
from repro_torch.kernels.ref import (chunk_issue_schedule, dense_ref,
                                     dense_split_ref)

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
    # the ring fits a CTA's 227 KB, and ctas_per_sm of them an SM
    assert plan.smem_bytes <= sched.SMEM_BUDGET_BYTES
    assert 1 <= plan.ctas_per_sm <= 2
    need = plan.smem_bytes + sched.CTA_SMEM_RESERVED
    assert plan.ctas_per_sm * need <= sched.SM_SMEM_BYTES
    assert plan.ctas_per_sm == 2 or 2 * need > sched.SM_SMEM_BYTES


def _walk_checks(plan):
    walked = [u for i in range(plan.grid) for u in plan.cta_units(i)]
    assert walked == list(range(plan.units))      # once each, in order
    sizes = {plan.cta_steps(i) for i in range(plan.grid)}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    for u in range(plan.units):                   # the kernel's owner()
        assert u in plan.cta_units(plan.owner(u))
    for tile in range(plan.tiles):
        segs = plan.segments(tile)
        assert len(segs) <= plan.max_segs
        # the CTAs sharing a tile cover its k-steps once, in segment order
        ks = [plan.unit(u)[1] for i in segs for u in plan.cta_units(i)
              if plan.unit(u)[0] == tile]
        assert ks == list(range(plan.num_k))
    # units tile-major (n-tile, then m-tile), the k-step inner
    assert [plan.unit(u) for u in range(plan.units)] == \
        [(tl, k) for tl in range(plan.tiles) for k in range(plan.num_k)]
    assert [plan.tile(tl) for tl in range(plan.tiles)] == \
        [(n, m) for n in range(plan.n_tiles) for m in range(plan.m_tiles)]


@pytest.mark.parametrize("shape", PATH_SHAPES + RAGGED_SHAPES)
def test_units_walked_once_in_balanced_runs(shape):
    M, K, N = shape
    plan = sched.plan_matmul_tc_sm90(M, K, N)
    assert plan.grid == min(plan.units, sched.H100_SMS)   # one CTA an SM
    assert plan.smem_bytes == sched.matmul_tc_smem_bytes(
        plan.block_m, plan.block_k, plan.num_bufs)
    _fits(plan)
    # block_m covers M up to 128 (M rounded up to 16 at the path's M)
    assert plan.block_m >= min(M, 128) and plan.block_m % 16 == 0
    assert plan.m_tiles == -(-M // 128)
    # a planned ring is no deeper than the longest run, nor than 2
    assert plan.num_bufs <= max(plan.cta_steps(i) for i in range(plan.grid))
    assert plan.num_bufs <= sched.GPP_MM_TC_MAX_RING
    _walk_checks(plan)
    # the workspace: a (block_m x 128) f32 slot per (tile, segment)
    segs = plan.max_segs
    assert plan.workspace_floats == \
        (0 if segs == 1 else plan.tiles * segs * plan.block_m * 128)


def test_plan_at_the_path_shapes():
    # decode up-projection: 22 n-tiles x 4 k-steps of 256 = 88 units, one
    # a CTA, in situ; two such CTAs would fit an SM
    up = sched.plan_matmul_tc_sm90(4, 1024, 2816)
    assert (up.block_m, up.block_n, up.block_k) == (16, 128, 256)
    assert (up.units, up.grid, up.num_bufs, up.chunks) == (88, 88, 1, 1)
    assert (up.ctas_per_sm, up.max_segs) == (2, 4)
    # layer 0's down projection: 16 n-tiles x 43 k-steps = 688 units on
    # 132 CTAs (runs of 5-6) on a ping-pong ring (plan_stream's 8, clamped
    # to the run and to the measured best, 2)
    down = sched.plan_matmul_tc_sm90(4, 10944, 2048)
    assert (down.block_k, down.units, down.grid) == (256, 688, 132)
    assert (down.num_bufs, down.chunks, down.ctas_per_sm) == (2, 1, 1)
    assert {down.cta_steps(i) for i in range(down.grid)} == {5, 6}
    # prefill and verify: 32 rows a tile
    for M in (32, 20):
        assert sched.plan_matmul_tc_sm90(M, 1024, 2816).block_m == 32
    # every path shape: 64 KB W steps, at most one CTA an SM
    for M, K, N in PATH_SHAPES:
        p = sched.plan_matmul_tc_sm90(M, K, N)
        assert p.block_k == 256 and p.grid == min(p.units, 132)
        assert p.max_segs <= 11


@pytest.mark.parametrize("G", (1, 2, 3, 4, 6))
def test_pinned_ring_is_kept(G):
    for shape in PATH_SHAPES:
        plan = sched.plan_matmul_tc_sm90(*shape, num_bufs=G)
        assert plan.num_bufs == G
        assert plan.chunks == max(1, min(G - 1, plan.block_k))
        _fits(plan)
        _walk_checks(plan)


def test_pins_for_sweeps():
    p = sched.plan_matmul_tc_sm90(4, 1024, 2816, block_k=256, grid=50)
    assert (p.block_k, p.grid) == (256, 50)
    _walk_checks(p)
    # a grid beyond the units is cut to them
    assert sched.plan_matmul_tc_sm90(4, 64, 128, grid=9).grid == 1


def test_plan_rejects_what_cannot_run():
    # block_k 64 has no kernel instance; a ring of 8 fits no block_k
    for kw in (dict(num_bufs=0), dict(block_k=32), dict(block_k=64),
               dict(block_k=96), dict(grid=0), dict(num_bufs=8)):
        with pytest.raises(ValueError):
            sched.plan_matmul_tc_sm90(4, 1024, 2816, **kw)
    with pytest.raises(ValueError):
        sched.plan_matmul_tc_sm90(0, 1024, 2816)
    with pytest.raises(ValueError):            # a pinned ring that cannot fit
        sched.plan_matmul_tc_sm90(4, 1024, 2816, num_bufs=8,
                                  smem_budget=60_000)


# (M, K, N, grid): runs that cross tiles and tiles split over 2-3 CTAs,
# at ragged M, K and N (block_k 128: K = 600 is 5 k-steps, the last of 88)
SPLITS = [(5, 600, 260, 4),      # 15 units on 4 CTAs: runs of 3-4
          (20, 600, 130, 3),     # 10 units on 3: every tile split
          (37, 1024, 384, 7),    # 24 units on 7 CTAs
          (7, 2000, 1001, 37),   # 8 n-tiles x 16 k-steps on 37 CTAs
          (130, 400, 200, 5)]    # two m-tiles of 128 rows


def _split_plan(M, K, N, grid):
    plan = sched.plan_matmul_tc_sm90(M, K, N, block_k=128, grid=grid)
    assert plan.grid == grid and plan.max_segs >= 2
    # some CTA's run crosses a tile boundary, and some tile is split
    assert any(len({plan.unit(u)[0] for u in plan.cta_units(i)}) > 1
               for i in range(grid))
    assert any(len(plan.segments(tl)) > 1 for tl in range(plan.tiles))
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
    M, K, N, grid = case
    plan = _split_plan(M, K, N, grid)
    x, w, b, s = _inputs(M, K, N, 0)
    want = jgm.gpp_matmul(jnp.asarray(x), jnp.asarray(w),
                          bias=jnp.asarray(b), w_scale=jnp.asarray(s),
                          activation="silu", interpret=True)
    got = dense_split_ref(t(x), t(w), plan, bias=t(b), w_scale=t(s),
                          activation="silu")
    np.testing.assert_allclose(np32(got), np32(want), **F32)


@pytest.mark.parametrize("case", SPLITS)
def test_split_replay_matches_jax_bf16(case):
    M, K, N, grid = case
    plan = _split_plan(M, K, N, grid)
    x, w, b, _ = _inputs(M, K, N, 1)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jgm.gpp_matmul(xb, wb, bias=jnp.asarray(b), activation="gelu",
                          interpret=True)
    got = dense_split_ref(t(xb), t(wb), plan, bias=t(b), activation="gelu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), **BF16)


@pytest.mark.parametrize("act", ("relu", "gelu", "silu", "tanh", "sigmoid",
                                 "none", None))
def test_split_replay_epilogue(act):
    # every activation after bias and per-column scale, on a split plan
    M, K, N, grid = SPLITS[0]
    plan = _split_plan(M, K, N, grid)
    x, w, b, s = _inputs(M, K, N, 2)
    want = jgm.gpp_matmul(jnp.asarray(x), jnp.asarray(w),
                          bias=jnp.asarray(b), w_scale=jnp.asarray(s),
                          activation=act, interpret=True)
    got = dense_split_ref(t(x), t(w), plan, bias=t(b), w_scale=t(s),
                          activation=act)
    np.testing.assert_allclose(np32(got), np32(want), **F32)
    # and the split sums to the unsplit plain version
    np.testing.assert_allclose(
        np32(got), np32(dense_ref(t(x), t(w), bias=t(b), w_scale=t(s),
                                  activation=act)), **F32)


def test_split_replay_at_a_path_shape():
    # the planned split at deepseek's decode kv down-projection (5 n-tiles
    # x 8 k-steps on 40 CTAs: 8 segments a tile) against the plain
    # version, at a seed's random weights
    plan = sched.plan_matmul_tc_sm90(4, 2048, 576)
    assert plan.max_segs == 8
    x, w, b, _ = _inputs(4, 2048, 576, 3)
    got = dense_split_ref(t(x), t(w), plan, bias=t(b))
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
    # the card test's pinned grid (tests/test_torch_cuda.py): CTA 0 walks
    # tile 0's 8 k-steps and 4 of tile 1's, which CTA 1 finishes
    plan = sched.plan_matmul_tc_sm90(4, 2048, 1024, grid=5)
    assert [plan.unit(u) for u in plan.cta_units(0)] == \
        [(0, k) for k in range(8)] + [(1, k) for k in range(4)]
    assert list(plan.segments(1)) == [0, 1]


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
    # the wrapper plans a shape once a process: max_segs walks every tile
    gm._tc_plan.cache_clear()
    a = gm._tc_plan(4, 1024, 2816, num_bufs=None)
    assert gm._tc_plan(4, 1024, 2816, num_bufs=None) is a
    assert a == sched.plan_matmul_tc_sm90(4, 1024, 2816)
    assert a.max_segs == 4 and "max_segs" in vars(a)      # kept once known
    plan = dataclasses.replace(a, grid=a.units)            # planned anew
    assert plan.max_segs == plan.num_k                    # one unit a CTA
