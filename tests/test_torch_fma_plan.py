"""The FMA route of the port's `gpp_matmul` (split-K), on the CPU.

The kernel (`gpp_matmul_kernel`, csrc/gpp_matmul.cu) runs only on the card
(tests/test_torch_cuda.py); what surrounds it is plain Python and is
checked here:
  * `core.schedule.plan_matmul_fma_sm90` at every f32 projection shape of
    both serving paths (qwen1.5-0.5b and deepseek-v2-lite-16b, deepseek's
    router included; M = 4 / 32 / 20 rows at decode / prefill / verify) and
    at ragged shapes: every (tile, k-step) unit is walked by exactly one
    CTA, runs differ by at most one unit, tiles m-major, m-tiles of P0 CTAs
    each filling at most 132 CTAs, the ring fits the shared memory, a
    pinned ring or grid is kept, and what cannot run raises;
  * block_k, P0 and the k-cuts of every m-tile (each segment's k-steps, in
    segment order) are the same at M = 1, 4, 20, 32 and 64 and for f32,
    bf16 and int8 W: the order of a row's sums does not depend on the
    batch;
  * `kernels.ref.dense_split_ref` — the plain replay of the kernel's split
    and fixed-order fix-up — against the JAX package's `gpp_matmul` in
    Pallas interpret mode on the same numpy inputs at f32 (1e-5 +
    1e-5 |ref|), with runs that cross tiles, tiles split over several CTAs,
    ragged M, K and N, bias, scale, int8 W and every activation;
  * a transliteration of the ring's step loop over CTA 0's planned run
    issues exactly `chunk_issue_schedule`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gpp_matmul as jgm
from repro_torch.core import schedule as sched
from repro_torch.kernels import gpp_matmul as gm
from repro_torch.kernels.ref import (ACTIVATION_IDS, chunk_issue_schedule,
                                     dense_ref, dense_split_ref)

from _torch_parity import np32, ring_replay, t, walk_checks

pytestmark = pytest.mark.tier1

F32 = dict(rtol=1e-5, atol=1e-5)

# (K, N) of every f32 product on the two serving paths: deepseek's router
# in every run, the rest in the f32 runs
ROUTER = (2048, 64)
PROJ = {"qwen qkvo": (1024, 1024), "qwen gate_up": (1024, 2816),
        "qwen down": (2816, 1024), "ds q": (2048, 3072),
        "ds kv_down": (2048, 576), "ds o": (2048, 2048), "ds router": ROUTER,
        "ds shared_gate_up": (2048, 2816), "ds shared_down": (2816, 2048),
        "ds dense_gate_up": (2048, 10944), "ds dense_down": (10944, 2048)}
PHASE_M = {"decode": 4, "prefill": 32, "verify": 20}
PATH_SHAPES = [(M, K, N) for M in PHASE_M.values() for K, N in PROJ.values()]
RAGGED_SHAPES = [(7, 300, 130), (200, 1000, 1001), (1, 64, 8),
                 (129, 4096, 300), (65, 33, 65)]


def _plan(M, K, N, w_itemsize=4, **kw):
    return sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=w_itemsize, **kw)


@pytest.mark.parametrize("shape", PATH_SHAPES + RAGGED_SHAPES)
def test_units_walked_once_in_balanced_runs(shape):
    M, K, N = shape
    plan = _plan(M, K, N)
    assert plan.block_n == 64 and plan.block_k in sched.GPP_FMA_BLOCK_KS
    # P0 CTAs an m-tile, at most one CTA an SM, at least one unit each
    P0 = plan.grid // plan.m_tiles
    assert plan.grid == plan.m_tiles * P0 <= plan.units
    assert P0 == min(plan.n_tiles * plan.num_k, sched.H100_SMS)
    # block_m: 4 row groups x a power of two rows, the smallest whose
    # m-tiles fit 132 CTAs (one m-tile of up to 64 rows at P0 = 132)
    assert plan.block_m in (4, 8, 16, 32, 64)
    assert plan.grid <= sched.H100_SMS or plan.block_m == 64
    assert plan.block_m == 4 or \
        -(-M // (plan.block_m // 2)) * P0 > sched.H100_SMS
    # tiles m-major, the n-tile inner
    assert [plan.tile(tl) for tl in range(plan.tiles)] == \
        [(n, m) for m in range(plan.m_tiles) for n in range(plan.n_tiles)]
    assert plan.smem_bytes == sched.matmul_fma_smem_bytes(
        plan.block_m, plan.block_k, plan.num_bufs, 4)
    assert plan.smem_bytes <= sched.SMEM_BUDGET_BYTES
    # a planned ring is no deeper than the longest run, nor than 2
    assert plan.num_bufs <= max(plan.cta_steps(i) for i in range(plan.grid))
    assert plan.num_bufs <= sched.GPP_MM_TC_MAX_RING
    assert plan.chunks == max(1, min(plan.num_bufs - 1, plan.block_k))
    walk_checks(plan)
    # the workspace: two (block_m x 64) f32 slots a CTA, the tile its run
    # starts in and the one it ends in
    segs = plan.max_segs
    assert plan.workspace_floats == \
        (0 if segs == 1 else 2 * plan.grid * plan.block_m * 64)


def test_plan_at_the_router():
    # deepseek's router: 64 columns; its 2048 k rows go to 32 CTAs of one
    # short step each (16 KB of f32 W), in situ, every CTA a segment of its
    # tile; decode's 4 rows are one m-tile, verify's 20 three of 8 rows,
    # prefill's 32 four of 8, on otherwise idle SMs
    for M, (bm, m_tiles) in ((1, (4, 1)), (4, (4, 1)), (20, (8, 3)),
                             (32, (8, 4)), (64, (16, 4))):
        p = _plan(M, *ROUTER)
        assert (p.block_m, p.m_tiles, p.block_k) == (bm, m_tiles, 64)
        assert (p.grid, p.num_bufs, p.max_segs) == (32 * m_tiles, 1, 32)
        assert {p.cta_steps(i) for i in range(p.grid)} == {1}
        for tl in range(p.tiles):
            assert list(p.segments(tl)) == list(range(32 * tl,
                                                      32 * tl + 32))
    # a wide projection: 132 CTAs, runs of whole 64 KB f32 W steps
    down = _plan(4, 10944, 2048)
    assert (down.block_k, down.grid, down.num_bufs) == (256, 132, 2)
    assert {down.cta_steps(i) for i in range(down.grid)} == {10, 11}


@pytest.mark.parametrize("KN", [ROUTER, (1024, 1024), (1024, 2816),
                                (2816, 1024), (10944, 2048)])
def test_split_does_not_depend_on_the_rows_or_the_weight_dtype(KN):
    # block_k and the CTAs of an m-tile come from K and N alone, and every
    # m-tile is cut alike: at every M <= 64 and every W dtype a row's tile
    # meets the same k-cuts, summed in the same segment order (a bf16
    # router weight widened in the kernel rounds as its f32 copy did)
    K, N = KN

    def cuts(p, mt):
        """Each n-tile's segments, as the k-steps each walks, in order."""
        out = []
        for tl in range(p.tiles):
            if p.tile(tl)[1] != mt:
                continue
            out.append([[p.unit(u)[1] for u in p.cta_units(i)
                         if p.unit(u)[0] == tl] for i in p.segments(tl)])
        return out

    ref = _plan(1, K, N)
    for M in (1, 4, 20, 32, 64):
        for isz in (1, 2, 4):
            p = _plan(M, K, N, w_itemsize=isz)
            assert (p.block_k, p.grid // p.m_tiles) == (ref.block_k,
                                                        ref.grid)
            for mt in range(p.m_tiles):
                assert cuts(p, mt) == cuts(ref, 0)


@pytest.mark.parametrize("G", (1, 2, 3, 4, 6))
def test_pinned_ring_is_kept(G):
    for shape in PATH_SHAPES:
        plan = _plan(*shape, num_bufs=G)
        assert plan.num_bufs == G
        assert plan.chunks == max(1, min(G - 1, plan.block_k))
        assert plan.smem_bytes <= sched.SMEM_BUDGET_BYTES
        walk_checks(plan)


def test_pins_for_sweeps():
    p = _plan(4, 1024, 2816, block_k=64, grid=50)
    assert (p.block_k, p.grid) == (64, 50)
    walk_checks(p)
    # a grid beyond the units is cut to them
    assert _plan(4, 64, 64, block_k=64, grid=9).grid == 1
    # a pinned ring too deep for the planned block_k takes a smaller one
    deep = _plan(64, 2048, 3072, num_bufs=8)
    assert deep.num_bufs == 8 and deep.block_k < _plan(64, 2048,
                                                        3072).block_k


def test_plan_rejects_what_cannot_run():
    for kw in (dict(num_bufs=0), dict(block_k=16), dict(block_k=48),
               dict(block_k=512), dict(grid=0), dict(w_itemsize=3)):
        kw.setdefault("w_itemsize", 4)
        with pytest.raises(ValueError):
            sched.plan_matmul_fma_sm90(4, 1024, 2816, **kw)
    with pytest.raises(ValueError):
        _plan(0, 1024, 2816)
    with pytest.raises(ValueError):            # a pinned ring that cannot fit
        _plan(64, 2048, 3072, num_bufs=8, smem_budget=60_000)
    with pytest.raises(ValueError):            # nor a pinned block_k
        _plan(64, 2048, 3072, num_bufs=4, block_k=256, smem_budget=100_000)


# (M, K, N, block_k, grid): runs that cross tiles and tiles split over
# several CTAs, at ragged M, K and N
# (tiles m-tiles x n-tiles of block_m rows, x k-steps, on the grid)
SPLITS = [(5, 600, 260, 64, 7),      # 2 x 5 tiles of 4 rows x 10 on 7
          (20, 600, 130, 128, 7),    # 5 x 3 of 4 rows x 5 on 7
          (37, 1024, 200, 32, 9),    # 1 x 4 of 64 rows x 32 on 9
          (70, 500, 100, 256, 5),    # 18 x 2 of 4 rows x 2 on 5
          (130, 2100, 64, 256, 5)]   # 9 x 1 of 16 rows x 9 on 5


def _split_plan(M, K, N, bk, grid):
    plan = _plan(M, K, N, block_k=bk, grid=grid)
    assert plan.grid == grid and plan.max_segs >= 2
    # some CTA's run crosses a tile boundary, and some tile is split
    assert any(len({plan.unit(u)[0] for u in plan.cta_units(i)}) > 1
               for i in range(grid))
    assert any(len(plan.segments(tl)) > 1 for tl in range(plan.tiles))
    return plan


def _inputs(M, K, N, seed, int8=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    if int8:
        w = rng.integers(-127, 128, (K, N)).astype(np.int8)
    else:
        w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    s = (rng.random(N) * (2e-3 if int8 else 2) + 0.5e-3).astype(np.float32)
    return x, w, b, s


def _jax(x, w, b, s, act):
    return jgm.gpp_matmul(jnp.asarray(x), jnp.asarray(w),
                          bias=None if b is None else jnp.asarray(b),
                          w_scale=None if s is None else jnp.asarray(s),
                          activation=act, interpret=True)


@pytest.mark.parametrize("int8", (False, True))
@pytest.mark.parametrize("case", SPLITS)
def test_split_replay_matches_jax_f32(case, int8):
    plan = _split_plan(*case)
    M, K, N = case[:3]
    x, w, b, s = _inputs(M, K, N, 0, int8)
    want = _jax(x, w, b, s, "silu")
    got = dense_split_ref(t(x), t(w), plan, bias=t(b), w_scale=t(s),
                          activation="silu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(want), **F32)


@pytest.mark.parametrize("act", [a for a in ACTIVATION_IDS])
def test_split_replay_epilogue(act):
    # every activation after bias and per-column scale, on a split plan;
    # and the split sums to the unsplit plain version
    plan = _split_plan(*SPLITS[0])
    M, K, N = SPLITS[0][:3]
    x, w, b, s = _inputs(M, K, N, 2)
    got = dense_split_ref(t(x), t(w), plan, bias=t(b), w_scale=t(s),
                          activation=act)
    np.testing.assert_allclose(np32(got), np32(_jax(x, w, b, s, act)), **F32)
    np.testing.assert_allclose(
        np32(got), np32(dense_ref(t(x), t(w), bias=t(b), w_scale=t(s),
                                  activation=act)), **F32)


@pytest.mark.parametrize("M", tuple(PHASE_M.values()))
def test_router_replay_matches_jax(M):
    # the router as planned (32 segments of one tile), with its weight in
    # the stored bf16 that the kernel widens: JAX's kernel widens the same
    x, w, _, _ = _inputs(M, *ROUTER, 3)
    wb = jnp.asarray(w, jnp.bfloat16)
    want = jgm.gpp_matmul(jnp.asarray(x), wb, interpret=True)
    plan = _plan(M, *ROUTER, w_itemsize=2)
    got = dense_split_ref(t(x), t(wb), plan)
    np.testing.assert_allclose(np32(got), np32(want), **F32)


@pytest.mark.parametrize("G", (None, 1, 2, 3, 4))
@pytest.mark.parametrize("shape", [(4, *ROUTER), (4, 1024, 2816),
                                   (32, 10944, 2048), (20, 2048, 3072)]
                         + [s[:3] for s in SPLITS[:2]])
def test_cta0_replay_is_the_chunk_schedule(shape, G):
    plan = _plan(*shape, num_bufs=G)
    S, Gp, C = plan.cta_steps(0), plan.num_bufs, plan.chunks
    order, _, chunk_groups, landed = ring_replay(S, Gp, C)
    assert order == chunk_issue_schedule(S, Gp, C)
    assert order == jgm.chunk_issue_schedule(S, Gp, C)
    for s in range(S):        # every W chunk of step s landed at its wait
        assert all(g < landed[s] for g in chunk_groups[s])


def test_issue_record_run_crosses_tile_and_split_boundaries():
    # the card test's pinned grid (tests/test_torch_cuda.py): 3 n-tiles on
    # 2 CTAs, so CTA 0 walks all of tile 0 and half of tile 1, which CTA 1
    # finishes
    plan = _plan(4, 512, 192, grid=2)
    nk = plan.num_k
    assert [plan.unit(u) for u in plan.cta_units(0)] == \
        [(0, k) for k in range(nk)] + [(1, k) for k in range(nk // 2)]
    assert list(plan.segments(1)) == [0, 1]


def test_launch_plan_is_cached_per_shape():
    # the wrapper plans a shape once a process, on the route's planner
    gm._fma_plan.cache_clear()
    a = gm._plan("fma", 4, *ROUTER, 2, None)
    assert gm._plan("fma", 4, *ROUTER, 2, None) is a
    assert a == _plan(4, *ROUTER, w_itemsize=2)
    assert gm._plan("tc", 4, 1024, 2816, 2, None) == \
        sched.plan_matmul_tc_sm90(4, 1024, 2816)
