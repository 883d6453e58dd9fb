"""The FMA route of the port's `gpp_matmul_grouped` (split-K over the expert
axis), and the f32 logits head on the FMA route of `gpp_matmul`, on the CPU.

The kernel (`gpp_matmul_grouped_kernel`, the body of csrc/gpp_matmul.cuh
that `gpp_matmul_kernel` runs at E = 1) runs only on the card
(tests/test_torch_cuda.py); what surrounds it is plain Python and is
checked here:
  * `core.schedule.plan_matmul_fma_sm90` with E experts at every f32 shape
    of deepseek-v2-lite-16b's routed experts (64 experts; 32 rows an expert
    at decode and verify, 128 at prefill; gate / up 2048 x 1408, down 1408
    x 2048), at ragged shapes, at E = 1 and at one n-tile an expert: every
    (m-tile, expert, n-tile, k-step) unit walked once, runs balanced to
    within one unit, m-tiles of P0 <= 132 CTAs cut alike, the ring in the
    shared memory, two CTAs an SM wherever the grid is more than 132;
  * block_k, P0 and the k-cuts are the same at 1-128 rows an expert and for
    f32, bf16 and int8 W, and at E = 1 the plan is the one-product plan of
    every path shape as it stood before the expert axis (deepseek's router,
    the f32 projections and both models' logits heads);
  * `kernels.ref.dense_grouped_split_ref` — the plain replay of the walk and
    its fixed-order fix-up — against the JAX package's `gpp_matmul_grouped`
    in Pallas interpret mode on the same numpy inputs at f32 (1e-5 +
    1e-5 |ref|): runs that cross expert boundaries, split tiles, int8 W with
    each w_scale form, bias and every activation;
  * a transliteration of the ring's step loop over CTA 0's planned run
    issues exactly `chunk_issue_schedule`;
  * the logits head's split at its K and N (qwen1.5-0.5b's tied 151936 x
    1024 table, deepseek-v2-lite-16b's 102400 x 2048 one): the replay gives
    a row the same bits at 1, 4, 20 and 32 rows.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gpp_matmul as jgm
from repro_torch.core import schedule as sched
from repro_torch.kernels import gpp_matmul as gm
from repro_torch.kernels.ref import (ACTIVATION_IDS, chunk_issue_schedule,
                                     dense_grouped_ref,
                                     dense_grouped_split_ref, dense_split_ref)

from _torch_parity import np32, ring_replay, t, walk_checks

pytestmark = pytest.mark.tier1

F32 = dict(rtol=1e-5, atol=1e-5)

# (E, M, K, N): deepseek-v2-lite-16b's routed experts (decode / verify gate
# and up, down; prefill gate and up, down), then ragged shapes, one product,
# and one n-tile an expert with more experts than CTAs
PATH_SHAPES = [(64, 32, 2048, 1408), (64, 32, 1408, 2048),
               (64, 128, 2048, 1408), (64, 128, 1408, 2048)]
RAGGED_SHAPES = [(64, 7, 300, 130), (5, 7, 300, 130), (3, 200, 256, 256),
                 (2, 33, 999, 1001)]
ONE_SHAPES = [(1, 4, 2048, 64), (1, 32, 2048, 1408)]
MANY_EXPERTS = (600, 16, 512, 64)
SHAPES = PATH_SHAPES + RAGGED_SHAPES + ONE_SHAPES + [MANY_EXPERTS]

# the one-product plan of every FMA path shape before the expert axis
# (E = 1), (K, N) -> {M: (block_m, block_k, num_bufs, grid)}: deepseek's
# router, the f32 projections of both models, and both logits heads
ONE_PRODUCT_PLANS = {
    (1024, 1024): {1: (4, 128, 1, 128), 4: (4, 128, 1, 128),
                   20: (32, 128, 1, 128), 32: (32, 128, 1, 128)},
    (1024, 2816): {1: (4, 128, 2, 132), 4: (4, 128, 2, 132),
                   20: (32, 128, 2, 132), 32: (32, 128, 2, 132)},
    (2816, 1024): {1: (4, 128, 2, 132), 4: (4, 128, 2, 132),
                   20: (32, 128, 2, 132), 32: (32, 128, 2, 132)},
    (2048, 3072): {1: (4, 256, 2, 132), 4: (4, 256, 2, 132),
                   20: (32, 256, 2, 132), 32: (32, 256, 2, 132)},
    (2048, 576): {1: (4, 256, 1, 72), 4: (4, 256, 1, 72),
                  20: (32, 256, 1, 72), 32: (32, 256, 1, 72)},
    (2048, 2048): {1: (4, 256, 2, 132), 4: (4, 256, 2, 132),
                   20: (32, 256, 2, 132), 32: (32, 256, 2, 132)},
    (2048, 64): {1: (4, 64, 1, 32), 4: (4, 64, 1, 32), 20: (8, 64, 1, 96),
                 32: (8, 64, 1, 128)},
    (2048, 2816): {1: (4, 256, 2, 132), 4: (4, 256, 2, 132),
                   20: (32, 256, 2, 132), 32: (32, 256, 2, 132)},
    (2816, 2048): {1: (4, 256, 2, 132), 4: (4, 256, 2, 132),
                   20: (32, 256, 2, 132), 32: (32, 256, 2, 132)},
    (2048, 10944): {1: (4, 256, 2, 132), 4: (4, 256, 2, 132),
                    20: (32, 256, 2, 132), 32: (32, 256, 2, 132)},
    (10944, 2048): {1: (4, 256, 2, 132), 4: (4, 256, 2, 132),
                    20: (32, 256, 2, 132), 32: (32, 256, 2, 132)},
    (1024, 151936): {1: (4, 256, 2, 132), 4: (4, 256, 2, 132),
                     20: (32, 256, 2, 132), 32: (32, 256, 2, 132)},
    (2048, 102400): {1: (4, 256, 2, 132), 4: (4, 256, 2, 132),
                     20: (32, 256, 2, 132), 32: (32, 256, 2, 132)},
}
HEADS = {"qwen1.5-0.5b": (1024, 151936), "deepseek-v2-lite-16b": (2048,
                                                                  102400)}


def _plan(E, M, K, N, w_itemsize=4, **kw):
    return sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=w_itemsize, E=E,
                                      **kw)


@pytest.mark.parametrize("shape", SHAPES)
def test_units_walked_once_in_balanced_runs(shape):
    E, M, K, N = shape
    plan = _plan(*shape)
    assert (plan.E, plan.block_n) == (E, 64)
    assert plan.block_k in sched.GPP_FMA_BLOCK_KS
    # P0 CTAs an m-tile, at most one an SM for one product and two for
    # experts (which then fit two an SM); m_tiles x P0 CTAs in all
    slots = sched.H100_SMS * (2 if E > 1 else 1)
    P0 = plan.grid // plan.m_tiles
    assert plan.grid == plan.m_tiles * P0 <= plan.units
    assert P0 == min(E * plan.n_tiles * plan.num_k, slots)
    assert P0 <= sched.H100_SMS * plan.ctas_per_sm
    assert plan.block_m in (4, 8, 16, 32, 64)
    assert plan.block_m == 4 or -(-M // (plan.block_m // 2)) * P0 > slots
    # tiles: the m-tile outermost, then the expert, the n-tile inner
    assert [(plan.tile(tl)[1], plan.expert(tl), plan.tile(tl)[0])
            for tl in range(plan.tiles)] == \
        [(m, e, n) for m in range(plan.m_tiles) for e in range(E)
         for n in range(plan.n_tiles)]
    assert plan.smem_bytes == sched.matmul_fma_smem_bytes(
        plan.block_m, plan.block_k, plan.num_bufs, 4)
    assert plan.smem_bytes <= sched.SMEM_BUDGET_BYTES
    assert plan.num_bufs <= min(sched.GPP_MM_TC_MAX_RING,
                                max(plan.cta_steps(i)
                                    for i in range(plan.grid)))
    assert plan.chunks == max(1, min(plan.num_bufs - 1, plan.block_k))
    walk_checks(plan)
    assert plan.workspace_floats == (0 if plan.max_segs == 1 else
                                     2 * plan.grid * plan.block_m * 64)


def test_plan_at_the_path_shapes():
    # decode / verify (32 rows an expert): one m-tile of 32 rows on 264
    # CTAs, two an SM, 128-row f32 steps on a ring of 2, ~85 steps a run,
    # every tile in at most two segments; 80 KB of shared memory
    for K, N in ((2048, 1408), (1408, 2048)):
        p = _plan(64, 32, K, N)
        assert (p.block_m, p.block_k, p.num_bufs, p.grid) == (32, 128, 2, 264)
        assert (p.max_segs, p.smem_bytes, p.ctas_per_sm) == (2, 81_920, 2)
        assert {p.cta_steps(i) for i in range(p.grid)} == {85, 86}
        # the fix-up slots: 4.3 MB, not one a (tile, segment) (23 MB)
        assert p.workspace_floats * 4 == 2 * 264 * 32 * 64 * 4
    # prefill (128 rows an expert): two m-tiles of 64 rows (W read twice:
    # the launch is bound by its FMAs) of 264 CTAs each
    for K, N in ((2048, 1408), (1408, 2048)):
        p = _plan(64, 128, K, N)
        assert (p.block_m, p.block_k, p.grid, p.m_tiles) == (64, 128, 528, 2)
        assert (p.ctas_per_sm, p.smem_bytes) == (2, 98_304)
    # the grouped route's block_k always fits two CTAs an SM
    for shape in PATH_SHAPES + RAGGED_SHAPES + [MANY_EXPERTS]:
        assert sched.fma_two_ctas(_plan(*shape).block_k)
    assert not sched.fma_two_ctas(256) and sched.fma_two_ctas(128)


@pytest.mark.parametrize("KN", sorted(ONE_PRODUCT_PLANS))
def test_one_expert_is_the_one_product_plan(KN):
    # at E = 1 the plan is the one-product plan each path shape had before
    # the expert axis (so the router's and the heads' rows keep their
    # split), for every W dtype
    K, N = KN
    for M, (bm, bk, G, grid) in ONE_PRODUCT_PLANS[KN].items():
        for isz in (1, 2, 4):
            p = _plan(1, M, K, N, w_itemsize=isz)
            assert (p.block_m, p.block_k, p.num_bufs, p.grid) == \
                (bm, bk, G, grid)
            assert p.smem_bytes == sched.matmul_fma_smem_bytes(bm, bk, G, isz)
            assert p.ctas_per_sm == min(2, sched.SM_SMEM_BYTES // (
                p.smem_bytes + sched.CTA_SMEM_RESERVED))
            assert p == sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=isz)


def _cuts(p, mt):
    """Each tile of m-tile mt: its segments, as the k-steps each walks, in
    segment order."""
    out = []
    for tl in range(p.tiles):
        if p.tile(tl)[1] != mt:
            continue
        out.append([[p.unit(u)[1] for u in p.cta_units(i)
                     if p.unit(u)[0] == tl] for i in p.segments(tl)])
    return out


@pytest.mark.parametrize("shape", PATH_SHAPES + [MANY_EXPERTS,
                                                 (64, 7, 300, 130)])
def test_split_does_not_depend_on_the_rows_or_the_weight_dtype(shape):
    # block_k and the CTAs of an m-tile come from E, K and N alone, and
    # every m-tile is cut alike: at 1-128 rows an expert and every W dtype a
    # row's tile meets the same k-cuts, summed in the same segment order
    E, _, K, N = shape
    ref = _plan(E, 1, K, N)
    ref_cuts = _cuts(ref, 0)
    for M in (1, 8, 32, 100, 128):
        for isz in (1, 2, 4):
            p = _plan(E, M, K, N, w_itemsize=isz)
            assert (p.block_k, p.grid // p.m_tiles) == (ref.block_k,
                                                        ref.grid)
            for mt in range(p.m_tiles):
                assert _cuts(p, mt) == ref_cuts


def test_pins_and_refusals():
    p = _plan(64, 32, 2048, 1408, num_bufs=4)
    assert p.num_bufs == 4 and p.block_k == 128
    walk_checks(p)
    assert _plan(5, 7, 300, 130, block_k=64, grid=7).grid == 7
    small = _plan(2, 4, 64, 64, grid=50)              # cut to the units
    assert small.grid == small.units == 2 * small.num_k
    for kw in (dict(E=0), dict(num_bufs=0), dict(block_k=48), dict(grid=0)):
        with pytest.raises(ValueError):
            sched.plan_matmul_fma_sm90(32, 2048, 1408, w_itemsize=4,
                                       **{"E": 64, **kw})


def test_cta0_run_crosses_expert_boundaries():
    # one n-tile an expert, 4 k-steps of 128 rows each: CTA 0's 9 steps
    # walk experts 0 and 1 whole and expert 2's first k-step, which CTA 1
    # continues
    p = _plan(*MANY_EXPERTS)
    assert (p.block_k, p.num_k, p.grid) == (128, 4, 264)
    tiles = [p.unit(u) for u in p.cta_units(0)]
    assert [p.expert(tl) for tl, _ in tiles] == [0] * 4 + [1] * 4 + [2]
    assert list(p.segments(2)) == [0, 1]
    # at decode gate / up CTA 0 crosses n-tiles of expert 0
    dec = _plan(64, 32, 2048, 1408)
    assert {dec.expert(dec.unit(u)[0]) for u in dec.cta_units(0)} == {0}
    assert len({dec.unit(u)[0] for u in dec.cta_units(0)}) == 6


@pytest.mark.parametrize("G", (None, 1, 2, 3, 4))
@pytest.mark.parametrize("shape", PATH_SHAPES + [MANY_EXPERTS,
                                                 (5, 7, 300, 130)])
def test_cta0_replay_is_the_chunk_schedule(shape, G):
    plan = _plan(*shape, num_bufs=G)
    S, Gp, C = plan.cta_steps(0), plan.num_bufs, plan.chunks
    order, _, chunk_groups, landed = ring_replay(S, Gp, C)
    assert order == chunk_issue_schedule(S, Gp, C)
    assert order == jgm.chunk_issue_schedule(S, Gp, C)
    for s in range(S):        # every W chunk of step s landed at its wait
        assert all(g < landed[s] for g in chunk_groups[s])


# (E, M, K, N, block_k, grid): runs that cross expert and tile boundaries,
# tiles split over several CTAs, ragged M, K and N
SPLITS = [(5, 7, 300, 130, 64, 7),       # 5 x 3 tiles x 5 k-steps on 7
          (6, 20, 256, 64, 128, 4),      # 6 tiles x 2 k-steps on 4
          (3, 37, 500, 100, 32, 11),     # 3 x 2 tiles of 64 rows x 16 on 11
          (4, 70, 192, 65, 64, 10)]      # 9 x 4 x 2 tiles of 8 rows x 3 on 10


def _split_plan(E, M, K, N, bk, grid):
    plan = _plan(E, M, K, N, block_k=bk, grid=grid)
    assert plan.grid == grid and plan.max_segs >= 2
    # some CTA's run crosses an expert boundary, and some tile is split
    assert any(len({plan.expert(plan.unit(u)[0])
                    for u in plan.cta_units(i)}) > 1 for i in range(grid))
    assert any(len(plan.segments(tl)) > 1 for tl in range(plan.tiles))
    return plan


def _inputs(E, M, K, N, seed, int8=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    if int8:
        w = rng.integers(-127, 128, (E, K, N)).astype(np.int8)
    else:
        w = (rng.standard_normal((E, K, N)) * 0.05).astype(np.float32)
    b = (rng.standard_normal((E, N)) * 0.1).astype(np.float32)
    return x, w, b


def _scale(kind, E, N, seed, int8):
    rng = np.random.default_rng(seed + 100)
    mag = 2e-3 if int8 else 2.0
    shape = {"scalar": (), "expert": (E,), "column": (E, N)}[kind]
    return (rng.random(shape) * mag + 0.5e-3).astype(np.float32)


def _jax(x, w, b, s, act):
    return jgm.gpp_matmul_grouped(
        jnp.asarray(x), jnp.asarray(w),
        bias=None if b is None else jnp.asarray(b),
        w_scale=None if s is None else jnp.asarray(s),
        activation=act, interpret=True)


@pytest.mark.parametrize("scale", ("scalar", "expert", "column"))
@pytest.mark.parametrize("case", SPLITS)
def test_split_replay_matches_jax_int8(case, scale):
    plan = _split_plan(*case)
    E, M, K, N = case[:4]
    x, w, b = _inputs(E, M, K, N, 0, int8=True)
    s = _scale(scale, E, N, 0, True)
    want = _jax(x, w, b, s, "silu")
    got = dense_grouped_split_ref(t(x), t(w), plan, bias=t(b),
                                  w_scale=torch.as_tensor(s),
                                  activation="silu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(want), **F32)


@pytest.mark.parametrize("case", SPLITS)
def test_split_replay_matches_jax_f32(case):
    plan = _split_plan(*case)
    E, M, K, N = case[:4]
    x, w, b = _inputs(E, M, K, N, 1)
    want = _jax(x, w, b, None, "gelu")
    got = dense_grouped_split_ref(t(x), t(w), plan, bias=t(b),
                                  activation="gelu")
    np.testing.assert_allclose(np32(got), np32(want), **F32)


@pytest.mark.parametrize("act", [a for a in ACTIVATION_IDS])
def test_split_replay_epilogue(act):
    # every activation after bias and a per-column scale on a split plan
    # across experts; and the split sums to the unsplit plain version
    plan = _split_plan(*SPLITS[0])
    E, M, K, N = SPLITS[0][:4]
    x, w, b = _inputs(E, M, K, N, 2)
    s = _scale("column", E, N, 2, False)
    got = dense_grouped_split_ref(t(x), t(w), plan, bias=t(b), w_scale=t(s),
                                  activation=act)
    np.testing.assert_allclose(np32(got), np32(_jax(x, w, b, s, act)), **F32)
    np.testing.assert_allclose(
        np32(got), np32(dense_grouped_ref(t(x), t(w), bias=t(b),
                                          w_scale=t(s), activation=act)),
        **F32)


def test_one_expert_replay_is_the_one_product_replay():
    # at E = 1 the grouped replay is `dense_split_ref`'s, bit for bit
    x, w, b = _inputs(1, 20, 600, 130, 3)
    plan = _plan(1, 20, 600, 130, block_k=128, grid=7)
    got = dense_grouped_split_ref(t(x), t(w), plan, bias=t(b),
                                  activation="tanh")
    one = dense_split_ref(t(x[0]), t(w[0]), plan, bias=t(b[0]),
                          activation="tanh")
    assert torch.equal(got[0], one)


@pytest.mark.parametrize("arch", sorted(HEADS))
def test_head_rows_do_not_depend_on_the_batch(arch):
    # the f32 logits head on the FMA route: f32 x against the bf16 (d,
    # vocab) table as stored, planned at its K and N for 1 (prefill's last
    # row), 4 (decode), 20 (verify) and 32 rows; the k-cuts are the same,
    # so the replay gives a row the same bits at each (the kernel's bf16
    # table against its f32 copy is a card test)
    K, N = HEADS[arch]
    g = torch.Generator().manual_seed(5)
    x = torch.randn(32, K, generator=g)
    w = torch.randn(K, N, generator=g, dtype=torch.bfloat16).mul_(0.02)
    rows = {M: dense_split_ref(x[:M], w, sched.plan_matmul_fma_sm90(
        M, K, N, w_itemsize=2)) for M in (1, 4, 20, 32)}
    for M, y in rows.items():
        assert torch.equal(y, rows[32][:M])


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.int8),
    (torch.bfloat16, torch.int8), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_fma_launch_plan(x_dtype, w_dtype):
    # the launch (and the issue-order reader) plan the FMA route with E
    x = torch.empty((64, 32, 2048), dtype=x_dtype, device="meta")
    w = torch.empty((64, 2048, 1408), dtype=w_dtype, device="meta")
    assert gm._plan_grouped(x, w, None) == _plan(
        64, 32, 2048, 1408, w_itemsize=w.element_size())
    assert gm._plan_grouped(x, w, 1).num_bufs == 1
