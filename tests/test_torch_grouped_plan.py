"""The tensor-core route of the port's `gpp_matmul_grouped`, on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py); what
surrounds it is plain Python and is checked here:
  * `core.schedule.plan_grouped_tc_sm90` at the deepseek-v2-lite-16b path's
    shapes (decode and verify: 32 rows an expert; prefill: 128) and ragged
    ones: every (expert, n-tile, m-tile) unit is walked by exactly one CTA,
    runs differ by at most one unit, the grid fills at most ctas_per_sm
    CTAs on each of the 132 SMs, and the ring fits the shared memory that
    many CTAs share;
  * a transliteration of the ring's step loop (`gpp::run_chunk_schedule`,
    csrc/ring.cuh) over CTA 0's planned run issues exactly
    `chunk_issue_schedule` (the JAX package's replay, via its copy in
    `kernels.ref`), and every W chunk and x tile of a step has landed at
    that step's wait;
  * the dtype route: bf16 x and W take the tensor-core kernel, f32 or int8
    the FMA kernel (planned with its expert axis,
    tests/test_torch_grouped_fma_plan.py).
"""
import pytest
import torch

from repro.kernels import gpp_matmul as jgm
from repro_torch.core import schedule as sched
from repro_torch.kernels import gpp_matmul as gm
from repro_torch.kernels.ref import chunk_issue_schedule

from _torch_parity import ring_replay

pytestmark = pytest.mark.tier1

# (E, M, K, N): deepseek-v2-lite-16b decode / verify gate-up and down,
# prefill gate-up and down, then ragged shapes (M over one 128-row tile,
# odd K and N, more units than CTAs so CTA 0 crosses an expert boundary)
PATH_SHAPES = [(64, 32, 2048, 1408), (64, 32, 1408, 2048),
               (64, 128, 2048, 1408), (64, 128, 1408, 2048)]
RAGGED_SHAPES = [(5, 7, 300, 130), (64, 7, 300, 130), (3, 200, 256, 256),
                 (2, 33, 999, 1001), (600, 16, 512, 64)]


@pytest.mark.parametrize("shape", PATH_SHAPES + RAGGED_SHAPES)
def test_units_walked_once_in_balanced_runs(shape):
    E, M, K, N = shape
    plan = sched.plan_grouped_tc_sm90(E, M, K, N)
    assert plan.grid <= plan.ctas_per_sm * sched.H100_SMS
    assert plan.smem_bytes == sched.grouped_tc_smem_bytes(
        plan.block_m, plan.block_k, plan.num_bufs)
    assert plan.smem_bytes <= sched.SMEM_BUDGET_BYTES // plan.ctas_per_sm
    walked = [u for i in range(plan.grid) for u in plan.cta_units(i)]
    assert walked == list(range(plan.units))     # once each, in order
    sizes = {len(plan.cta_units(i)) for i in range(plan.grid)}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # every (expert, n-tile, m-tile) once, expert-major, m-tile innermost
    units = [plan.unit(u) for u in range(plan.units)]
    assert units == [(e, n, m) for e in range(E)
                     for n in range(plan.n_tiles)
                     for m in range(plan.m_tiles)]
    # block_m covers an expert's rows up to 128: W streams once a call
    assert plan.block_m >= min(M, sched.GPP_TC_MAX_BLOCK_M)
    assert plan.m_tiles == -(-M // sched.GPP_TC_MAX_BLOCK_M)


def test_plan_at_the_path_shapes():
    # decode / verify: 32 KB W tiles on a GPP ring of 3, two CTAs an SM
    dec = sched.plan_grouped_tc_sm90(64, 32, 2048, 1408)
    assert (dec.block_m, dec.block_n, dec.block_k) == (32, 128, 128)
    assert (dec.num_bufs, dec.chunks, dec.ctas_per_sm) == (3, 2, 2)
    assert (dec.units, dec.grid, dec.smem_bytes) == (704, 264, 114_688)
    # prefill: the 128-row x tiles take half the room, so 32 KB tiles in
    # situ beat 16 KB tiles on a deeper ring (PERF.md)
    pre = sched.plan_grouped_tc_sm90(64, 128, 1408, 2048)
    assert (pre.block_m, pre.block_k, pre.num_bufs) == (128, 128, 1)
    assert (pre.ctas_per_sm, pre.units, pre.grid) == (2, 1024, 264)
    # each SM keeps at least 50 KB of W in flight
    for p in (dec, pre):
        assert p.ctas_per_sm * p.block_k * p.block_n * 2 >= 50_000


@pytest.mark.parametrize("G", (1, 2, 4, 8))
def test_pinned_ring_is_kept(G):
    for shape in PATH_SHAPES:
        plan = sched.plan_grouped_tc_sm90(*shape, num_bufs=G)
        assert plan.num_bufs == G
        assert plan.chunks == max(1, min(G - 1, plan.block_k))
        assert plan.smem_bytes <= \
            sched.SMEM_BUDGET_BYTES // plan.ctas_per_sm
    # a ring deeper than the steps a CTA walks is clamped to them
    assert sched.plan_grouped_tc_sm90(4, 16, 128, 128,
                                      num_bufs=G).num_bufs == 1


def test_plan_rejects_what_cannot_run():
    with pytest.raises(ValueError):
        sched.plan_grouped_tc_sm90(0, 32, 2048, 1408)
    with pytest.raises(ValueError):
        sched.plan_grouped_tc_sm90(64, 32, 2048, 1408, num_bufs=0)
    with pytest.raises(ValueError):
        sched.plan_grouped_tc_sm90(64, 128, 2048, 1408, num_bufs=4,
                                   smem_budget=60_000)


@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("shape", PATH_SHAPES + RAGGED_SHAPES)
def test_cta0_replay_is_the_chunk_schedule(shape, G):
    plan = sched.plan_grouped_tc_sm90(*shape, num_bufs=G)
    S, Gp, C = plan.cta_steps(0), plan.num_bufs, plan.chunks
    order, x_at, chunk_groups, landed = ring_replay(S, Gp, C)
    assert order == chunk_issue_schedule(S, Gp, C)
    # the JAX package's own replay of the same schedule
    assert order == jgm.chunk_issue_schedule(S, Gp, C)
    for t in range(S):
        # every W chunk of step t and its x tile have landed at its wait;
        # the x tile goes out at most one step ahead, into slot t % 2,
        # whose last reader (step t - 2) has finished by then
        assert all(g < landed[t] for g in chunk_groups[t])
        at, group = x_at[t]
        assert group < landed[t] and t - 1 <= at <= t


def test_cta0_run_crosses_unit_and_expert_boundaries():
    # decode gate/up: CTA 0 walks expert 0's n-tiles 0 and 1 on one ring
    dec = sched.plan_grouped_tc_sm90(64, 32, 2048, 1408)
    assert [dec.unit(u) for u in dec.cta_units(0)] == [(0, 0, 0), (0, 1, 0)]
    assert dec.cta_steps(0) == 2 * dec.num_k == 32
    # one n-tile an expert and more units than CTAs: experts 0 and 1
    many = sched.plan_grouped_tc_sm90(600, 16, 512, 64)
    assert [many.unit(u) for u in many.cta_units(0)] == [(0, 0, 0),
                                                          (1, 0, 0)]


@pytest.mark.parametrize("x_dtype,w_dtype,route", [
    (torch.bfloat16, torch.bfloat16, "tc"),
    (torch.float32, torch.float32, "fma"),
    (torch.float32, torch.int8, "fma"),
    (torch.bfloat16, torch.int8, "fma"),
    (torch.float32, torch.bfloat16, "fma"),
    (torch.bfloat16, torch.float32, "fma"),
])
def test_dtype_route(x_dtype, w_dtype, route):
    assert gm.grouped_route(x_dtype, w_dtype) == route
    # the launch (and the issue-order reader) plan on that route
    x = torch.empty((64, 32, 2048), dtype=x_dtype, device="meta")
    w = torch.empty((64, 2048, 1408), dtype=w_dtype, device="meta")
    launch = gm._plan_grouped(x, w, None)
    if route == "tc":
        assert launch == sched.plan_grouped_tc_sm90(64, 32, 2048, 1408)
    else:
        # the FMA route: the split-K plan with the expert axis
        assert launch == sched.plan_matmul_fma_sm90(
            32, 2048, 1408, w_itemsize=w.element_size(), E=64)
        assert (launch.E, launch.grid, launch.block_k) == (64, 264, 128)
