"""The tensor-core route of the port's MLA paged attention, on the CPU.

The kernel (`paged_attention_mla_tc_kernel`) runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py); what surrounds it is checked
here:
  * `core.schedule.plan_paged_attn_mla_tc_sm90` at the deepseek-v2-lite-16b
    path's shapes (decode B=4 S=1, prefill B=1 S=32, verify B=4 S=5; 16
    heads, 8 blocks of 16, latent 512 + rope 64): every (lane, row tile,
    logical block) is walked by exactly one run, kv_splits lies in [1, MB],
    and the shared memory fits 227 KB at the planned CTAs an SM;
  * a transliteration of the ring's step loop (`gpp::run_chunk_schedule`)
    over one run's live blocks issues exactly `chunk_issue_schedule` (the
    JAX package's replay and the port's copy), every chunk landed by its
    step's wait;
  * a plain torch replay of the split-and-merge
    (`kernels.ref.paged_attn_mla_split_ref`: the planner's runs, p rounded
    to the KV dtype per run, the merge) against the JAX package's
    `paged_attention(mla=True, interpret=True)` and its `paged_attn_ref`, on
    numpy inputs from a seed: empty runs, positions on block edges, S > 1,
    a window, kv_splits in {1, 2, MB};
  * the route: bf16 MLA takes the tensor-core kernel, f32 MLA the FMA one,
    and a CPU tensor raises.

Tolerances: float32 1e-5 (the same f32 maths; the merge rescales partials
in another order); bf16 2e-2 (a split rounds p to bf16 against its run's
max, not the lane's, and the output is rounded once to bf16).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import gpp_matmul as jgm
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as j_paged_attention
from repro_torch.core import schedule as sched
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import (chunk_issue_schedule,
                                     paged_attn_mla_split_ref)

from _torch_parity import np32, ring_replay, t

pytestmark = pytest.mark.tier1

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# deepseek-v2-lite-16b's MLA path: (batch, queries a lane); 16 heads, 8
# blocks of 16 tokens, latent 512 + rope 64
PATH = {"decode": (4, 1), "prefill": (1, 32), "verify": (4, 5)}
DS = dict(block_size=16, max_blocks=8, latent=512, rope=64)


def _plan(phase, **kw):
    B, S = PATH[phase]
    return sched.plan_paged_attn_mla_tc_sm90(batch=B, rows=16 * S,
                                             **{**DS, **kw})


@pytest.mark.parametrize("kv_splits", (None, 1, 2, 3, 8))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("phase", sorted(PATH))
def test_runs_cover_each_block_once(phase, G, kv_splits):
    plan = _plan(phase, num_bufs=G, kv_splits=kv_splits)
    B, S = PATH[phase]
    assert 1 <= plan.kv_splits <= plan.max_blocks
    assert kv_splits is None or plan.kv_splits == kv_splits
    assert plan.row_tiles * 16 >= 16 * S
    walked = [(b, tl, j) for b in range(B) for tl in range(plan.row_tiles)
              for s in range(plan.kv_splits) for j in plan.run(s)]
    assert sorted(walked) == [(b, tl, j) for b in range(B)
                              for tl in range(plan.row_tiles)
                              for j in range(plan.max_blocks)]
    sizes = [len(plan.run(s)) for s in range(plan.kv_splits)]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # the kernel's linear CTA index enumerates the grid once
    assert sorted(plan.cta(b, tl, s) for b in range(B)
                  for tl in range(plan.row_tiles)
                  for s in range(plan.kv_splits)) == list(range(plan.ctas))
    # shared memory: the kernel's layout, within the SM's share
    assert plan.smem_bytes == sched.mla_tc_smem_bytes(
        16, 512, 64, plan.num_bufs, plan.warps)
    assert 1 <= plan.ctas_per_sm <= sched.PA_MLA_TC_MAX_CTAS_PER_SM
    assert plan.smem_bytes * plan.ctas_per_sm <= sched.SMEM_BUDGET_BYTES
    assert G is None or plan.num_bufs == min(G, max(sizes))
    assert plan.chunks == max(1, min(plan.num_bufs - 1, 16))
    assert plan.workspace_floats(512) == (
        0 if plan.kv_splits == 1 else plan.ctas * 16 * 514)


def test_planned_splits_fill_the_sms():
    # as many runs as the blocks allow toward two CTAs an SM: every path
    # phase splits into its 8 blocks (32 / 256 / 160 CTAs)
    for phase, ctas in (("decode", 32), ("prefill", 256), ("verify", 160)):
        plan = _plan(phase)
        assert (plan.kv_splits, plan.ctas) == (8, ctas)
        assert plan.ctas_per_sm == min(2, -(-ctas // sched.H100_SMS))
        # the ring holds the longest run: all of a run's blocks in flight
        assert plan.num_bufs == max(len(plan.run(s))
                                    for s in range(plan.kv_splits)) == 1
    # fewer blocks than CTAs wanted: one run a block; many units: none
    wide = sched.plan_paged_attn_mla_tc_sm90(
        batch=64, rows=80, block_size=16, max_blocks=8, latent=512,
        rope=64)
    assert (wide.kv_splits, wide.workspace_floats(512)) == (1, 0)
    assert sched.plan_paged_attn_mla_tc_sm90(
        batch=2, rows=16, block_size=16, max_blocks=256, latent=512,
        rope=64).kv_splits == 132
    # key rows are whole 128-byte swizzle groups, unpadded at 512 + 64
    assert sched.mla_tc_row_bytes(512, 64) == 1152
    assert sched.mla_tc_row_bytes(32, 8) == 384


def test_plan_rejects_what_cannot_run():
    for kw in (dict(block_size=8), dict(block_size=80), dict(latent=520),
               dict(latent=36), dict(rope=4), dict(num_bufs=0),
               dict(kv_splits=0), dict(kv_splits=9), dict(warps=6)):
        with pytest.raises(ValueError):
            _plan("decode", **kw)
    with pytest.raises(ValueError):            # a pinned ring that cannot fit
        _plan("prefill", kv_splits=1, num_bufs=8, smem_budget=100_000)


@pytest.mark.parametrize("kv_splits", (None, 1, 2, 8))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("phase", sorted(PATH))
def test_run_replay_is_the_chunk_schedule(phase, G, kv_splits):
    # every run of lane 3 at decode positions (100: 7 live blocks), the
    # prefill lane from 37, the verify lanes from 90 (a run's live blocks
    # are its steps)
    B, S = PATH[phase]
    plan = _plan(phase, num_bufs=G, kv_splits=kv_splits)
    positions = {"decode": [5, 17, 40, 100], "prefill": [37],
                 "verify": [3, 30, 64, 90]}[phase]
    live = pa.mla_live_blocks(plan, positions, S)
    for b in range(B):
        for s in range(plan.kv_splits):
            steps = len(live[b][s])
            assert live[b][s] == list(range(live[b][s][0],
                                            live[b][s][0] + steps)) \
                if steps else True              # an interval of the run
            Gp, C = plan.num_bufs, plan.chunks
            order, _, chunk_groups, landed = ring_replay(steps, Gp, C)
            assert order == chunk_issue_schedule(steps, Gp, C)
            assert order == jgm.chunk_issue_schedule(steps, Gp, C)
            for st in range(steps):
                assert all(g < landed[st] for g in chunk_groups[st])


def _inputs(case, dtype, seed=0):
    nb, bs, tables, positions, S = CASES[case]
    rng = np.random.default_rng(seed)
    B = len(tables)
    q = rng.standard_normal((B, S, 4, R + RR)).astype(np.float32)
    ckv = (rng.standard_normal((nb, bs, R)) * 0.3).astype(np.float32)
    kr = (rng.standard_normal((nb, bs, RR)) * 0.3).astype(np.float32)
    arrs = [jnp.asarray(a, dtype) for a in (q, ckv, kr)]
    return (*arrs, jnp.asarray(tables, jnp.int32),
            jnp.asarray(positions, jnp.int32))


R, RR = 32, 8                                   # latent, rope (small)
CASES = {
    # name: (nb, bs, tables, positions, S)
    # lane 0 lives in block 0 and lane 1 in blocks 0-1 of 6: at kv_splits
    # 2 and MB whole runs are dead (empty partials)
    "empty_runs": (13, 4, [[3, 1, 7, 0, 0, 0], [2, 9, 0, 0, 0, 0]],
                   [2, 5], 1),
    # last and first slot of a block, the last block full
    "block_edges": (17, 8, [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12],
                            [13, 14, 15, 16]], [7, 8, 15, 31], 1),
    "verify": (9, 8, [[1, 2, 3, 4], [5, 6, 7, 0]], [20, 9], 3),
    "prefill": (9, 16, [[5, 1, 4, 2]], [13], 16),
}


@pytest.mark.parametrize("kv_splits", ("one", "two", "MB"))
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_replay_matches_jax_f32(case, kv_splits):
    args = _inputs(case, jnp.float32)
    MB = args[3].shape[1]
    ks = {"one": 1, "two": 2, "MB": MB}[kv_splits]
    kw = dict(num_kv_heads=1, scale=0.2, mla=True)
    want = j_paged_attention(*args, interpret=True, **kw)
    got = paged_attn_mla_split_ref(*map(t, args), scale=0.2, kv_splits=ks)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(np32(got), np32(want), **F32)
    np.testing.assert_allclose(np32(got), np32(jref.paged_attn_ref(
        *args, **kw)), **F32)


@pytest.mark.parametrize("kv_splits", ("one", "two", "MB"))
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_replay_matches_jax_bf16(case, kv_splits):
    args = _inputs(case, jnp.bfloat16, seed=1)
    MB = args[3].shape[1]
    ks = {"one": 1, "two": 2, "MB": MB}[kv_splits]
    kw = dict(num_kv_heads=1, scale=0.2, mla=True)
    want = j_paged_attention(*args, interpret=True, **kw)
    got = paged_attn_mla_split_ref(*map(t, args), scale=0.2, kv_splits=ks)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), **BF16)
    np.testing.assert_allclose(np32(got), np32(jref.paged_attn_ref(
        *args, **kw)), **BF16)


@pytest.mark.parametrize("kv_splits", (1, 2, 4))
def test_split_replay_with_a_window(kv_splits):
    # blocks expired behind a 10-token window are dead in some runs
    args = _inputs("block_edges", jnp.float32, seed=2)
    kw = dict(num_kv_heads=1, scale=0.2, mla=True, window=10)
    want = j_paged_attention(*args, interpret=True, **kw)
    got = paged_attn_mla_split_ref(*map(t, args), scale=0.2,
                                   kv_splits=kv_splits, window=10)
    np.testing.assert_allclose(np32(got), np32(want), **F32)


def test_empty_runs_really_are_empty():
    # the case's premise: lane 0 (position 2, 4-token blocks) lives in
    # block 0 only and lane 1 (position 5) in blocks 0-1, so at kv_splits
    # 2 and MB whole runs hold no live block
    nb, bs, tables, positions, S = CASES["empty_runs"]
    MB = len(tables[0])
    for ks, want in ((2, [[1, 0], [2, 0]]),
                     (MB, [[1, 0, 0, 0, 0, 0], [1, 1, 0, 0, 0, 0]])):
        got = [[sum(j * bs <= p + S - 1 for j in run)
                for run in sched.kv_runs(MB, ks)] for p in positions]
        assert got == want


@pytest.mark.parametrize("dtype,mla,route", [
    (torch.bfloat16, True, "mla_tc"), (torch.float32, True, "mla"),
    (torch.bfloat16, False, "gqa"), (torch.float32, False, "gqa")])
def test_route(dtype, mla, route):
    # deepseek's pools: 16-token blocks of latent 512 + rope 64
    assert pa.attention_route(dtype, mla, 16, R, RR) == route
    # no kernel for a CPU tensor, on any route
    q = torch.zeros(1, 1, 16, R + RR if mla else 64, dtype=dtype)
    if mla:
        pools = (torch.zeros(3, 16, R, dtype=dtype),
                 torch.zeros(3, 16, RR, dtype=dtype))
    else:
        pools = (torch.zeros(3, 16, 16, 64, dtype=dtype),) * 2
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(q, *pools, torch.zeros(1, 2, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32),
                           num_kv_heads=16, scale=1.0, mla=mla)


LAT, ROPE = DS["latent"], DS["rope"]


@pytest.mark.parametrize("block_size,bf16,f32", [
    (8, "mla", "mla"), (16, "mla_tc", "mla"), (64, "mla_tc", "mla"),
    (128, "mla", None), (256, None, None)])
def test_route_by_block_size(block_size, bf16, f32):
    # deepseek's widths; bf16 takes the tensor-core kernel where its plan can (blocks of 16-64
    # tokens) and the FMA kernel's bf16 instance elsewhere; a shape neither
    # kernel's shared memory holds raises, naming the block size (None)
    for dtype, want in ((torch.bfloat16, bf16), (torch.float32, f32)):
        if want is None:
            with pytest.raises(ValueError, match=f"{block_size}-token"):
                pa.attention_route(dtype, True, block_size, LAT, ROPE)
            continue
        assert pa.attention_route(dtype, True, block_size, LAT, ROPE) == want
        # the route's kernel plans this shape (a pure function of it)
        if want == "mla_tc":
            sched.plan_paged_attn_mla_tc_sm90(
                batch=4, rows=16, block_size=block_size, max_blocks=2,
                latent=LAT, rope=ROPE)
        else:
            sched.plan_paged_attn_sm90(
                rows=16, block_size=block_size, head_dim=LAT, rope_dim=ROPE,
                kv_itemsize=dtype.itemsize, max_blocks=2)
    # the GQA route does not read the widths
    assert pa.attention_route(torch.bfloat16, False, 256, 64, 64) == "gqa"
    # at block size 128 the FMA kernel's bf16 ring fills all but 2,880 of
    # the 232,448 bytes (one block in situ, 16 query rows)
    assert sched.paged_attn_smem_bytes(1, 128, LAT, 2, 16, ROPE) == 229_568
