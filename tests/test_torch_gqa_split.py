"""The tensor-core route of the port's GQA / window paged attention, on the
CPU.

The kernel (`paged_attention_tc_kernel`) runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py); what surrounds it is checked
here:
  * `core.schedule.plan_paged_attn_gqa_tc_sm90` at qwen1.5-0.5b's path
    shapes (decode B=4 S=1, prefill B=1 S=32, verify B=4 S=5; 16 heads, 16
    KV heads, head_dim 64, 8 blocks of 16) and at head_dim 128 and 256:
    every (lane, KV head, row tile, logical block) is walked by exactly one
    run, the cut is the same for any batch and S, and the shared memory
    fits 227 KB at the planned CTAs an SM; the plan rejects what the
    kernel cannot run;
  * the route by dtype, head_dim and block size;
  * a transliteration of the ring's step loop (`gpp::run_chunk_schedule`)
    over one run's live blocks issues exactly `chunk_issue_schedule` (the
    JAX package's replay and the port's copy);
  * a plain torch replay of the split-and-merge
    (`kernels.ref.paged_attn_gqa_split_ref`: the planner's runs, p rounded
    to the KV dtype per run, the merge) against the JAX package's
    `paged_attention(interpret=True)` and its `paged_attn_ref`, on numpy
    inputs from a seed, at head_dim 64, 128 and 256, with and without a
    window, kv_splits 1, 2 and MB;
  * row invariance in that replay: a row at decode and the same row at
    verify (or in a prefill chunk) give equal bits.

Tolerances: float32 2e-5 (the same f32 maths; the merge rescales partials
in another order); bf16 2e-2 (a run rounds p to bf16 against its own max,
not the lane's, and the output is rounded once to bf16).
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
                                     paged_attn_gqa_split_ref)

from _torch_parity import np32, ring_replay, t

pytestmark = pytest.mark.tier1

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# qwen1.5-0.5b's GQA path: (batch, queries a lane); 16 heads, 16 KV heads,
# head_dim 64, 8 blocks of 16 tokens
PATH = {"decode": (4, 1), "prefill": (1, 32), "verify": (4, 5)}
QWEN = dict(kv_heads=16, block_size=16, max_blocks=8, head_dim=64)


def _plan(phase, **kw):
    B, S = PATH[phase]
    args = {**QWEN, **kw}
    rows = 16 // args["kv_heads"] * S
    return sched.plan_paged_attn_gqa_tc_sm90(batch=B, rows=rows, **args)


@pytest.mark.parametrize("kv_splits", (None, 1, 2, 3, 8))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("phase", sorted(PATH))
@pytest.mark.parametrize("hd,kvh", ((64, 16), (128, 4), (256, 8)))
def test_runs_cover_each_block_once(hd, kvh, phase, G, kv_splits):
    plan = _plan(phase, head_dim=hd, kv_heads=kvh, num_bufs=G,
                 kv_splits=kv_splits)
    B, S = PATH[phase]
    assert 1 <= plan.kv_splits <= plan.max_blocks
    assert plan.kv_splits == (kv_splits or 8)
    assert plan.row_tiles * 16 >= 16 // kvh * S
    walked = [(b, h, tl, j) for b in range(B) for h in range(kvh)
              for tl in range(plan.row_tiles)
              for s in range(plan.kv_splits) for j in plan.run(s)]
    assert sorted(walked) == [(b, h, tl, j) for b in range(B)
                              for h in range(kvh)
                              for tl in range(plan.row_tiles)
                              for j in range(plan.max_blocks)]
    sizes = [len(plan.run(s)) for s in range(plan.kv_splits)]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # the kernel's linear CTA index enumerates the grid once
    assert sorted(plan.cta(b, h, tl, s) for b in range(B) for h in range(kvh)
                  for tl in range(plan.row_tiles)
                  for s in range(plan.kv_splits)) == list(range(plan.ctas))
    assert plan.grid == (plan.kv_splits, plan.row_tiles, B * kvh)
    # shared memory: the kernel's layout, within the SM's share
    assert plan.smem_bytes == sched.gqa_tc_smem_bytes(16, hd, plan.num_bufs)
    assert 1 <= plan.ctas_per_sm <= sched.PA_GQA_TC_MAX_CTAS_PER_SM
    assert plan.smem_bytes * plan.ctas_per_sm <= sched.SMEM_BUDGET_BYTES
    assert G is None or plan.num_bufs == min(G, max(sizes))
    assert plan.chunks == max(1, min(plan.num_bufs - 1, 16))
    assert plan.workspace_floats() == (
        0 if plan.kv_splits == 1 else plan.ctas * 16 * (hd + 2))


@pytest.mark.parametrize("max_blocks", (1, 2, 3, 7, 8, 9, 16, 64, 256))
def test_cut_reads_neither_batch_nor_queries(max_blocks):
    # unlike the MLA planner's split (which grows with fewer units), the
    # GQA cut is a function of the table width alone: a row meets the same
    # runs at decode, verify and prefill whatever the batch
    cuts = {(sched.plan_paged_attn_gqa_tc_sm90(
        batch=B, kv_heads=kvh, rows=rows, block_size=bs,
        max_blocks=max_blocks, head_dim=hd).kv_splits)
        for B in (1, 4, 64) for rows in (1, 5, 20, 32, 160)
        for kvh in (1, 16) for bs in (16, 64) for hd in (64, 256)}
    assert cuts == {sched.gqa_tc_splits(max_blocks)}
    assert sched.gqa_tc_splits(max_blocks) == min(max_blocks, 8)


def test_planned_path_plans():
    # qwen: 8 runs of one block at every phase, 512 / 256 / 512 CTAs, the
    # ring clamped to the one-block run (in situ)
    for phase, ctas in (("decode", 512), ("prefill", 256), ("verify", 512)):
        plan = _plan(phase)
        assert (plan.kv_splits, plan.ctas, plan.num_bufs) == (8, ctas, 1)
        assert plan.ctas_per_sm == min(4, -(-ctas // sched.H100_SMS))
    # a long table: 8 runs of 32 blocks, a deep ring shrunk to fit 4 CTAs
    # an SM (10 KB a slot at head_dim 64, 16-token blocks)
    plan = sched.plan_paged_attn_gqa_tc_sm90(
        batch=4, kv_heads=16, rows=1, block_size=16, max_blocks=256,
        head_dim=64)
    assert plan.kv_splits == 8 and plan.num_bufs > 1
    assert plan.smem_bytes * plan.ctas_per_sm <= sched.SMEM_BUDGET_BYTES


def test_plan_rejects_what_cannot_run():
    for kw in (dict(head_dim=96), dict(head_dim=32), dict(head_dim=512),
               dict(block_size=8), dict(block_size=80), dict(block_size=128),
               dict(num_bufs=0), dict(kv_splits=0), dict(kv_splits=9)):
        with pytest.raises(ValueError):
            _plan("decode", **kw)
    with pytest.raises(ValueError):
        sched.plan_paged_attn_gqa_tc_sm90(batch=0, rows=1, **QWEN)
    with pytest.raises(ValueError):            # a pinned ring that cannot fit
        _plan("decode", kv_splits=1, num_bufs=8, block_size=64,
              head_dim=256, smem_budget=100_000)


@pytest.mark.parametrize("hd", (32, 64, 96, 128, 256, 512))
@pytest.mark.parametrize("bs", (8, 16, 32, 48, 64, 128))
def test_route_by_head_dim_and_block_size(bs, hd):
    tc = hd in (64, 128, 256) and bs in (16, 32, 48, 64)
    assert sched.gqa_tc_takes(bs, hd) == tc
    assert pa.attention_route(torch.bfloat16, False, bs, hd, hd) == \
        ("gqa_tc" if tc else "gqa")
    # f32 stays on the FMA kernel at every shape
    assert pa.attention_route(torch.float32, False, bs, hd, hd) == "gqa"


def test_tc_route_raises_on_cpu_tensors():
    q = torch.zeros(1, 1, 16, 64, dtype=torch.bfloat16)
    pools = torch.zeros(3, 16, 16, 64, dtype=torch.bfloat16)
    args = (q, pools, pools, torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(*args, num_kv_heads=16, scale=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_attention(*args, num_kv_heads=16, scale=1.0, kv_splits=2)


@pytest.mark.parametrize("kv_splits", (None, 1, 2, 8))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("window", (None, 32))
@pytest.mark.parametrize("phase", sorted(PATH))
def test_run_replay_is_the_chunk_schedule(phase, window, G, kv_splits):
    # every run of every lane at the path's positions (decode lane 3 at
    # 100: 7 live blocks; a window expires the first ones): a run's live
    # blocks are an interval, and its steps issue the chunk schedule
    B, S = PATH[phase]
    plan = _plan(phase, num_bufs=G, kv_splits=kv_splits)
    positions = {"decode": [5, 17, 40, 100], "prefill": [37],
                 "verify": [3, 30, 64, 90]}[phase]
    live = pa.live_blocks(plan, positions, S, window)
    for b in range(B):
        p = positions[b]
        assert sorted(j for run in live[b] for j in run) == [
            j for j in range(plan.max_blocks) if j * 16 <= p + S - 1
            and not (window and (j + 1) * 16 - 1 <= p - window)]
        for s in range(plan.kv_splits):
            steps = len(live[b][s])
            if steps:
                assert live[b][s] == list(range(live[b][s][0],
                                                live[b][s][0] + steps))
            Gp, C = plan.num_bufs, plan.chunks
            order, _, chunk_groups, landed = ring_replay(steps, Gp, C)
            assert order == chunk_issue_schedule(steps, Gp, C)
            assert order == jgm.chunk_issue_schedule(steps, Gp, C)
            for st in range(steps):
                assert all(g < landed[st] for g in chunk_groups[st])


# (nb, bs, tables, positions, S): 2 lanes, 2 KV heads of 2 query heads each
CASES = {
    # lane 0 in block 0 only, lane 1 in blocks 0-1 of 4: runs of one block
    # are dead (empty partials); the last and first slot of a block
    "decode": (9, 8, [[3, 1, 7, 0], [2, 5, 8, 6]], [7, 8], 1),
    "verify": (9, 8, [[1, 2, 3, 4], [5, 6, 7, 8]], [20, 9], 3),
    "prefill": (9, 8, [[5, 1, 4, 2]], [5], 12),
}
H, KVH = 4, 2


def _inputs(case, hd, dtype, seed=0):
    nb, bs, tables, positions, S = CASES[case]
    rng = np.random.default_rng(seed)
    B = len(tables)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = (rng.standard_normal((nb, bs, KVH, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((nb, bs, KVH, hd)) * 0.3).astype(np.float32)
    arrs = [jnp.asarray(a, dtype) for a in (q, k, v)]
    return (*arrs, jnp.asarray(tables, jnp.int32),
            jnp.asarray(positions, jnp.int32))


@pytest.mark.parametrize("window", (None, 6))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("hd", (64, 128, 256))
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_replay_matches_jax(case, hd, dtype, window):
    jdt = getattr(jnp, dtype)
    args = _inputs(case, hd, jdt, seed=hd + (dtype == "bfloat16"))
    scale = 1.0 / np.sqrt(hd)
    kw = dict(num_kv_heads=KVH, scale=scale, window=window)
    want = j_paged_attention(*args, interpret=True, **kw)
    oracle = jref.paged_attn_ref(*args, **kw)
    tol = F32 if dtype == "float32" else BF16
    MB = args[3].shape[1]
    for ks in (1, 2, MB):
        got = paged_attn_gqa_split_ref(*map(t, args), kv_splits=ks, **kw)
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(np32(got), np32(want), **tol)
        np.testing.assert_allclose(np32(got), np32(oracle), **tol)


@pytest.mark.parametrize("window", (None, 5))
@pytest.mark.parametrize("kvh", (1, 2, 4))
def test_a_row_has_the_same_bits_at_decode_and_verify(kvh, window):
    # a token at position p: one row of a decode step at p, row s of a
    # verify step from p - s, row s of a longer prefill chunk; spans
    # inside a block and across into the next, dead and window-expired
    # blocks in some runs
    rng = np.random.default_rng(kvh)
    nb, bs, MB, hd, S = 17, 4, 8, 64, 5
    B = 2
    q = torch.tensor(rng.standard_normal((B, S, H, hd)),
                     dtype=torch.float32).bfloat16()
    k = torch.tensor(rng.standard_normal((nb, bs, kvh, hd)) * 0.5,
                     dtype=torch.float32).bfloat16()
    v = torch.tensor(rng.standard_normal((nb, bs, kvh, hd)) * 0.5,
                     dtype=torch.float32).bfloat16()
    tables = torch.tensor(rng.permutation(np.arange(1, nb))[:B * MB]
                          .reshape(B, MB), dtype=torch.int32)
    ks = sched.gqa_tc_splits(MB)
    kw = dict(num_kv_heads=kvh, scale=0.125, kv_splits=ks, window=window)
    for start in ([2, 9], [11, 20]):
        p0 = torch.tensor(start, dtype=torch.int32)
        ver = paged_attn_gqa_split_ref(q, k, v, tables, p0, **kw)
        for s in range(S):
            dec = paged_attn_gqa_split_ref(q[:, s:s + 1], k, v, tables,
                                           p0 + s, **kw)
            assert torch.equal(dec[:, 0], ver[:, s])
        # a prefill chunk of lane 0 from p0[0], 10 rows long: its first 5
        # rows are verify's lane 0 rows (more rows, more live blocks)
        chunk = torch.cat([q[:1], q[1:]], dim=1)
        pre = paged_attn_gqa_split_ref(chunk, k, v, tables[:1], p0[:1],
                                       **kw)
        assert torch.equal(pre[0, :S], ver[0])
