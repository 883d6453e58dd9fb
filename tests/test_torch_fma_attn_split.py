"""The FMA route of the port's paged attention (GQA / window and MLA), on
the CPU.

The kernels (`paged_attention_kernel`, `paged_attention_mla_kernel`) run
only on the card (tests/test_torch_cuda.py, chip_smoke.py); what surrounds
them is checked here:
  * `core.schedule.plan_paged_attn_fma_sm90`: a lane's keys cut into
    pieces of P tokens and the pieces into runs, every (lane, KV head, row
    tile, piece) walked by exactly one run; P and the runs the same for any
    batch, S and positions; the shared memory the kernel's layout and
    within 232,448 bytes at block sizes 8-256, in f32 and bf16, at
    deepseek's MLA widths (512 + 64) and GQA head_dim 64 / 128 / 256; the
    plan rejects, naming the shape, what the kernel cannot run;
  * a transliteration of the ring's step loop (`gpp::run_chunk_schedule`)
    over one run's live pieces issues exactly `chunk_issue_schedule` (the
    JAX package's replay and the port's copy);
  * a plain torch replay of the split walk and merge
    (`kernels.ref.paged_attn_fma_split_ref`: pieces, the planner's runs, p
    rounded to the KV dtype per run, the merge) against the JAX package's
    `paged_attention(..., interpret=True)` and its `paged_attn_ref`, on
    numpy inputs from a seed: MLA and GQA, a window, empty runs, a block
    larger than its piece;
  * a row's bits in that replay at decode (S = 1) and verify (S = 5).

Tolerances: float32 2e-4 (the same f32 maths; the merge rescales partials
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
                                     paged_attn_fma_split_ref)

from _torch_parity import np32, ring_replay, t

pytestmark = pytest.mark.tier1

F32 = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)

# the paths' step shapes: (batch, queries a lane)
PATH = {"decode": (4, 1), "prefill": (1, 32), "verify": (4, 5)}
POSITIONS = {"decode": [5, 17, 40, 100], "prefill": [37],
             "verify": [3, 30, 64, 90]}
# (name, kv_heads, rows a query, width, rope, mla): deepseek's latent pools
# (16 heads on one shared head), qwen's GQA and head_dim 128 / 256
FORMS = {"mla": (1, 16, 512, 64, True), "gqa64": (16, 1, 64, 0, False),
         "gqa128": (4, 4, 128, 0, False), "gqa256": (8, 2, 256, 0, False)}


def _plan(form, phase, es, *, block_size=16, max_len=128, **kw):
    kvh, rep, width, rope, mla = FORMS[form]
    B, S = PATH[phase]
    return sched.plan_paged_attn_fma_sm90(
        batch=B, kv_heads=kvh, rows=rep * S, block_size=block_size,
        max_blocks=max(1, max_len // block_size), width=width, rope=rope,
        mla=mla, kv_itemsize=es, **kw)


@pytest.mark.parametrize("kv_splits", (None, 1, 3))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("phase", sorted(PATH))
@pytest.mark.parametrize("form,es", [("mla", 4), ("mla", 2), ("gqa64", 4),
                                     ("gqa256", 4)])
def test_runs_cover_each_piece_once(form, es, phase, G, kv_splits):
    plan = _plan(form, phase, es, num_bufs=G, kv_splits=kv_splits)
    kvh, rep, width, rope, mla = FORMS[form]
    B, S = PATH[phase]
    assert plan.pieces == plan.max_blocks * plan.block_size // plan.piece
    assert 1 <= plan.kv_splits <= plan.pieces
    assert plan.kv_splits == (kv_splits or sched.fma_splits(plan.pieces))
    assert plan.row_tiles * 16 >= rep * S
    walked = [(b, h, tl, i) for b in range(B) for h in range(kvh)
              for tl in range(plan.row_tiles)
              for s in range(plan.kv_splits) for i in plan.run(s)]
    assert sorted(walked) == [(b, h, tl, i) for b in range(B)
                              for h in range(kvh)
                              for tl in range(plan.row_tiles)
                              for i in range(plan.pieces)]
    sizes = [len(plan.run(s)) for s in range(plan.kv_splits)]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    # the kernel's linear CTA index enumerates the grid once
    assert sorted(plan.cta(b, h, tl, s) for b in range(B) for h in range(kvh)
                  for tl in range(plan.row_tiles)
                  for s in range(plan.kv_splits)) == list(range(plan.ctas))
    assert plan.grid == (plan.kv_splits, plan.row_tiles, B * kvh)
    # shared memory: the kernel's layout, within the budget
    assert plan.smem_bytes == sched.paged_attn_fma_smem_bytes(
        plan.piece, width, rope, es, plan.num_bufs, mla)
    assert plan.smem_bytes <= sched.SMEM_BUDGET_BYTES
    assert G is None or plan.num_bufs == G
    assert G is not None or plan.num_bufs <= max(sizes)
    assert plan.chunks == max(1, min(plan.num_bufs - 1, plan.piece))
    assert plan.workspace_floats() == (
        0 if plan.kv_splits == 1 else plan.ctas * 16 * (width + 2))


@pytest.mark.parametrize("form,es", [("mla", 4), ("mla", 2), ("gqa64", 4),
                                     ("gqa128", 2), ("gqa256", 4)])
def test_split_reads_neither_batch_nor_queries(form, es):
    # P, the runs and the ring follow the block size, the table width and
    # the widths alone: a row meets the same pieces and runs at decode,
    # verify and prefill whatever the batch (positions never reach the
    # planner)
    kvh, rep, width, rope, mla = FORMS[form]
    for bs, mb in ((8, 16), (16, 8), (128, 1), (256, 1), (16, 256)):
        cuts = {(p.piece, p.kv_splits, p.num_bufs, p.chunks, p.smem_bytes)
                for p in (sched.plan_paged_attn_fma_sm90(
                    batch=B, kv_heads=kvh, rows=rep * S, block_size=bs,
                    max_blocks=mb, width=width, rope=rope, mla=mla,
                    kv_itemsize=es) for B in (1, 4, 64) for S in (1, 5, 32))}
        assert len(cuts) == 1, (bs, mb, cuts)
        piece, ks = next(iter(cuts))[:2]
        assert ks == sched.fma_splits(mb * bs // piece)


@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("es", (4, 2))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_shared_memory_fits_every_block_size(form, es, G):
    # the repair: every block size the reference serves has a plan, at
    # the planned ring and at G pinned to 1, 2 and 4; the piece divides
    # the block and the kernel's lanes take it (a power of two <= 32)
    kvh, rep, width, rope, mla = FORMS[form]
    for bs in (8, 16, 64, 128, 256):
        plan = _plan(form, "decode", es, block_size=bs,
                     max_len=max(128, bs), num_bufs=G)
        assert plan.smem_bytes <= 232_448
        assert bs % plan.piece == 0
        assert plan.piece in (1, 2, 4, 8, 16, 32)
        assert plan.piece == min(bs, 8 if mla else 16)
        rb = sched.paged_attn_fma_row_bytes(width, rope, es)
        assert rb % 128 == 64 and rb >= (width + rope) * es
    # MLA in f32 at a pinned ring of 6: the piece shrinks until it fits
    big = sched.plan_paged_attn_fma_sm90(
        batch=4, kv_heads=1, rows=16, block_size=128, max_blocks=1,
        width=512, rope=64, mla=True, kv_itemsize=4, num_bufs=6)
    assert big.piece == 8 and big.smem_bytes <= 232_448


def test_plan_rejects_what_cannot_run():
    kw = dict(batch=4, kv_heads=1, rows=16, block_size=16, max_blocks=8,
              width=512, rope=64, mla=True, kv_itemsize=4)
    for bad in (dict(width=520), dict(width=36), dict(kv_heads=2),
                dict(num_bufs=0), dict(kv_splits=0), dict(kv_splits=17),
                dict(piece=3), dict(piece=64), dict(block_size=24, piece=16),
                dict(num_bufs=100), dict(batch=0)):
        with pytest.raises(ValueError):
            sched.plan_paged_attn_fma_sm90(**{**kw, **bad})
    with pytest.raises(ValueError, match="16-token blocks at head_dim 512"):
        sched.plan_paged_attn_fma_sm90(**{**kw, "mla": False, "rope": 0,
                                          "kv_heads": 4})
    # a pinned piece smaller than the block: 4 pieces a block, 32 runs of
    # one; at 64 blocks, 32 runs of 8
    plan = sched.plan_paged_attn_fma_sm90(**{**kw, "block_size": 32,
                                             "piece": 8})
    assert (plan.piece, plan.pieces) == (8, 32)
    assert [len(plan.run(s)) for s in range(plan.kv_splits)] == [1] * 32
    plan = sched.plan_paged_attn_fma_sm90(**{**kw, "block_size": 32,
                                             "max_blocks": 64})
    assert (plan.piece, plan.pieces, plan.kv_splits) == (8, 256, 32)
    assert {len(plan.run(s)) for s in range(plan.kv_splits)} == {8}


@pytest.mark.parametrize("kv_splits", (None, 1, 2))
@pytest.mark.parametrize("G", (None, 1, 2, 3, 4))
@pytest.mark.parametrize("window", (None, 32))
@pytest.mark.parametrize("phase", sorted(PATH))
def test_run_replay_is_the_chunk_schedule(phase, window, G, kv_splits):
    # every run of every lane at the path's positions (decode lane 3 at
    # 100: 7 live pieces of 16; 8-token blocks in 4-token pieces: more):
    # a run's live pieces are an interval, every visible piece is walked
    # once, and the steps issue the chunk schedule
    B, S = PATH[phase]
    for bs, kw in ((16, {}), (8, dict(piece=4))):
        plan = _plan("mla", phase, 4, block_size=bs, num_bufs=G,
                     kv_splits=kv_splits, **kw)
        live = pa.live_blocks(plan, POSITIONS[phase], S, window)
        P = plan.piece
        for b in range(B):
            p = POSITIONS[phase][b]
            assert sorted(i for run in live[b] for i in run) == [
                i for i in range(plan.pieces) if i * P <= p + S - 1
                and not (window and (i + 1) * P - 1 <= p - window)]
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


H = 4                 # query heads of the small parity cases
R, RR = 32, 8         # MLA latent, rope (small)
HD, KVH = 64, 2       # GQA head_dim, KV heads (2 query heads each)
CASES = {
    # name: (nb, bs, piece, tables, positions, S)
    # 32-token blocks in 8-token pieces: lane 0 lives in piece 0 only, so
    # most runs are empty at any split
    "big_block": (5, 32, 8, [[1, 3], [2, 4]], [5, 40], 1),
    # last and first slot of a block, pieces of half a block
    "block_edges": (17, 8, 4, [[1, 2, 3, 4], [5, 6, 7, 8]], [7, 16], 1),
    # the piece the whole block
    "verify": (9, 8, 8, [[1, 2, 3, 4], [5, 6, 7, 8]], [20, 9], 3),
    "prefill": (9, 16, 4, [[5, 1, 4, 2]], [13], 12),
}


def _inputs(case, mla, dtype, seed=0):
    nb, bs, piece, tables, positions, S = CASES[case]
    rng = np.random.default_rng(seed)
    B = len(tables)
    if mla:
        q = rng.standard_normal((B, S, H, R + RR))
        a = rng.standard_normal((nb, bs, R)) * 0.3
        b = rng.standard_normal((nb, bs, RR)) * 0.3
    else:
        q = rng.standard_normal((B, S, H, HD))
        a = rng.standard_normal((nb, bs, KVH, HD)) * 0.3
        b = rng.standard_normal((nb, bs, KVH, HD)) * 0.3
    arrs = [jnp.asarray(x.astype(np.float32), dtype) for x in (q, a, b)]
    return (*arrs, jnp.asarray(tables, jnp.int32),
            jnp.asarray(positions, jnp.int32))


@pytest.mark.parametrize("window", (None, 10))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("mla", (True, False), ids=("mla", "gqa"))
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_replay_matches_jax(case, mla, dtype, window):
    jdt = getattr(jnp, dtype)
    args = _inputs(case, mla, jdt, seed=3 * mla + (dtype == "bfloat16"))
    nb, bs, piece, tables, positions, S = CASES[case]
    scale = 0.2 if mla else 1.0 / np.sqrt(HD)
    kw = dict(num_kv_heads=1 if mla else KVH, scale=scale, window=window,
              mla=mla)
    want = j_paged_attention(*args, interpret=True, **kw)
    oracle = jref.paged_attn_ref(*args, **kw)
    tol = F32 if dtype == "float32" else BF16
    pieces = len(tables[0]) * bs // piece
    for ks in (1, 2, pieces):
        got = paged_attn_fma_split_ref(*map(t, args), kv_splits=ks,
                                       piece=piece, **kw)
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(np32(got), np32(want), **tol)
        np.testing.assert_allclose(np32(got), np32(oracle), **tol)


def test_empty_runs_really_are_empty():
    # the big_block case's premise: at 2 runs and at one run a piece, lane
    # 0 (position 5) has live pieces in its first run only
    nb, bs, piece, tables, positions, S = CASES["big_block"]
    pieces = len(tables[0]) * bs // piece
    for ks in (2, pieces):
        live = [[sum(i * piece <= p + S - 1 for i in run)
                 for run in sched.kv_runs(pieces, ks)] for p in positions]
        assert live[0][0] == 1 and not any(live[0][1:])
        assert sum(live[1]) == 6


@pytest.mark.parametrize("window", (None, 5))
@pytest.mark.parametrize("mla", (True, False), ids=("mla", "gqa"))
def test_a_row_has_the_same_bits_at_decode_and_verify(mla, window):
    # f32: a token's row of a decode step at p and row s of a verify step
    # from p - s, with 8-token blocks in 4-token pieces (spans inside a
    # piece, across pieces and across blocks; dead and expired pieces in
    # some runs); the planner's piece and runs
    rng = np.random.default_rng(11 + mla)
    nb, bs, MB, S, B = 17, 8, 4, 5, 2
    kvh = 1 if mla else KVH
    q = torch.tensor(rng.standard_normal((B, S, H, R + RR if mla else HD)),
                     dtype=torch.float32)
    shape = (nb, bs) if mla else (nb, bs, kvh)
    a = torch.tensor(rng.standard_normal((*shape, R if mla else HD)) * 0.5,
                     dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((*shape, RR if mla else HD)) * 0.5,
                     dtype=torch.float32)
    tables = torch.tensor(rng.permutation(np.arange(1, nb))[:B * MB]
                          .reshape(B, MB), dtype=torch.int32)
    plan = sched.plan_paged_attn_fma_sm90(
        batch=B, kv_heads=kvh, rows=H // kvh, block_size=bs, max_blocks=MB,
        width=a.shape[-1], rope=b.shape[-1] if mla else 0, mla=mla,
        kv_itemsize=4, piece=4)
    kw = dict(num_kv_heads=kvh, scale=0.125, kv_splits=plan.kv_splits,
              piece=plan.piece, window=window, mla=mla)
    for start in ([2, 9], [11, 20]):
        p0 = torch.tensor(start, dtype=torch.int32)
        ver = paged_attn_fma_split_ref(q, a, b, tables, p0, **kw)
        for s in range(S):
            dec = paged_attn_fma_split_ref(q[:, s:s + 1], a, b, tables,
                                           p0 + s, **kw)
            assert torch.equal(dec[:, 0], ver[:, s])
