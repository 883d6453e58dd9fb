"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with a CUDA GPU and nvcc:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Elsewhere every test skips (a CUDA kernel has no CPU mode).  No JAX here:
the card's machine runs the port alone.
"""
import math

import pytest
import torch

from repro_torch.core import schedule as sched
from repro_torch.kernels import gpp_matmul as gm
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ref import (chunk_issue_schedule, dense_grouped_ref,
                                     dense_ref, mla_merge_ref, paged_attn_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("shape", ((4, 1024, 1024), (20, 2816, 1024),
                                   (7, 1000, 1001)))
def test_gpp_matmul_matches_plain(cuda, dtype, G, shape):
    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(M, K, generator=g, device=cuda).to(dtype)
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.02).to(dtype)
    b = torch.randn(N, generator=g, device=cuda).to(dtype)
    y = gm.gpp_matmul(x, w, bias=b, activation="silu", num_bufs=G)
    ref = dense_ref(x, w, bias=b, activation="silu")
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("G", (1, 2, 4))
def test_gpp_issue_order_is_the_chunk_schedule(cuda, G):
    x = torch.randn(4, 1024, device=cuda).bfloat16()
    w = torch.randn(1024, 512, device=cuda).bfloat16()
    got, num_k, g_used, C = gm.issue_order(x, w, G)
    assert g_used == G
    assert got == chunk_issue_schedule(num_k, G, C)


def test_gpp_int8_with_scale(cuda):
    x = torch.randn(32, 1024, device=cuda)
    w = torch.randint(-127, 128, (1024, 768), device=cuda, dtype=torch.int8)
    scale = torch.rand(768, device=cuda) * 1e-3
    y = gm.gpp_matmul(x, w, w_scale=scale, activation="gelu")
    ref = dense_ref(x, w, w_scale=scale, activation="gelu")
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", ("decode", "prefill", "verify", "window",
                                  "gqa_row_splits"))
def test_paged_attention_matches_plain(cuda, dtype, case):
    B, S, positions, window, kvh = {
        "decode": (4, 1, [5, 17, 40, 100], None, 16),
        "prefill": (1, 32, [37], None, 16),
        "verify": (4, 5, [3, 30, 64, 90], None, 16),
        "window": (4, 1, [5, 17, 40, 100], 32, 16),
        # rep * S = 4 * 32 query rows per head: split over 4 CTAs
        "gqa_row_splits": (2, 32, [0, 50], 40, 4),
    }[case]
    H, hd, bs, mb, nb = 16, 64, 16, 8, 33
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(B, S, H, hd, generator=g, device=cuda).to(dtype)
    k = (torch.randn(nb, bs, kvh, hd, generator=g, device=cuda) * 0.5
         ).to(dtype)
    v = (torch.randn(nb, bs, kvh, hd, generator=g, device=cuda) * 0.5
         ).to(dtype)
    tables = torch.randint(1, nb, (B, mb), generator=g, device=cuda,
                           dtype=torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    kw = dict(num_kv_heads=kvh, scale=1 / math.sqrt(hd), window=window)
    ref = paged_attn_ref(q, k, v, tables, pos, **kw)
    for G in (None, 1, 2, 4):
        out = paged_attention(q, k, v, tables, pos, num_bufs=G, **kw)
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("shape", ((64, 32, 2048, 1408), (64, 128, 1408, 2048),
                                   (5, 7, 300, 130)))
def test_gpp_matmul_grouped_matches_plain(cuda, dtype, G, shape):
    # f32 runs the FMA kernel, bf16 the tensor-core kernel
    E, M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(E, M, K, generator=g, device=cuda).to(dtype)
    w = (torch.randn(E, K, N, generator=g, device=cuda) * 0.02).to(dtype)
    b = torch.randn(E, N, generator=g, device=cuda).to(dtype)
    y = gm.gpp_matmul_grouped(x, w, bias=b, activation="silu", num_bufs=G)
    ref = dense_grouped_ref(x, w, bias=b, activation="silu")
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("scale_shape", ("scalar", "expert", "column"))
def test_gpp_matmul_grouped_int8_with_scale(cuda, scale_shape):
    E, M, K, N = 6, 32, 512, 384
    x = torch.randn(E, M, K, device=cuda)
    w = torch.randint(-127, 128, (E, K, N), device=cuda, dtype=torch.int8)
    scale = {"scalar": torch.tensor(1e-3),
             "expert": torch.rand(E, device=cuda) * 1e-3,
             "column": torch.rand(E, N, device=cuda) * 1e-3}[scale_shape]
    y = gm.gpp_matmul_grouped(x, w, w_scale=scale, activation="gelu")
    ref = dense_grouped_ref(x, w, w_scale=scale, activation="gelu")
    torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("G", (None, 1, 2, 4))
def test_gpp_grouped_issue_order_crosses_experts(cuda, G):
    # bf16: the tensor-core route; one n-tile an expert and more units
    # than CTAs, so CTA 0 walks experts 0 and 1 on one ring
    x = torch.randn(600, 16, 512, device=cuda).bfloat16()
    w = (torch.randn(600, 512, 64, device=cuda) * 0.02).bfloat16()
    got, steps, g_used, C, units = gm.issue_order_grouped(x, w, G)
    plan = sched.plan_grouped_tc_sm90(600, 16, 512, 64, num_bufs=G)
    assert [plan.unit(u)[0] for u in plan.cta_units(0)] == [0, 1]
    assert units == 2 and steps == plan.cta_steps(0)
    assert G is None or g_used == G
    assert got == chunk_issue_schedule(steps, g_used, C)


@pytest.mark.parametrize("G", (None, 1, 2, 4))
def test_gpp_grouped_tc_issue_order_at_decode(cuda, G):
    # deepseek-v2-lite decode gate/up: CTA 0 walks two n-tiles of expert 0
    x = torch.randn(64, 32, 2048, device=cuda).bfloat16()
    w = (torch.randn(64, 2048, 1408, device=cuda) * 0.02).bfloat16()
    got, steps, g_used, C, units = gm.issue_order_grouped(x, w, G)
    assert units == 2
    assert G is None or g_used == G
    assert got == chunk_issue_schedule(steps, g_used, C)


@pytest.mark.parametrize("G", (None, 1, 2, 4))
def test_gpp_grouped_fma_issue_order_crosses_experts(cuda, G):
    # f32: the FMA route at deepseek-v2-lite decode gate/up as planned,
    # 5 experts a CTA, so CTA (0, 0, 0)'s record crosses four expert
    # boundaries (8 k-steps an expert; 16 where a pinned ring of 4 halves
    # the tile's rows to fit)
    x = torch.randn(64, 32, 2048, device=cuda)
    w = torch.randn(64, 2048, 1408, device=cuda) * 0.02
    got, steps, g_used, C, epc = gm.issue_order_grouped(x, w, G)
    tile = sched.plan_grouped_sm90(64, 32, 2048, 1408, w_itemsize=4,
                                   num_bufs=G).tile
    assert epc == 5 and steps == 5 * tile.grid(32, 1408, 2048)[2]
    assert steps == (80 if G == 4 else 40)
    assert G is None or g_used == G
    assert got == chunk_issue_schedule(steps, g_used, C)


@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("shape", ((64, 32, 2048, 1408), (64, 32, 1408, 2048),
                                   (64, 128, 2048, 1408),
                                   (64, 128, 1408, 2048), (64, 7, 300, 130),
                                   (3, 200, 256, 256), (2, 33, 999, 1001)))
def test_gpp_grouped_tc_route_matches_plain(cuda, shape, G):
    # bf16 x and W launch the tensor-core kernel, never the FMA one
    E, M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(E, M, K, generator=g, device=cuda).bfloat16()
    w = (torch.randn(E, K, N, generator=g, device=cuda) * 0.02).bfloat16()
    b = torch.randn(E, N, generator=g, device=cuda)
    tc, fma = gm.launches_grouped_tc.n, gm.launches_grouped.n
    for act, bias in (("silu", None), ("gelu", b)):
        y = gm.gpp_matmul_grouped(x, w, bias=bias, activation=act,
                                  num_bufs=G)
        ref = dense_grouped_ref(x, w, bias=bias, activation=act)
        torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
    assert (gm.launches_grouped_tc.n - tc, gm.launches_grouped.n - fma) \
        == (2, 0)


@pytest.mark.parametrize("shape,G", (((64, 32, 2048, 1408), None),
                                     ((64, 128, 1408, 2048), None),
                                     ((64, 32, 2048, 1408), 4)))
def test_gpp_grouped_tc_occupancy_is_planned(cuda, shape, G):
    # the card holds as many CTAs an SM as the planner assumed
    plan = sched.plan_grouped_tc_sm90(*shape, num_bufs=G)
    assert gm.grouped_tc_ctas_per_sm(plan) == plan.ctas_per_sm


MLA_CASES = {"decode": (4, 1, [5, 17, 40, 100]),
             "prefill": (1, 32, [37]),
             "verify": (4, 5, [3, 30, 64, 90])}


def _mla_inputs(cuda, dtype, case, seed=3):
    B, S, positions = MLA_CASES[case]
    H, r, rr, bs, mb, nb = 16, 512, 64, 16, 8, 33
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, S, H, r + rr, generator=g, device=cuda).to(dtype)
    ckv = (torch.randn(nb, bs, r, generator=g, device=cuda) * 0.5).to(dtype)
    kr = (torch.randn(nb, bs, rr, generator=g, device=cuda) * 0.5).to(dtype)
    tables = torch.randint(1, nb, (B, mb), generator=g, device=cuda,
                           dtype=torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    return q, ckv, kr, tables, pos


@pytest.mark.parametrize("kv_splits", (None, 1, 2, 8))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("case", ("decode", "prefill", "verify"))
def test_mla_paged_attention_matches_plain(cuda, dtype, case, kv_splits):
    # bf16 runs the tensor-core kernel (kv_splits pinned or planned), f32
    # the FMA kernel (which has no splits: pinning them raises)
    q, ckv, kr, tables, pos = _mla_inputs(cuda, dtype, case)
    B, S, H, _ = q.shape
    kw = dict(num_kv_heads=1, scale=1 / math.sqrt(576), mla=True)
    ref = paged_attn_ref(q, ckv, kr, tables, pos, **kw)
    if dtype == torch.float32 and kv_splits is not None:
        with pytest.raises(ValueError, match="kv_splits"):
            paged_attention(q, ckv, kr, tables, pos, kv_splits=kv_splits,
                            **kw)
        return
    counts = (pa.launches_mla_tc, pa.launches_mla_merge, pa.launches_mla)
    before = [c.n for c in counts]
    for G in (None, 1, 2, 4):
        out = paged_attention(q, ckv, kr, tables, pos, num_bufs=G,
                              kv_splits=kv_splits, **kw)
        assert out.shape == (B, S, H, 512)
        tol = 2e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
    ran = tuple(c.n - n for c, n in zip(counts, before))
    # the planned split is > 1 at every path shape: the merge runs
    merges = 0 if kv_splits == 1 else 4
    assert ran == ((4, merges, 0) if dtype == torch.bfloat16 else (0, 0, 4))


@pytest.mark.parametrize("kv_splits", (2, 8))
@pytest.mark.parametrize("case", ("decode", "prefill", "verify"))
def test_mla_merge_matches_plain(cuda, case, kv_splits):
    # the merge kernel against its plain version on the tensor-core
    # kernel's own partials (empty runs among them)
    q, ckv, kr, tables, pos = _mla_inputs(cuda, torch.bfloat16, case)
    B, S, H, _ = q.shape
    plan = sched.plan_paged_attn_mla_tc_sm90(
        batch=B, rows=H * S, block_size=16, max_blocks=8, latent=512,
        rope=64, kv_splits=kv_splits)
    ws = torch.empty(plan.workspace_floats(512), device=cuda)
    out = torch.empty((B, 1, H * S, 512), dtype=torch.bfloat16, device=cuda)
    pa._launch_mla_split(pa._q_rows(q, 1 / math.sqrt(576), 1, q.dtype), ckv,
                         kr, tables, pos, plan, out, ws, S=S, window=None)
    pa._launch_mla_merge(ws, out, plan, 512)
    ref = mla_merge_ref(ws, batch=B, row_tiles=plan.row_tiles,
                        kv_splits=kv_splits, latent=512, rows=H * S)
    torch.testing.assert_close(out.reshape(B, H * S, 512).float(), ref,
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", ("decode", "prefill", "verify"))
def test_mla_tc_occupancy_is_planned(cuda, case):
    # the card holds at least the CTAs an SM the planner assumed
    B, S, _ = MLA_CASES[case]
    plan = sched.plan_paged_attn_mla_tc_sm90(
        batch=B, rows=16 * S, block_size=16, max_blocks=8, latent=512,
        rope=64)
    assert pa.mla_tc_ctas_per_sm(plan, 512, 64) >= plan.ctas_per_sm


@pytest.mark.parametrize("kv_splits", (1, 2))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
def test_mla_tc_issue_order_is_the_chunk_schedule(cuda, G, kv_splits):
    # decode lane 3 (position 100) holds 7 live blocks: one run of 7 at
    # kv_splits 1, runs of 4 and 3 at 2; the first run of >= 4 records
    q, ckv, kr, tables, pos = _mla_inputs(cuda, torch.bfloat16, "decode")
    got, steps, g_used, C, cta = pa.issue_order_mla(
        q, ckv, kr, tables, pos, scale=0.05, num_bufs=G,
        kv_splits=kv_splits)
    assert steps == (7 if kv_splits == 1 else 4)
    assert cta == 3 * kv_splits
    assert G is None or g_used == min(G, 8 // kv_splits)
    assert got == chunk_issue_schedule(steps, g_used, C)
