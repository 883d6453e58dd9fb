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
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ref import (chunk_issue_schedule, dense_grouped_ref,
                                     dense_ref, mla_merge_ref,
                                     paged_attn_fma_split_ref,
                                     paged_attn_ref, rmsnorm_ref)

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
    # the FMA route (pinned: bf16 x and W route to the tensor cores) as
    # planned: CTA 0 walks its run of k-steps of tile 0, which other CTAs
    # finish
    x = torch.randn(4, 1024, device=cuda).bfloat16()
    w = torch.randn(1024, 512, device=cuda).bfloat16()
    got, steps, g_used, C = gm.issue_order(x, w, G, route="fma")
    plan = sched.plan_matmul_fma_sm90(4, 1024, 512, w_itemsize=2,
                                      num_bufs=G)
    assert steps == plan.cta_steps(0) and len(plan.segments(0)) > 1
    assert g_used == G
    assert got == chunk_issue_schedule(steps, G, C)


# every f32 product of the two serving paths, (K, N): deepseek's router in
# every run, the rest in the f32 runs
FMA_ROUTER = (2048, 64)
FMA_PROJ = ((1024, 1024), (1024, 2816), (2816, 1024), (2048, 3072),
            (2048, 576), (2048, 2048), FMA_ROUTER, (2048, 2816),
            (2816, 2048), (2048, 10944), (10944, 2048))
FMA_PATH = [(M, K, N) for M in (4, 32, 20) for K, N in FMA_PROJ]


def _fma_inputs(cuda, M, K, N, seed, *, x_dtype=torch.float32,
                w_dtype=torch.float32):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(M, K, generator=g, device=cuda).to(x_dtype)
    if w_dtype == torch.int8:
        w = torch.randint(-127, 128, (K, N), generator=g, device=cuda,
                          dtype=torch.int8)
        s = torch.rand(N, generator=g, device=cuda) * 2e-3
    else:
        w = (torch.randn(K, N, generator=g, device=cuda) * 0.02).to(w_dtype)
        s = torch.rand(N, generator=g, device=cuda) + 0.5
    b = torch.randn(N, generator=g, device=cuda)
    return x, w, b, s


@pytest.mark.parametrize("shape", FMA_PATH + [(7, 1000, 1001), (37, 333, 130),
                                              (200, 1000, 1001), (1, 64, 8),
                                              (65, 33, 65)])
def test_gpp_fma_route_matches_plain(cuda, shape):
    # f32 x and W launch the split-K FMA kernel, never the tensor-core one,
    # at the planned ring and pinned ones, with and without an epilogue
    M, K, N = shape
    x, w, b, s = _fma_inputs(cuda, M, K, N, 12)
    tc, fma = gm.launches_tc.n, gm.launches.n
    for G in (None, 1, 2, 4):
        for act, bias, scale in (("silu", None, None), ("gelu", b, s)):
            y = gm.gpp_matmul(x, w, bias=bias, w_scale=scale,
                              activation=act, num_bufs=G)
            ref = dense_ref(x, w, bias=bias, w_scale=scale, activation=act)
            torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)
    assert (gm.launches_tc.n - tc, gm.launches.n - fma) == (0, 8)


@pytest.mark.parametrize("act", ("relu", "gelu", "silu", "tanh", "sigmoid",
                                 None))
@pytest.mark.parametrize("case", ("int8", "bf16_w", "bf16_x_pinned"))
def test_gpp_fma_route_dtypes(cuda, case, act):
    # int8 W with its scale, a bf16 W (deepseek's router as stored) and bf16
    # x pinned to the FMA route, at the router's split and a ragged one
    kw = {"int8": dict(w_dtype=torch.int8),
          "bf16_w": dict(w_dtype=torch.bfloat16),
          "bf16_x_pinned": dict(x_dtype=torch.bfloat16,
                                w_dtype=torch.bfloat16)}[case]
    tol = 2e-2 if case == "bf16_x_pinned" else 2e-4
    for M, K, N in ((4, *FMA_ROUTER), (20, 1000, 1001)):
        x, w, b, s = _fma_inputs(cuda, M, K, N, 13, **kw)
        scale = s if case == "int8" else None
        fma = gm.launches.n
        y = gm.gpp_matmul(x, w, bias=b, w_scale=scale, activation=act,
                          route="fma")
        assert gm.launches.n == fma + 1 and y.dtype == x.dtype
        ref = dense_ref(x, w, bias=b, w_scale=scale, activation=act)
        torch.testing.assert_close(y.float(), ref.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("shape", ((4, *FMA_ROUTER), (32, *FMA_ROUTER),
                                   (4, 2816, 1024), (32, 10944, 2048),
                                   (7, 1000, 1001)))
def test_gpp_fma_route_is_deterministic(cuda, shape):
    # split tiles are summed in segment order, whatever order their CTAs
    # arrive in: four runs agree bit for bit
    M, K, N = shape
    plan = sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=4)
    assert plan.max_segs > 1
    x, w, b, _ = _fma_inputs(cuda, M, K, N, 14)
    first = gm.gpp_matmul(x, w, bias=b, activation="silu")
    for _ in range(3):
        assert torch.equal(gm.gpp_matmul(x, w, bias=b, activation="silu"),
                           first)


@pytest.mark.parametrize("KN", FMA_PROJ)
def test_gpp_fma_rows_do_not_depend_on_the_batch(cuda, KN):
    # 1, 4 (decode), 20 (verify) and 32 (prefill) rows plan the same k-cuts
    # and segments, so a row's output is the same bits whichever batch it
    # rides in
    K, N = KN
    x, w, _, _ = _fma_inputs(cuda, 32, K, N, 15)
    y1 = gm.gpp_matmul(x[:1], w)
    y4 = gm.gpp_matmul(x[:4], w)
    assert torch.equal(y4[:1], y1)
    assert torch.equal(gm.gpp_matmul(x[:20], w)[:4], y4)
    assert torch.equal(gm.gpp_matmul(x, w)[:4], y4)


def test_router_weight_in_its_stored_dtype(cuda):
    # deepseek's router: f32 x against the bf16 weight as stored is the
    # bits of f32 x against its f32 copy (the kernel widens bf16 exactly,
    # on the same plan), at decode, verify and prefill
    for M in (4, 20, 32):
        x, w, _, _ = _fma_inputs(cuda, M, *FMA_ROUTER, 16,
                                 w_dtype=torch.bfloat16)
        assert torch.equal(ops.dense(x, w), ops.dense(x, w.float()))


@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("shape,grid", (((4, 512, 192), 2),
                                        ((4, *FMA_ROUTER), None)))
def test_gpp_fma_issue_order_crosses_tiles_and_splits(cuda, shape, grid, G):
    # 4x512x192 on 2 CTAs: CTA 0 walks tile 0's k-steps and half of tile
    # 1's (which CTA 1 finishes); the router as planned: CTA 0's one step
    # of the tile that 31 more CTAs share
    M, K, N = shape
    x, w, _, _ = _fma_inputs(cuda, M, K, N, 17)
    got, steps, g_used, C = gm.issue_order(x, w, G, grid=grid)
    plan = sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=4, num_bufs=G,
                                      grid=grid)
    assert steps == plan.cta_steps(0)
    tiles = {plan.unit(u)[0] for u in plan.cta_units(0)}
    assert len(tiles) == (2 if grid else 1)
    assert len(plan.segments(max(tiles))) > 1
    assert G is None or g_used == G
    assert got == chunk_issue_schedule(steps, g_used, C)


# every bf16 projection of the two serving paths, (M, K, N): M = 4 / 32 /
# 20 rows at decode / prefill / verify
GPP_PROJ = ((1024, 1024), (1024, 2816), (2816, 1024), (2048, 3072),
            (2048, 576), (2048, 2048), (2048, 2816), (2816, 2048),
            (2048, 10944), (10944, 2048))
GPP_PATH = [(M, K, N) for M in (4, 32, 20) for K, N in GPP_PROJ]


@pytest.mark.parametrize("shape", GPP_PATH + [(7, 1000, 1001), (37, 333, 130),
                                              (200, 1000, 1001)])
def test_gpp_tc_route_matches_plain(cuda, shape):
    # bf16 x and W launch the tensor-core kernel, never the FMA one, at
    # every ring depth; ragged shapes take the narrower copies
    M, K, N = shape
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.02).bfloat16()
    b = torch.randn(N, generator=g, device=cuda)
    s = torch.rand(N, generator=g, device=cuda) + 0.5
    tc, fma = gm.launches_tc.n, gm.launches.n
    for G in (None, 1, 2, 3, 4):
        for act, bias, scale in (("silu", None, None), ("gelu", b, s)):
            y = gm.gpp_matmul(x, w, bias=bias, w_scale=scale,
                              activation=act, num_bufs=G)
            ref = dense_ref(x, w, bias=bias, w_scale=scale, activation=act)
            torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2,
                                       atol=2e-2)
    assert (gm.launches_tc.n - tc, gm.launches.n - fma) == (10, 0)


@pytest.mark.parametrize("shape", ((4, 2816, 1024), (32, 10944, 2048),
                                   (20, 2048, 576), (7, 1000, 1001)))
def test_gpp_tc_route_is_deterministic(cuda, shape):
    # a tile's k-slices are summed in rank order through distributed shared
    # memory, whenever each rank finishes: four runs agree bit for bit
    M, K, N = shape
    plan = sched.plan_matmul_tc_sm90(M, K, N)
    assert plan.cluster > 1
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(M, K, generator=g, device=cuda).bfloat16()
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.02).bfloat16()
    first = gm.gpp_matmul(x, w, activation="silu")
    for _ in range(3):
        assert torch.equal(gm.gpp_matmul(x, w, activation="silu"), first)


@pytest.mark.parametrize("KN", GPP_PROJ)
def test_gpp_tc_rows_do_not_depend_on_the_batch(cuda, KN):
    # decode (4 rows), verify (20) and prefill (32) plan the same k-slices,
    # k-groups and cluster, so a row's output is the same bits whichever
    # batch it rides in, at every projection of both paths
    K, N = KN
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(32, K, generator=g, device=cuda).bfloat16()
    w = (torch.randn(K, N, generator=g, device=cuda) * 0.02).bfloat16()
    a, b, c = ((p.block_n, p.cluster, p.block_k)
               for p in (sched.plan_matmul_tc_sm90(M, K, N)
                         for M in (4, 20, 32)))
    assert a == b == c
    y4 = gm.gpp_matmul(x[:4], w)
    assert torch.equal(gm.gpp_matmul(x[:20], w)[:4], y4)
    assert torch.equal(gm.gpp_matmul(x, w)[:4], y4)


@pytest.mark.parametrize("shape", ((4, 2048, 576), (20, 10944, 2048)))
def test_gpp_tc_two_streams_at_once(cuda, shape):
    # a split tile's partials live in its cluster's shared memory and the
    # launch shares no counter or workspace: launches on two streams at
    # once, and a CUDA graph replayed beside eager launches, each sum their
    # own tiles
    M, K, N = shape
    assert sched.plan_matmul_tc_sm90(M, K, N).cluster > 1
    _two_streams(cuda, M, K, N, torch.bfloat16, 2e-2)


@pytest.mark.parametrize("shape", ((4, 2048, 64), (20, 2816, 1024)))
def test_gpp_fma_two_streams_at_once(cuda, shape):
    # the same on the FMA route, which shares the counters' buffers
    M, K, N = shape
    assert sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=4).max_segs > 1
    _two_streams(cuda, M, K, N, torch.float32, 2e-4)


def _two_streams(cuda, M, K, N, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(11)
    xs = [torch.randn(M, K, generator=g, device=cuda).to(dtype)
          for _ in range(2)]
    ws = [(torch.randn(K, N, generator=g, device=cuda) * 0.02).to(dtype)
          for _ in range(2)]
    want = [gm.gpp_matmul(x, w) for x, w in zip(xs, ws)]
    for y, x, w in zip(want, xs, ws):
        torch.testing.assert_close(y.float(), dense_ref(x, w).float(),
                                   rtol=tol, atol=tol)
    streams = [torch.cuda.Stream(device=cuda) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))
    outs = [[], []]
    for _ in range(30):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(gm.gpp_matmul(xs[i], ws[i]))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(streams[0]):
        with torch.cuda.graph(graph):
            yg = gm.gpp_matmul(xs[0], ws[0])
    for _ in range(30):
        with torch.cuda.stream(streams[0]):
            graph.replay()
            outs[0].append(yg.clone())
        with torch.cuda.stream(streams[1]):
            outs[1].append(gm.gpp_matmul(xs[1], ws[1]))
    torch.cuda.synchronize(cuda)
    for i in range(2):
        for y in outs[i]:
            assert torch.equal(y, want[i])


@pytest.mark.parametrize("G", (None, 1, 2, 3, 4))
@pytest.mark.parametrize("shape,pins", (((4, 2048, 1024),
                                         dict(cluster=2, block_k=128)),
                                        ((4, 10944, 2048), {})))
def test_gpp_tc_issue_order_crosses_tiles_and_splits(cuda, shape, pins, G):
    # 4x2048x1024 in clusters of 2 at 128-row steps: rank 0 walks k-steps
    # 0-7 of its tile, and rank 1 the rest; layer 0's down projection as
    # planned: rank 0's k-slice of 5 of the 43 k-steps
    M, K, N = shape
    x = torch.randn(M, K, device=cuda).bfloat16()
    w = (torch.randn(K, N, device=cuda) * 0.02).bfloat16()
    got, steps, g_used, C = gm.issue_order(x, w, G, **pins)
    plan = sched.plan_matmul_tc_sm90(M, K, N, num_bufs=G, **pins)
    assert steps == plan.cta_steps(0) >= 5 and plan.cluster > 1
    assert list(plan.k_slice(0)) == list(range(steps))
    assert G is None or g_used == G
    assert got == chunk_issue_schedule(steps, g_used, C)


@pytest.mark.parametrize("shape,G", (((4, 1024, 2816), None),
                                     ((32, 10944, 2048), None),
                                     ((20, 2048, 3072), None),
                                     ((4, 2048, 10944), 4)))
def test_gpp_tc_occupancy_is_planned(cuda, shape, G):
    # the card holds every cluster of the plan at once (its shared memory
    # and registers, clusters placed within the SMs' groups), also at a
    # pinned deep ring, and one CTA an SM at least at a cluster of one
    plan = sched.plan_matmul_tc_sm90(*shape, num_bufs=G)
    assert gm.tc_max_clusters(plan) >= plan.tiles
    one = sched.plan_matmul_tc_sm90(*shape, num_bufs=G, cluster=1)
    assert gm.tc_max_clusters(one) >= sched.H100_SMS


@pytest.mark.parametrize("KN", GPP_PROJ)
def test_gpp_tc_clusters_are_resident(cuda, KN):
    # every tile's cluster of the planned split runs at once, at decode,
    # verify and prefill (the card reports clusters, not CTAs: an SM group
    # holds clusters of 8 only where 8 of its SMs are free)
    for M in (4, 20, 32):
        plan = sched.plan_matmul_tc_sm90(M, *KN)
        assert gm.tc_max_clusters(plan) >= plan.tiles


def test_gpp_fma_route_pinned_on_bf16(cuda):
    # the sweeps' comparison: the FMA kernel still takes bf16
    x = torch.randn(4, 1024, device=cuda).bfloat16()
    w = (torch.randn(1024, 2816, device=cuda) * 0.02).bfloat16()
    fma = gm.launches.n
    y = gm.gpp_matmul(x, w, activation="silu", route="fma")
    assert gm.launches.n == fma + 1
    torch.testing.assert_close(y.float(), dense_ref(x, w, activation="silu")
                               .float(), rtol=2e-2, atol=2e-2)
    with pytest.raises(TypeError, match="bf16"):
        gm.gpp_matmul(x.float(), w, route="tc")


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
    got, steps, g_used, C, units, experts = gm.issue_order_grouped(x, w, G)
    plan = sched.plan_grouped_tc_sm90(600, 16, 512, 64, num_bufs=G)
    assert [plan.unit(u)[0] for u in plan.cta_units(0)] == [0, 1]
    assert (units, experts) == (2, 2) and steps == plan.cta_steps(0)
    assert G is None or g_used == G
    assert got == chunk_issue_schedule(steps, g_used, C)


@pytest.mark.parametrize("G", (None, 1, 2, 4))
def test_gpp_grouped_tc_issue_order_at_decode(cuda, G):
    # deepseek-v2-lite decode gate/up: CTA 0 walks two n-tiles of expert 0
    x = torch.randn(64, 32, 2048, device=cuda).bfloat16()
    w = (torch.randn(64, 2048, 1408, device=cuda) * 0.02).bfloat16()
    got, steps, g_used, C, units, _ = gm.issue_order_grouped(x, w, G)
    assert units == 2
    assert G is None or g_used == G
    assert got == chunk_issue_schedule(steps, g_used, C)


@pytest.mark.parametrize("G", (None, 1, 2, 4))
def test_gpp_grouped_fma_issue_order_crosses_experts(cuda, G):
    # f32: the split-K FMA route at one n-tile an expert, as planned: CTA
    # 0's 9 steps walk experts 0 and 1 and the first step of expert 2 on
    # one ring
    x = torch.randn(600, 16, 512, device=cuda)
    w = torch.randn(600, 512, 64, device=cuda) * 0.02
    got, steps, g_used, C, tiles, experts = gm.issue_order_grouped(x, w, G)
    plan = sched.plan_matmul_fma_sm90(16, 512, 64, w_itemsize=4, E=600,
                                      num_bufs=G)
    assert steps == plan.cta_steps(0) and tiles == experts >= 3
    assert len(plan.segments(tiles - 1)) > 1
    assert G is None or g_used == G
    assert got == chunk_issue_schedule(steps, g_used, C)


# deepseek-v2-lite-16b's routed experts in f32, (E, M, K, N): decode and
# verify (32 rows an expert) and prefill (128), gate / up and down
GROUPED_FMA_PATH = [(64, M, K, N) for M in (32, 128)
                    for K, N in ((2048, 1408), (1408, 2048))]


def _grouped_inputs(cuda, E, M, K, N, seed, *, x_dtype=torch.float32,
                    w_dtype=torch.float32):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(E, M, K, generator=g, device=cuda).to(x_dtype)
    if w_dtype == torch.int8:
        w = torch.randint(-127, 128, (E, K, N), generator=g, device=cuda,
                          dtype=torch.int8)
    else:
        w = (torch.randn(E, K, N, generator=g, device=cuda)
             * 0.02).to(w_dtype)
    b = torch.randn(E, N, generator=g, device=cuda)
    return x, w, b


@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("shape", GROUPED_FMA_PATH + [(64, 7, 300, 130),
                                                      (5, 7, 300, 130),
                                                      (2, 33, 999, 1001),
                                                      (600, 16, 512, 64)])
def test_gpp_grouped_fma_route_matches_plain(cuda, shape, G):
    # f32 x and W launch the split-K FMA kernel, never the tensor-core one
    x, w, b = _grouped_inputs(cuda, *shape, 21)
    tc, fma = gm.launches_grouped_tc.n, gm.launches_grouped.n
    for act, bias in (("silu", None), ("gelu", b)):
        y = gm.gpp_matmul_grouped(x, w, bias=bias, activation=act,
                                  num_bufs=G)
        ref = dense_grouped_ref(x, w, bias=bias, activation=act)
        torch.testing.assert_close(y, ref, rtol=2e-4, atol=2e-4)
    assert (gm.launches_grouped_tc.n - tc, gm.launches_grouped.n - fma) \
        == (0, 2)


@pytest.mark.parametrize("scale_shape", ("scalar", "expert", "column"))
@pytest.mark.parametrize("x_dtype", (torch.float32, torch.bfloat16))
def test_gpp_grouped_fma_int8(cuda, scale_shape, x_dtype):
    # int8 W with each scale form, at the decode shape, f32 and bf16 x
    E, M, K, N = GROUPED_FMA_PATH[0]
    x, w, b = _grouped_inputs(cuda, E, M, K, N, 22, x_dtype=x_dtype,
                              w_dtype=torch.int8)
    scale = {"scalar": torch.tensor(1e-3),
             "expert": torch.rand(E, device=cuda) * 1e-3,
             "column": torch.rand(E, N, device=cuda) * 1e-3}[scale_shape]
    y = gm.gpp_matmul_grouped(x, w, w_scale=scale, bias=b, activation="silu")
    ref = dense_grouped_ref(x, w, w_scale=scale, bias=b, activation="silu")
    tol = 2e-4 if x_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", GROUPED_FMA_PATH[:2])
def test_gpp_grouped_fma_bf16_x_with_f32_w(cuda, shape):
    x, w, b = _grouped_inputs(cuda, *shape, 23, x_dtype=torch.bfloat16)
    fma = gm.launches_grouped.n
    y = gm.gpp_matmul_grouped(x, w, bias=b, activation="gelu")
    assert gm.launches_grouped.n == fma + 1 and y.dtype == torch.bfloat16
    ref = dense_grouped_ref(x, w, bias=b, activation="gelu")
    torch.testing.assert_close(y.float(), ref.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape", GROUPED_FMA_PATH)
def test_gpp_grouped_fma_is_bitwise_repeatable(cuda, shape):
    # split tiles are summed in segment order whatever order their CTAs
    # arrive in
    x, w, _ = _grouped_inputs(cuda, *shape, 24)
    first = gm.gpp_matmul_grouped(x, w, activation="silu")
    for _ in range(3):
        assert torch.equal(gm.gpp_matmul_grouped(x, w, activation="silu"),
                           first)


@pytest.mark.parametrize("KN", ((2048, 1408), (1408, 2048)))
def test_gpp_grouped_fma_rows_do_not_depend_on_the_batch(cuda, KN):
    # 8, 32 (decode / verify) and 128 (prefill) rows an expert plan the
    # same k-cuts and segments, so a row's output is the same bits; a bf16
    # W gives its f32 copy's bits
    x, w, _ = _grouped_inputs(cuda, 64, 128, *KN, 25)
    y = gm.gpp_matmul_grouped(x, w)
    for M in (8, 32):
        assert torch.equal(gm.gpp_matmul_grouped(x[:, :M].contiguous(), w),
                           y[:, :M])
    wb = w.bfloat16()
    assert torch.equal(gm.gpp_matmul_grouped(x[:, :32].contiguous(), wb),
                       gm.gpp_matmul_grouped(x[:, :32].contiguous(),
                                             wb.float()))


@pytest.mark.parametrize("shape,w_dtype", [
    (GROUPED_FMA_PATH[0], torch.float32), (GROUPED_FMA_PATH[2], torch.float32),
    (GROUPED_FMA_PATH[3], torch.int8), ((1, 4, 2048, 64), torch.bfloat16),
    ((1, 20, 1024, 151936), torch.bfloat16)])
def test_gpp_grouped_fma_occupancy_is_planned(cuda, shape, w_dtype):
    # the card holds as many CTAs an SM as the planner assumed (two at the
    # experts' shapes: the prefill grid of 264 runs in one wave)
    E, M, K, N = shape
    plan = sched.plan_matmul_fma_sm90(
        M, K, N, w_itemsize=torch.empty((), dtype=w_dtype).element_size(),
        E=E)
    assert gm.fma_ctas_per_sm(plan, torch.float32, w_dtype) == \
        plan.ctas_per_sm


def test_gpp_matmul_is_the_grouped_body_at_one_expert(cuda):
    # gpp_matmul's FMA route and gpp_matmul_grouped at E = 1 run one body
    # on one plan: the same bits
    for M, K, N in ((4, 2048, 64), (20, 1000, 1001), (32, 2816, 1024)):
        x, w, b = _grouped_inputs(cuda, 1, M, K, N, 26)
        assert torch.equal(gm.gpp_matmul(x[0], w[0], bias=b[0],
                                         activation="tanh"),
                           gm.gpp_matmul_grouped(x, w, bias=b,
                                                 activation="tanh")[0])


@pytest.mark.parametrize("KN", ((1024, 151936), (2048, 102400)))
def test_logits_head_rows_do_not_depend_on_the_batch(cuda, KN):
    # the f32 logits head of qwen1.5-0.5b (tied, 151936 x 1024) and
    # deepseek-v2-lite-16b (102400 x 2048): f32 x against the bf16 (d,
    # vocab) serving copy on the FMA route; a row is the same bits at 1, 4,
    # 20 and 32 rows, and against the table's f32 copy
    K, N = KN
    g = torch.Generator(device=cuda).manual_seed(27)
    table = (torch.randn(N, K, generator=g, device=cuda) * 0.02).bfloat16()
    table_t = table.t().contiguous()
    x = torch.randn(32, K, generator=g, device=cuda)
    fma = gm.launches.n
    y = ops.dense(x, table_t)
    assert gm.launches.n == fma + 1
    for M in (1, 4, 20):
        assert torch.equal(ops.dense(x[:M], table_t), y[:M])
    assert torch.equal(ops.dense(x[:4], table_t.float()), y[:4])
    torch.testing.assert_close(y, x @ table.float().t(), rtol=2e-4,
                               atol=2e-4)


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
    # bf16 runs the tensor-core kernel, f32 the FMA kernel (kv_splits
    # pinned or planned on both; each with its merge past one run)
    q, ckv, kr, tables, pos = _mla_inputs(cuda, dtype, case)
    B, S, H, _ = q.shape
    kw = dict(num_kv_heads=1, scale=1 / math.sqrt(576), mla=True)
    ref = paged_attn_ref(q, ckv, kr, tables, pos, **kw)
    counts = (pa.launches_mla_tc, pa.launches_merge, pa.launches_mla)
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
    assert ran == ((4, merges, 0) if dtype == torch.bfloat16
                   else (0, merges, 4))


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
    pa._launch_merge(ws, out, B * plan.row_tiles, plan.row_tiles,
                     kv_splits, 512, H * S)
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


@pytest.mark.parametrize("block_size", (8, 128))
@pytest.mark.parametrize("case", ("decode", "prefill", "verify"))
def test_mla_bf16_block_sizes_take_the_fma_kernel(cuda, case, block_size):
    # bf16 MLA at block sizes the tensor-core plan does not take runs the
    # FMA kernel's bf16 instance, counted apart from its f32 launches
    B, S, positions = MLA_CASES[case]
    H, r, rr = 16, 512, 64
    mb = -(-128 // block_size)
    nb = B * mb + 1
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(B, S, H, r + rr, generator=g, device=cuda).bfloat16()
    ckv = (torch.randn(nb, block_size, r, generator=g, device=cuda)
           * 0.5).bfloat16()
    kr = (torch.randn(nb, block_size, rr, generator=g, device=cuda)
          * 0.5).bfloat16()
    tables = torch.randint(1, nb, (B, mb), generator=g, device=cuda,
                           dtype=torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    kw = dict(num_kv_heads=1, scale=1 / math.sqrt(576), mla=True)
    ref = paged_attn_ref(q, ckv, kr, tables, pos, **kw)
    counts = (pa.launches_mla_bf16, pa.launches_mla_tc, pa.launches_mla)
    before = [c.n for c in counts]
    for G in (None, 1, 2):
        out = paged_attention(q, ckv, kr, tables, pos, num_bufs=G, **kw)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                   atol=2e-2)
    assert tuple(c.n - n for c, n in zip(counts, before)) == (3, 0, 0)


# ---------------------------------------------------------------------------
# the FMA route, GQA / window and MLA (paged_attention_kernel,
# paged_attention_mla_kernel): split-KV over fixed runs of pieces
# ---------------------------------------------------------------------------

FMA_FORMS = {"mla": (1, 512, 64), "gqa": (16, 64, 64)}  # kvh, width, b


def _fma_attn_inputs(cuda, form, dtype, case, bs, seed=5):
    """deepseek's latent pools or qwen's K / V at `bs`-token blocks, max_len
    max(128, bs); each lane's blocks distinct (randperm)."""
    B, S, positions = MLA_CASES[case]
    kvh, width, wb = FMA_FORMS[form]
    mb = max(128, bs) // bs
    nb = B * mb + 1
    g = torch.Generator(device=cuda).manual_seed(seed)
    dk = width + wb if form == "mla" else width
    q = torch.randn(B, S, 16, dk, generator=g, device=cuda).to(dtype)
    shape = (nb, bs) if form == "mla" else (nb, bs, kvh)
    a = (torch.randn(*shape, width, generator=g, device=cuda) * 0.5).to(dtype)
    b = (torch.randn(*shape, wb, generator=g, device=cuda) * 0.5).to(dtype)
    perm = torch.randperm(nb - 1, generator=g, device=cuda) + 1
    tables = perm[:B * mb].reshape(B, mb).int()
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    kw = dict(num_kv_heads=kvh, scale=1 / math.sqrt(dk), mla=form == "mla")
    return q, a, b, tables, pos, kw


def _fma_attn_plan(q, a, b, tables, kw, **pins):
    B, S, H, _ = q.shape
    kvh = kw["num_kv_heads"]
    return sched.plan_paged_attn_fma_sm90(
        batch=B, kv_heads=kvh, rows=H // kvh * S, block_size=a.shape[1],
        max_blocks=tables.shape[1], width=a.shape[-1],
        rope=b.shape[-1] if kw["mla"] else 0, mla=kw["mla"],
        kv_itemsize=a.element_size(), **pins)


@pytest.mark.parametrize("form,dtype,bs,window", [
    ("mla", torch.float32, 8, None), ("mla", torch.float32, 16, None),
    ("mla", torch.float32, 128, None), ("mla", torch.float32, 256, None),
    ("mla", torch.bfloat16, 8, None), ("mla", torch.bfloat16, 128, None),
    ("mla", torch.bfloat16, 256, None), ("gqa", torch.float32, 16, None),
    ("gqa", torch.float32, 16, 32)])
@pytest.mark.parametrize("case", ("decode", "prefill", "verify"))
def test_fma_attention_matches_plain(cuda, case, form, dtype, bs, window):
    # the FMA route at every split (planned, 1, 2, one run a piece) and
    # ring, each call one FMA launch of its form and dtype and, past one
    # run, one merge; nothing else
    q, a, b, tables, pos, kw = _fma_attn_inputs(cuda, form, dtype, case, bs)
    kw["window"] = window
    ref = paged_attn_ref(q, a, b, tables, pos, **kw)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    mla = kw["mla"]
    mine = {(True, torch.float32): pa.launches_mla,
            (True, torch.bfloat16): pa.launches_mla_bf16,
            (False, torch.float32): pa.launches,
            (False, torch.bfloat16): pa.launches_bf16}[(mla, dtype)]
    assert pa.attention_route(dtype, mla, bs, a.shape[-1], b.shape[-1]) == \
        ("mla" if mla else "gqa")
    most = _fma_attn_plan(q, a, b, tables, kw).pieces
    for ks in (None, 1, 2, most):
        for G in ((None, 1, 2, 4) if ks in (None, 1) else (None,)):
            plan = _fma_attn_plan(q, a, b, tables, kw, num_bufs=G,
                                  kv_splits=ks)
            before = {k: c.n for k, c in vars(pa).items()
                      if isinstance(c, pa.build.LaunchCounter)}
            out = paged_attention(q, a, b, tables, pos, num_bufs=G,
                                  kv_splits=ks, **kw)
            ran = {k: c.n - before[k] for k, c in vars(pa).items()
                   if isinstance(c, pa.build.LaunchCounter)}
            want = {k: 0 for k in ran}
            want[next(k for k, c in vars(pa).items() if c is mine)] = 1
            want["launches_merge"] = int(plan.kv_splits > 1)
            assert ran == want, (ks, G)
            assert out.shape == (*q.shape[:3], a.shape[-1])
            torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("form,dtype", [("mla", torch.float32),
                                        ("mla", torch.bfloat16),
                                        ("gqa", torch.float32)])
def test_fma_attention_matches_the_split_replay(cuda, form, dtype):
    # at decode, against the plain replay of the same split
    # (kernels.ref.paged_attn_fma_split_ref): f32 the same maths to
    # rounding, bf16 the same p rounding a run
    q, a, b, tables, pos, kw = _fma_attn_inputs(cuda, form, dtype,
                                                "decode", 16)
    plan = _fma_attn_plan(q, a, b, tables, kw)
    out = paged_attention(q, a, b, tables, pos, **kw)
    ref = paged_attn_fma_split_ref(q, a, b, tables, pos,
                                   kv_splits=plan.kv_splits,
                                   piece=plan.piece, **kw)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("form,dtype", [("mla", torch.float32),
                                        ("mla", torch.bfloat16),
                                        ("gqa", torch.float32),
                                        ("gqa", torch.bfloat16)])
@pytest.mark.parametrize("case", ("decode", "verify"))
def test_fma_merge_matches_plain(cuda, form, dtype, case):
    # the merge kernel's f32 and bf16 instances on the FMA kernel's own
    # partials (empty runs among them at one run a piece)
    q, a, b, tables, pos, kw = _fma_attn_inputs(cuda, form, dtype, case, 16)
    plan = _fma_attn_plan(q, a, b, tables, kw)
    assert plan.kv_splits > 1
    B, S, H, _ = q.shape
    q2 = pa._q_rows(q, kw["scale"], plan.kv_heads, dtype)
    ws = torch.full((plan.workspace_floats(),), float("nan"), device=cuda)
    out = torch.empty((B, plan.kv_heads, plan.rows, plan.width), dtype=dtype,
                      device=cuda)
    pa._launch_fma_split(q2, a, b, tables, pos, plan, out, ws, S=S,
                         window=None)
    pa._launch_merge(ws, out, plan.units, plan.row_tiles, plan.kv_splits,
                     plan.width, plan.rows)
    ref = mla_merge_ref(torch.nan_to_num(ws, nan=0.0, neginf=-math.inf),
                        batch=B * plan.kv_heads, row_tiles=plan.row_tiles,
                        kv_splits=plan.kv_splits, latent=plan.width,
                        rows=plan.rows, dtype=dtype)
    got = out.reshape(B * plan.kv_heads, plan.rows, plan.width)
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2,
                                   atol=1e-2)


@pytest.mark.parametrize("kv_splits", (1, 2))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
@pytest.mark.parametrize("form,dtype", [("mla", torch.float32),
                                        ("mla", torch.bfloat16),
                                        ("gqa", torch.float32)])
def test_fma_issue_order_is_the_chunk_schedule(cuda, form, dtype, G,
                                               kv_splits):
    # the first run of >= 4 live pieces records: MLA (8-token pieces) lane
    # 2 at position 40, 6 live pieces in one run at kv_splits 1 and 2; GQA
    # (16-token pieces) lane 3 at 100, 7 live pieces at 1, runs of 4 and 3
    # at 2
    q, a, b, tables, pos, kw = _fma_attn_inputs(cuda, form, dtype,
                                                "decode", 16)
    got, steps, g_used, C, cta = pa.issue_order_fma(
        q, a, b, tables, pos, num_kv_heads=kw["num_kv_heads"],
        scale=kw["scale"], mla=kw["mla"], num_bufs=G, kv_splits=kv_splits)
    assert (steps, cta) == {("mla", 1): (6, 2), ("mla", 2): (6, 4),
                            ("gqa", 1): (7, 48),
                            ("gqa", 2): (4, 96)}[(form, kv_splits)]
    assert G is None or g_used == G
    assert got == chunk_issue_schedule(steps, g_used, C)


@pytest.mark.parametrize("form,dtype,bs", [
    ("mla", torch.float32, 16), ("mla", torch.float32, 128),
    ("mla", torch.bfloat16, 8), ("gqa", torch.float32, 16),
    ("gqa", torch.bfloat16, 8)])
def test_fma_attention_is_bitwise_repeatable(cuda, form, dtype, bs):
    q, a, b, tables, pos, kw = _fma_attn_inputs(cuda, form, dtype,
                                                "verify", bs)
    first = paged_attention(q, a, b, tables, pos, **kw)
    for _ in range(3):
        assert torch.equal(paged_attention(q, a, b, tables, pos, **kw),
                           first)


@pytest.mark.parametrize("window", (None, 6))
@pytest.mark.parametrize("form,bs", [("mla", 16), ("mla", 8), ("mla", 128),
                                     ("gqa", 16)])
def test_fma_rows_do_not_depend_on_the_step(cuda, form, bs, window):
    # f32: a token's row is the same bits in a decode step (one query a
    # lane) and in a verify step (5 queries a lane from an earlier
    # position), as speculation on == off needs; spans inside a piece and
    # across pieces and blocks, dead and expired pieces in some runs
    q, a, b, tables, pos, kw = _fma_attn_inputs(cuda, form, torch.float32,
                                           "verify", bs)
    kw["window"] = window
    S = q.shape[1]
    for start in ([3, 30, 64, 90], [13, 29, 46, 94]):
        p0 = torch.tensor(start, dtype=torch.int32, device=cuda)
        ver = paged_attention(q, a, b, tables, p0, **kw)
        for s in range(S):
            dec = paged_attention(q[:, s:s + 1].contiguous(), a, b, tables,
                                  p0 + s, **kw)
            assert torch.equal(dec[:, 0], ver[:, s])


@pytest.mark.parametrize("form,dtype", [("mla", torch.float32),
                                        ("mla", torch.bfloat16),
                                        ("gqa", torch.float32)])
@pytest.mark.parametrize("bs", (8, 16, 128, 256))
def test_fma_launch_smem_is_planned(cuda, form, dtype, bs):
    # the launch asks for exactly the planner's shared memory, at the
    # planned ring and at pinned rings and pieces
    q, a, b, tables, pos, kw = _fma_attn_inputs(cuda, form, dtype,
                                                "decode", bs)
    for pins in ({}, dict(num_bufs=2), dict(num_bufs=4, kv_splits=1),
                 dict(piece=min(8, bs), num_bufs=3)):
        plan = _fma_attn_plan(q, a, b, tables, kw, **pins)
        assert pa.fma_smem_bytes(plan) == plan.smem_bytes
        assert plan.smem_bytes <= sched.SMEM_BUDGET_BYTES


# ---------------------------------------------------------------------------
# bf16 GQA / window on the tensor cores (paged_attention_tc_kernel)
# ---------------------------------------------------------------------------

GQA_CASES = {"decode": (4, 1, [5, 17, 40, 100]),
             "prefill": (1, 32, [37]),
             "verify": (4, 5, [3, 30, 64, 90])}
GQA_HEADS = {64: 16, 128: 4, 256: 8}       # head_dim -> KV heads (16 heads)


def _gqa_inputs(cuda, case, hd, seed=2, dtype=torch.bfloat16):
    B, S, positions = GQA_CASES[case]
    kvh, bs, mb, nb = GQA_HEADS[hd], 16, 8, 33
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(B, S, 16, hd, generator=g, device=cuda).to(dtype)
    k = (torch.randn(nb, bs, kvh, hd, generator=g, device=cuda) * 0.5
         ).to(dtype)
    v = (torch.randn(nb, bs, kvh, hd, generator=g, device=cuda) * 0.5
         ).to(dtype)
    tables = torch.randint(1, nb, (B, mb), generator=g, device=cuda,
                           dtype=torch.int32)
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda)
    return q, k, v, tables, pos, kvh


@pytest.mark.parametrize("window", (None, 32))
@pytest.mark.parametrize("hd", (64, 128, 256))
@pytest.mark.parametrize("case", ("decode", "prefill", "verify"))
def test_gqa_tc_matches_plain(cuda, case, hd, window):
    # bf16 GQA takes the tensor-core kernel at every ring depth and split
    # (its merge with more than one run), never the FMA kernel
    q, k, v, tables, pos, kvh = _gqa_inputs(cuda, case, hd)
    kw = dict(num_kv_heads=kvh, scale=1 / math.sqrt(hd), window=window)
    ref = paged_attn_ref(q, k, v, tables, pos, **kw)
    counts = (pa.launches_tc, pa.launches_merge, pa.launches,
              pa.launches_bf16)
    before = [c.n for c in counts]
    for G in (None, 1, 2, 4):
        for ks in (None, 1, 2):
            out = paged_attention(q, k, v, tables, pos, num_bufs=G,
                                  kv_splits=ks, **kw)
            assert out.shape == q.shape
            torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                                       atol=2e-2)
    # kv_splits None plans 8 runs (MB = 8): a merge; 2 runs: a merge
    assert tuple(c.n - n for c, n in zip(counts, before)) == (12, 8, 0, 0)


@pytest.mark.parametrize("case", ("decode", "verify"))
def test_gqa_fma_route_pinned_on_bf16(cuda, case):
    # the FMA kernel's bf16 instance still takes bf16 (pinned, and at the
    # shapes the tensor-core plan does not take), counted on its own
    q, k, v, tables, pos, kvh = _gqa_inputs(cuda, case, 64)
    kw = dict(num_kv_heads=kvh, scale=0.125)
    ref = paged_attn_ref(q, k, v, tables, pos, **kw)
    before = (pa.launches_bf16.n, pa.launches_tc.n)
    out = paged_attention(q, k, v, tables, pos, route="gqa", **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    q32 = torch.zeros(1, 1, 16, 32, device=cuda).bfloat16()   # head_dim 32
    pools = torch.zeros(3, 16, 16, 32, device=cuda).bfloat16()
    paged_attention(q32, pools, pools,
                    torch.ones(1, 2, dtype=torch.int32, device=cuda),
                    torch.zeros(1, dtype=torch.int32, device=cuda),
                    num_kv_heads=16, scale=0.1)
    assert (pa.launches_bf16.n - before[0], pa.launches_tc.n - before[1]) \
        == (2, 0)
    with pytest.raises(ValueError, match="route"):
        paged_attention(q, k, v, tables, pos, route="mla_tc", **kw)


@pytest.mark.parametrize("hd", (64, 256))
@pytest.mark.parametrize("case", ("decode", "prefill", "verify"))
def test_gqa_merge_matches_plain(cuda, case, hd):
    # the shared merge kernel on the GQA kernel's own partials (rows past
    # rS never written, runs that are all dead at decode)
    q, k, v, tables, pos, kvh = _gqa_inputs(cuda, case, hd)
    B, S, H, _ = q.shape
    plan = sched.plan_paged_attn_gqa_tc_sm90(
        batch=B, kv_heads=kvh, rows=H // kvh * S, block_size=16,
        max_blocks=8, head_dim=hd)
    assert plan.kv_splits == 8
    q2 = pa._q_rows(q, 1 / math.sqrt(hd), kvh, q.dtype)
    ws = torch.full((plan.workspace_floats(),), float("nan"), device=cuda)
    out = torch.empty(q2.shape, dtype=torch.bfloat16, device=cuda)
    pa._launch_gqa_split(q2, k, v, tables, pos, plan, out, ws, S=S,
                         window=None)
    pa._launch_merge(ws, out, plan.units, plan.row_tiles, plan.kv_splits,
                     hd, plan.rows)
    ref = mla_merge_ref(torch.nan_to_num(ws, nan=0.0, neginf=-math.inf),
                        batch=B * kvh,
                        row_tiles=plan.row_tiles, kv_splits=plan.kv_splits,
                        latent=hd, rows=plan.rows)
    torch.testing.assert_close(out.reshape(B * kvh, plan.rows, hd).float(),
                               ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("hd", (64, 128, 256))
@pytest.mark.parametrize("case", ("decode", "prefill", "verify"))
def test_gqa_tc_occupancy_is_planned(cuda, case, hd):
    B, S, _ = GQA_CASES[case]
    kvh = GQA_HEADS[hd]
    plan = sched.plan_paged_attn_gqa_tc_sm90(
        batch=B, kv_heads=kvh, rows=16 // kvh * S, block_size=16,
        max_blocks=8, head_dim=hd)
    assert pa.gqa_tc_ctas_per_sm(plan) >= plan.ctas_per_sm


@pytest.mark.parametrize("kv_splits", (1, 2))
@pytest.mark.parametrize("G", (None, 1, 2, 4))
def test_gqa_tc_issue_order_is_the_chunk_schedule(cuda, G, kv_splits):
    # decode lane 3 (position 100) holds 7 live blocks: one run of 7 at
    # kv_splits 1, runs of 4 and 3 at 2; the first run of >= 4 records
    q, k, v, tables, pos, kvh = _gqa_inputs(cuda, "decode", 64)
    got, steps, g_used, C, cta = pa.issue_order_gqa(
        q, k, v, tables, pos, num_kv_heads=kvh, scale=0.125, num_bufs=G,
        kv_splits=kv_splits)
    assert steps == (7 if kv_splits == 1 else 4)
    assert cta == 3 * kvh * kv_splits
    assert G is None or g_used == min(G, 8 // kv_splits)
    assert got == chunk_issue_schedule(steps, g_used, C)


@pytest.mark.parametrize("window", (None, 6))
@pytest.mark.parametrize("hd", (64, 128))
def test_gqa_tc_rows_do_not_depend_on_the_step(cuda, hd, window):
    # a token's row is the same bits in a decode step (one row a lane) and
    # in a verify step (5 rows a lane from an earlier position), with spans
    # inside a block and across into the next, as speculation on == off
    # needs; a prefill chunk (one lane of 20 rows) too
    q, k, v, tables, pos, kvh = _gqa_inputs(cuda, "verify", hd)
    B, S, H, _ = q.shape
    kw = dict(num_kv_heads=kvh, scale=1 / math.sqrt(hd), window=window)
    for start in ([3, 30, 64, 90], [13, 29, 46, 94]):
        p0 = torch.tensor(start, dtype=torch.int32, device=cuda)
        ver = paged_attention(q, k, v, tables, p0, **kw)
        for s in range(S):
            dec = paged_attention(q[:, s:s + 1].contiguous(), k, v, tables,
                                  p0 + s, **kw)
            assert torch.equal(dec[:, 0], ver[:, s])
    pre = paged_attention(q.reshape(1, B * S, H, hd), k, v,
                          tables[:1], p0[:1], **kw)
    one = paged_attention(q.reshape(1, B * S, H, hd)[:, 7:8].contiguous(),
                          k, v, tables[:1], p0[:1] + 7, **kw)
    assert torch.equal(pre[:, 7], one[:, 0])


# ---------------------------------------------------------------------------
# RMSNorm (rmsnorm_kernel)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("width", (512, 1024, 1536, 2048, 104))
def test_rmsnorm_matches_plain(cuda, width, dtype):
    g = torch.Generator(device=cuda).manual_seed(4)
    wide = (torch.randn(32, width + 64, generator=g, device=cuda) * 2
            ).to(dtype)
    scale = (1 + 0.1 * torch.randn(width, generator=g, device=cuda)
             ).to(dtype)
    before = rn.launches_rmsnorm.n
    for n in (1, 4, 5, 20, 32):
        for x in (wide[:n, :width], wide[:n, :width].contiguous()):
            y = rn.rmsnorm(x, scale)
            ref = rmsnorm_ref(x, scale)
            if dtype == torch.float32:
                torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)
            else:   # one bf16 step of the plain value
                step = torch.exp2(torch.floor(torch.log2(
                    ref.float().abs().clamp(min=2.0 ** -126))) - 7)
                assert bool(((y.float() - ref.float()).abs() <= step).all())
    assert rn.launches_rmsnorm.n - before == 10


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("width", (512, 1024, 1536, 2048))
def test_rmsnorm_rows_do_not_depend_on_the_batch(cuda, width, dtype):
    # a row's bits at 1, 5 and 32 rows, at any place in the batch, strided
    g = torch.Generator(device=cuda).manual_seed(5)
    wide = (torch.randn(32, width + 64, generator=g, device=cuda) * 2
            ).to(dtype)
    x = wide[:, :width].contiguous()
    scale = (1 + 0.1 * torch.randn(width, generator=g, device=cuda)
             ).to(dtype)
    full = rn.rmsnorm(x, scale)
    for i in (0, 13, 31):
        assert torch.equal(rn.rmsnorm(x[i:i + 1], scale), full[i:i + 1])
    assert torch.equal(rn.rmsnorm(x[:5], scale), full[:5])
    assert torch.equal(rn.rmsnorm(wide[:, :width], scale), full)
    perm = torch.randperm(32, generator=g, device=cuda)
    assert torch.equal(rn.rmsnorm(x[perm], scale), full[perm])
    lanes = x[:20].reshape(4, 5, width)
    assert torch.equal(rn.rmsnorm(lanes[:, :1].contiguous(), scale)[:, 0],
                       rn.rmsnorm(lanes, scale)[:, 0])


def test_rmsnorm_rejects_what_it_cannot_take(cuda):
    x = torch.zeros(2, 100, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        rn.rmsnorm(x, torch.ones(100, device=cuda))
    with pytest.raises(TypeError):
        rn.rmsnorm(torch.zeros(2, 64, device=cuda).half(),
                   torch.ones(64, device=cuda).half())
    with pytest.raises(TypeError):             # the scale in x's dtype
        rn.rmsnorm(torch.zeros(2, 64, device=cuda).bfloat16(),
                   torch.ones(64, device=cuda))
    with pytest.raises(ValueError, match="width"):
        rn.rmsnorm(torch.zeros(2, 64, device=cuda),
                   torch.ones(32, device=cuda))
