"""The port's kernel entry points against the JAX package on the CPU.

On a CPU tensor `repro_torch.kernels.ops.dense` / `dense_grouped` /
`paged_attn` run the kernels' plain versions (`kernels.ref`); here they are
held against the JAX functions on the same numpy inputs — `gpp_matmul`,
`gpp_matmul_grouped` and `paged_attention` in Pallas interpret mode at tiny
shapes, as the JAX package's own tests run them.  The kernel wrappers
themselves take CUDA tensors only (tests/test_torch_cuda.py runs them on
the card); here they must refuse a CPU tensor.

Tolerances: float32 1e-5 (same f32 maths, another summation order); bf16
outputs 2e-2 (one bf16 rounding of two f32 sums that differ in order).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import gpp_matmul as jgm
from repro.kernels import ops as jops
from repro.kernels.paged_attention import paged_attention as j_paged_attention
from repro_torch.core import schedule as sched
from repro_torch.kernels import ops
from repro_torch.kernels.gpp_matmul import gpp_matmul, gpp_matmul_grouped
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ref import (chunk_issue_schedule, dense_ref,
                                     paged_attn_ref)

from repro_torch.kernels import ref as kref
from repro_torch.kernels.ref import ACTIVATIONS

from _torch_parity import np32, t

pytestmark = pytest.mark.tier1

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _mats(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return x, w, b


# ---------------------------------------------------------------------------
# kernel 1: dense / gpp_matmul
# ---------------------------------------------------------------------------

class TestDenseParity:
    @pytest.mark.parametrize("G", (1, 2, 4))
    def test_ring_depths_match_interpret_kernel(self, G):
        x, w, b = _mats(24, 128, 300)            # ragged N against block_n
        want = jgm.gpp_matmul(jnp.asarray(x), jnp.asarray(w),
                              bias=jnp.asarray(b), block_n=128, num_bufs=G,
                              interpret=True)
        # the ring depth is the kernel's schedule, not its arithmetic: the
        # plain version gives every G's result
        got = dense_ref(t(x), t(w), bias=t(b))
        np.testing.assert_allclose(np32(got), np32(want), **F32)

    @pytest.mark.parametrize("act", ("relu", "gelu", "silu", "tanh",
                                     "sigmoid", "none"))
    def test_epilogue_activations(self, act):
        x, w, b = _mats(8, 64, 128, seed=1)
        want = jgm.gpp_matmul(jnp.asarray(x), jnp.asarray(w),
                              bias=jnp.asarray(b), activation=act,
                              block_m=8, block_n=128, block_k=64, num_bufs=3,
                              interpret=True)
        got = ops.dense(t(x), t(w), bias=t(b), activation=act)
        np.testing.assert_allclose(np32(got), np32(want), **F32)

    def test_gelu_is_the_tanh_form(self):
        x = torch.linspace(-4, 4, 101)
        got = ops.dense(x[:, None], torch.ones(1, 1), activation="gelu")[:, 0]
        want = np.asarray(jops._ACTIVATIONS["gelu"](jnp.asarray(x.numpy())))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("scale_shape", ("scalar", "per_column"))
    def test_int8_weights_with_scale(self, scale_shape):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((16, 128)).astype(np.float32)
        w = rng.integers(-127, 128, (128, 256)).astype(np.int8)
        scale = (np.float32(0.01) if scale_shape == "scalar" else
                 (rng.random(256) * 0.02).astype(np.float32))
        want = jgm.gpp_matmul(jnp.asarray(x), jnp.asarray(w),
                              w_scale=jnp.asarray(scale), block_m=16,
                              block_n=128, block_k=128, num_bufs=2,
                              interpret=True)
        got = dense_ref(t(x), t(w), w_scale=torch.as_tensor(scale))
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5,
                                   atol=1e-4)

    def test_bf16_streaming(self):
        x, w, b = _mats(16, 128, 128, seed=3)
        xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
        want = jgm.gpp_matmul(xb, wb, block_m=16, block_n=128, block_k=128,
                              num_bufs=3, interpret=True)
        got = ops.dense(t(xb), t(wb), mode="ref")
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(np32(got), np32(want), **BF16)

    @pytest.mark.parametrize("contract_dims", (1, 2))
    def test_einsum_shaped_adapter(self, contract_dims):
        rng = np.random.default_rng(4)
        if contract_dims == 1:                    # q-proj bsd,dhk->bshk
            x = rng.standard_normal((2, 3, 32)).astype(np.float32)
            w = (rng.standard_normal((32, 4, 8)) * 0.1).astype(np.float32)
            b = rng.standard_normal((4, 8)).astype(np.float32)
        else:                                     # o-proj bshk,hkd->bsd
            x = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)
            w = (rng.standard_normal((4, 8, 32)) * 0.1).astype(np.float32)
            b = rng.standard_normal(32).astype(np.float32)
        want = jops.dense(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
                          mode="ref", contract_dims=contract_dims)
        got = ops.dense(t(x), t(w), bias=t(b), contract_dims=contract_dims)
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(np32(got), np32(want), **F32)

    def test_ref_mode_scale_matches_jax_ref(self):
        rng = np.random.default_rng(5)
        x = rng.standard_normal((4, 64)).astype(np.float32)
        w = rng.integers(-127, 128, (64, 32)).astype(np.int8)
        scale = (rng.random(32) * 0.02).astype(np.float32)
        want = jops.dense(jnp.asarray(x), jnp.asarray(w, jnp.float32),
                          w_scale=jnp.asarray(scale), mode="ref")
        got = ops.dense(t(x), t(w), w_scale=torch.as_tensor(scale),
                        mode="ref")
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5,
                                   atol=1e-4)

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        x, w = torch.zeros(4, 8), torch.zeros(8, 16)
        with pytest.raises(ValueError, match="CUDA"):
            gpp_matmul(x, w)
        with pytest.raises(ValueError, match="CUDA"):
            gpp_matmul_grouped(x[None], w[None])
        q = torch.zeros(1, 1, 4, 16)
        k = torch.zeros(3, 8, 2, 16)
        tb = torch.zeros(1, 2, dtype=torch.int32)
        pos = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="CUDA"):
            paged_attention(q, k, k, tb, pos, num_kv_heads=2, scale=1.0)
        ckv, kr = torch.zeros(3, 8, 12), torch.zeros(3, 8, 4)
        with pytest.raises(ValueError, match="CUDA"):
            paged_attention(q, ckv, kr, tb, pos, num_kv_heads=1, scale=1.0,
                            mla=True)

    def test_modes(self):
        x = torch.zeros(2, 8)
        w = torch.zeros(8, 4)
        with pytest.raises(ValueError):
            ops.dense(x, w, mode="interpret")
        with pytest.raises(ValueError):      # no kernel for a CPU tensor
            ops.dense(x, w, mode="kernel")
        with pytest.raises(ValueError):
            ops.dense(x, w, activation="swish")
        assert ops.resolve_mode("auto", x) == "ref"


class TestGroupedRefChunks:
    """`dense_grouped_ref` takes an expert stack a chunk of experts at a
    time (no f32 copy of a whole stack): the same function as the whole
    stack's f32 bmm and epilogue, bit for bit, except that at f32 an
    activated element may differ by an ulp (PyTorch's CPU loop for
    silu / tanh-gelu rounds the elements of a tensor's vectorised body and
    of its tail by two code paths, so where an element falls depends on the
    tensor's size)."""

    @staticmethod
    def _whole(x, w, bias, w_scale, act):
        acc = torch.bmm(x.float(), w.float())
        if w_scale is not None:
            sc = torch.as_tensor(w_scale, dtype=torch.float32)
            acc = acc * (sc if sc.dim() == 0 else sc.reshape(
                x.shape[0], 1, -1))
        if bias is not None:
            acc = acc + bias.float()[:, None, :]
        return ACTIVATIONS[act](acc).to(x.dtype)

    @pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
    @pytest.mark.parametrize("scale", (None, "scalar", "expert", "column"))
    @pytest.mark.parametrize("act", (None, "silu", "gelu"))
    def test_chunks_equal_whole_stack(self, monkeypatch, dtype, scale, act):
        monkeypatch.setattr(kref, "GROUPED_REF_CHUNK_ELEMS", 3 * 24 * 40)
        E, M, K, N = 11, 5, 24, 40
        assert kref.grouped_ref_chunk(E, K, N) == 3     # 4 chunks, one short
        g = torch.Generator().manual_seed(2)
        x = torch.randn(E, M, K, generator=g).to(dtype)
        w = (torch.randn(E, K, N, generator=g) * 0.1).to(dtype)
        bias = (torch.randn(E, N, generator=g) * 0.1).to(dtype)
        w_scale = {None: None, "scalar": torch.tensor(0.5),
                   "expert": torch.rand(E, generator=g),
                   "column": torch.rand(E, N, generator=g)}[scale]
        got = kref.dense_grouped_ref(x, w, bias=bias, w_scale=w_scale,
                                     activation=act)
        assert got.dtype == dtype and got.shape == (E, M, N)
        want = self._whole(x, w, bias, w_scale, act)
        if act is None or dtype == torch.bfloat16:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=2.0 ** -22,
                                       atol=1e-7)

    def test_chunk_count(self):
        # kimi-k2's expert stack: 4 experts a chunk (256 MB of f32 W)
        assert kref.grouped_ref_chunk(384, 7168, 2048) == 4
        assert kref.grouped_ref_chunk(64, 2048, 1408) == 23
        assert kref.grouped_ref_chunk(8, 64, 32) == 8


class TestStreamedWorkload:
    """The paper's consecutive-GeMM workload and its ring-depth plan against
    the reference's (`repro.kernels.ops`): the port's plain path on the CPU
    against the JAX interpret kernel, on the same numpy inputs."""

    @pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
    @pytest.mark.parametrize("G", (None, 1, 2, 3))
    def test_gemm_sequence_matches_reference(self, dtype, G):
        rng = np.random.default_rng(3)
        R, M, K, N = 3, 8, 256, 128
        x = rng.standard_normal((M, K)).astype(np.float32)
        ws = (rng.standard_normal((R, K, N)) * 0.05).astype(np.float32)
        jdt = getattr(jnp, dtype)
        want = jops.streamed_gemm_sequence(
            jnp.asarray(x, jdt), jnp.asarray(ws, jdt), block_n=128,
            num_bufs=G, interpret=True)
        got = ops.streamed_gemm_sequence(t(jnp.asarray(x, jdt)),
                                         t(jnp.asarray(ws, jdt)),
                                         num_bufs=G)
        assert got.shape == want.shape == (R, M, N)
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(np32(got), np32(want),
                                   **(F32 if dtype == "float32" else BF16))

    def test_rounds_fold_into_n(self):
        ws = torch.arange(2 * 3 * 4.0).reshape(2, 3, 4)
        w = ops.fold_rounds(ws)
        assert w.shape == (3, 8)
        assert torch.equal(w[:, :4], ws[0]) and torch.equal(w[:, 4:], ws[1])

    def test_streamed_matmul_matches_reference(self):
        x, w, b = _mats(16, 256, 192, seed=4)
        want = jops.streamed_matmul(jnp.asarray(x), jnp.asarray(w),
                                    bias=jnp.asarray(b), activation="silu",
                                    interpret=True)
        got = ops.streamed_matmul(t(x), t(w), bias=t(b), activation="silu")
        np.testing.assert_allclose(np32(got), np32(want), **F32)

    def test_ring_depth_at_h100_rates_and_measured(self):
        for M in (1, 8, 32, 128, 512):
            for dtype, fps in ((torch.bfloat16, sched.H100_BF16_FLOPS),
                               (torch.float32, sched.H100_F32_FLOPS)):
                es = torch.empty((), dtype=dtype).element_size()
                assert ops.plan_ring_depth(M, 4096, 256, dtype) == \
                    sched.plan_stream(
                        block_bytes=4096 * 256 * es,
                        compute_flops=2.0 * M * 4096 * 256,
                        flops_per_s=fps,
                        transfer_bytes_per_s=sched.H100_HBM_BYTES_PER_S
                    ).ring_depth
        assert ops.plan_ring_depth(8, 4096, 256) == 8
        assert ops.plan_ring_depth(128, 4096, 256) == 4
        # measured rates replace the data sheet's: a cache at the
        # reference's TPU v5e rates gives the reference's plan
        tc = sched.TimingCache()
        tc.record(block_bytes=819e3, compute_flops=197e9, t_dma=1e-6,
                  t_compute=1e-3, measured_on="compiled")
        for M, K, bn in ((8, 4096, 256), (64, 1024, 512), (512, 256, 128)):
            assert ops.plan_ring_depth(M, K, bn, timing=tc) == \
                jops.plan_ring_depth(M, K, bn)
        sched.set_default_timing_cache(tc)
        try:
            assert ops.plan_ring_depth(8, 4096, 256) == \
                jops.plan_ring_depth(8, 4096, 256)
        finally:
            sched.set_default_timing_cache(None)


class TestChunkSchedule:
    @pytest.mark.parametrize("steps,G,C", [(1, 1, 1), (7, 1, 1), (7, 2, 1),
                                           (9, 4, 3), (3, 4, 3), (16, 8, 7),
                                           (2, 8, 7)])
    def test_matches_reference_replay(self, steps, G, C):
        assert chunk_issue_schedule(steps, G, C) == \
            jgm.chunk_issue_schedule(steps, G, C)

    @pytest.mark.parametrize("G", (1, 2, 4))
    def test_every_chunk_once_before_use(self, G):
        C = max(1, G - 1)
        sched_ = chunk_issue_schedule(16, G, C)
        for s in range(16):
            for c in range(C if G > 1 else 1):
                at = sched_[(s, c)]
                assert len(at) == 1 and at[0] <= s


class TestSm90Planner:
    def test_paged_ring_and_row_splits(self):
        plan = sched.plan_paged_attn_fma_sm90(
            batch=4, kv_heads=16, rows=80, block_size=16, width=64,
            kv_itemsize=2, max_blocks=8)
        assert plan.row_tiles * 16 >= 80 and plan.row_tiles == 5
        assert 1 <= plan.num_bufs <= 8
        assert plan.smem_bytes <= sched.SMEM_BUDGET_BYTES
        pinned = sched.plan_paged_attn_fma_sm90(
            batch=4, kv_heads=16, rows=1, block_size=16, width=64,
            kv_itemsize=2, max_blocks=8, num_bufs=2)
        assert pinned.num_bufs == 2 and pinned.chunks == 1

    def test_mla_plan_rows_and_budget(self):
        for rows, es in ((16, 2), (80, 2), (512, 4)):
            plan = sched.plan_paged_attn_fma_sm90(
                batch=1, kv_heads=1, rows=rows, block_size=16, width=512,
                rope=64, mla=True, kv_itemsize=es, max_blocks=8)
            assert plan.row_tiles == -(-rows // 16)
            assert plan.smem_bytes <= sched.SMEM_BUDGET_BYTES
        # one ring of key rows (c_kv | k_rope, the value read from the same
        # row), the q tile in the KV dtype, f32 p rows
        assert sched.paged_attn_fma_smem_bytes(16, 512, 64, 2, 1, True) \
            == 16 * 1216 + 16 * 1216 + 16 * 16 * 4
        with pytest.raises(ValueError):
            sched.plan_paged_attn_fma_sm90(
                batch=1, kv_heads=1, rows=16, block_size=16, width=512,
                rope=64, mla=True, kv_itemsize=4, max_blocks=8, num_bufs=8,
                piece=16)

    def test_stream_plan_matches_reference(self):
        from repro.core import schedule as jsched
        for b, f in ((8192, 32768), (1e6, 1e9), (1e3, 0)):
            kw = dict(block_bytes=b, compute_flops=f, flops_per_s=989e12,
                      transfer_bytes_per_s=3.35e12)
            a, r = sched.plan_stream(**kw), jsched.plan_stream(**kw)
            assert (a.ring_depth, a.chunks) == (r.ring_depth, r.chunks)

    def test_serve_planners_match_reference(self):
        from repro.core import schedule as jsched
        assert sched.plan_serve_chunk(token_budget=36, decode_lanes=4,
                                      block_size=16) == \
            jsched.plan_serve_chunk(token_budget=36, decode_lanes=4,
                                    block_size=16)
        assert sched.plan_verify_budget(token_budget=36, prefill_tokens=0,
                                        decode_lanes=3) == \
            jsched.plan_verify_budget(token_budget=36, prefill_tokens=0,
                                      decode_lanes=3)
        assert sched.tokens_per_step_cov([3, 4, 5, 36]) == \
            pytest.approx(jsched.tokens_per_step_cov([3, 4, 5, 36]))


# ---------------------------------------------------------------------------
# kernel 3 (GQA/window path): paged attention
# ---------------------------------------------------------------------------

def _pools(nb, bs, kvh=2, hd=16, seed=1):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((nb, bs, kvh, hd)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((nb, bs, kvh, hd)) * 0.3).astype(np.float32)
    return k, v


PAGED_CASES = {
    # name: (nb, bs, tables, positions, S, window) — TestOpParity's shapes
    "heterogeneous": (11, 8, [[7, 2, 9, 4], [1, 5, 0, 0], [3, 6, 8, 10]],
                      [26, 9, 31], 1, None),
    "inactive_lane": (5, 8, [[1, 2, 0, 0], [0, 0, 0, 0]], [12, 0], 1, None),
    "window": (9, 8, [[1, 2, 3, 4]], [29], 1, 16),
    "prefill_unaligned": (9, 8, [[5, 1, 4, 2]], [13], 16, None),
    "prefill_window": (9, 8, [[5, 1, 4, 2]], [11], 8, 12),
    "verify": (9, 8, [[1, 2, 3, 4], [5, 6, 7, 0]], [20, 9], 3, None),
}


class TestPagedAttnParity:
    @pytest.mark.parametrize("name", sorted(PAGED_CASES))
    def test_matches_interpret_kernel(self, name):
        nb, bs, tables, positions, S, window = PAGED_CASES[name]
        k, v = _pools(nb, bs)
        B = len(tables)
        q = np.random.default_rng(2).standard_normal(
            (B, S, 4, 16)).astype(np.float32)
        tb = np.asarray(tables, np.int32)
        pos = np.asarray(positions, np.int32)
        kw = dict(num_kv_heads=2, scale=0.25, window=window)
        want = j_paged_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(tb),
                                 jnp.asarray(pos), interpret=True, **kw)
        got = ops.paged_attn(t(q), t(k), t(v), t(tb), t(pos), **kw)
        assert np.isfinite(np32(got)).all()
        np.testing.assert_allclose(np32(got), np32(want), **F32)

    def test_bf16_pools(self):
        nb, bs, tables, positions, S, window = PAGED_CASES["heterogeneous"]
        k, v = _pools(nb, bs)
        q = np.random.default_rng(3).standard_normal(
            (3, 1, 4, 16)).astype(np.float32)
        kb, vb, qb = (jnp.asarray(a, jnp.bfloat16) for a in (k, v, q))
        tb = jnp.asarray(tables, jnp.int32)
        pos = jnp.asarray(positions, jnp.int32)
        want = j_paged_attention(qb, kb, vb, tb, pos, num_kv_heads=2,
                                 scale=0.25, interpret=True)
        got = paged_attn_ref(t(qb), t(kb), t(vb), t(tb), t(pos),
                             num_kv_heads=2, scale=0.25)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(np32(got), np32(want), **BF16)

    def test_ref_mode_matches_jax_ref(self):
        nb, bs, tables, positions, S, window = PAGED_CASES["verify"]
        k, v = _pools(nb, bs)
        q = np.random.default_rng(4).standard_normal(
            (2, S, 4, 16)).astype(np.float32)
        tb, pos = np.asarray(tables, np.int32), np.asarray(positions, np.int32)
        want = jops.paged_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(tb), jnp.asarray(pos),
                               num_kv_heads=2, scale=0.25, mode="ref")
        got = ops.paged_attn(t(q), t(k), t(v), t(tb), t(pos),
                             num_kv_heads=2, scale=0.25, mode="ref")
        np.testing.assert_allclose(np32(got), np32(want), **F32)

    def test_shape_checks(self):
        k, v = _pools(5, 8)
        q = torch.zeros(2, 1, 4, 16)
        with pytest.raises(ValueError):
            paged_attention(q, t(k), t(v), torch.zeros(3, 4, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32),
                            num_kv_heads=2, scale=1.0)
        with pytest.raises(ValueError):
            paged_attention(q, t(k), t(v), torch.zeros(2, 4, dtype=torch.int32),
                            torch.zeros(2, dtype=torch.int32),
                            num_kv_heads=3, scale=1.0)
        with pytest.raises(ValueError):
            ops.paged_attn(q, t(k), t(v), torch.zeros(2, 4, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32), num_kv_heads=2,
                           scale=1.0, mode="kernel")
