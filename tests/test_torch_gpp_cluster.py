"""The cluster split-K of the tensor-core `gpp_matmul`, on the CPU: its
split comes from K and N alone, every path shape's plan as written out,
the shared memory of the ring and of the partials that reuse it, and the
plain replay (`kernels.ref.dense_cluster_ref`) against the JAX package's
`gpp_matmul` in Pallas interpret mode at the plans of path shapes and a
ragged one (f32 1e-5, bf16 2e-2), every activation with bias and scale.
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gpp_matmul as jgm
from repro_torch.core import schedule as sched
from repro_torch.kernels.ref import dense_cluster_ref, dense_ref

from _torch_parity import np32, t

pytestmark = pytest.mark.tier1

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# (K, N) of every bf16 projection on the two serving paths, and its planned
# split (block_n, cluster S, block_k)
PLANNED = {
    "qwen qkvo": ((1024, 1024), (64, 4, 256)),
    "qwen gate_up": ((1024, 2816), (128, 4, 256)),
    "qwen down": ((2816, 1024), (128, 8, 256)),
    "ds q": ((2048, 3072), (128, 4, 256)),
    "ds kv_down": ((2048, 576), (64, 8, 256)),
    "ds o": ((2048, 2048), (128, 4, 256)),
    "ds shared_gate_up": ((2048, 2816), (128, 4, 256)),
    "ds shared_down": ((2816, 2048), (128, 4, 256)),
    "ds dense_gate_up": ((2048, 10944), (128, 1, 256)),
    "ds dense_down": ((10944, 2048), (128, 4, 256)),
}
ROWS = (1, 4, 20, 32)       # one lane, decode, verify, prefill


def _split(plan):
    """Everything that fixes a row's value: the split, the k-slices and
    each (rank, k-group)'s k rows."""
    return (plan.block_n, plan.cluster, plan.block_k, plan.k_groups,
            [list(plan.k_slice(r)) for r in range(plan.cluster)],
            [plan.k_rows(r, g) for r in range(plan.cluster)
             for g in range(plan.k_groups)])


@pytest.mark.parametrize("name", PLANNED)
def test_split_comes_from_k_and_n_alone(name):
    (K, N), _ = PLANNED[name]
    splits = [_split(sched.plan_matmul_tc_sm90(M, K, N)) for M in ROWS]
    assert all(s == splits[0] for s in splits)
    # and the same at M past one m-tile
    assert _split(sched.plan_matmul_tc_sm90(200, K, N)) == splits[0]


@pytest.mark.parametrize("name", PLANNED)
def test_path_plan_is_written_out(name):
    (K, N), (bn, S, bk) = PLANNED[name]
    for M in (4, 20, 32):
        plan = sched.plan_matmul_tc_sm90(M, K, N)
        assert (plan.block_n, plan.cluster, plan.block_k) == (bn, S, bk)
        assert plan.block_m == (16 if M == 4 else 32)
        # portable clusters only, each rank at least one step, a ring of at
        # most two
        assert S <= 8 and min(plan.cta_steps(r) for r in range(S)) >= 1
        assert plan.num_bufs <= sched.GPP_MM_TC_MAX_RING


@pytest.mark.parametrize("block_n", (64, 128))
@pytest.mark.parametrize("block_m", (16, 32, 64, 128))
def test_partials_reuse_the_ring(block_m, block_n):
    # after the last step the f32 partials (one (block_m, block_n + 8) a
    # k-group) go over the ring's slots: at block_k >= 128 they fit in the
    # in-situ ring (one W slot, two x slots), so the ring sizes the shared
    # memory at every tile
    for block_k in sched.GPP_MM_TC_BLOCK_KS:
        plan = sched.plan_matmul_tc_sm90(block_m, 4096, 1024, num_bufs=1,
                                         block_n=block_n, block_k=block_k)
        assert plan.block_m == block_m
        ring = block_k * block_n * 2 + 2 * block_m * block_k * 2
        assert plan.k_groups * block_m * (block_n + 8) * 4 <= ring
        assert plan.smem_bytes == ring


def test_planned_clusters_are_portable():
    # the planner never picks the non-portable 16, whatever K and N
    for K in (64, 320, 1024, 4096, 20000):
        for N in (8, 100, 576, 1024, 5000, 30000):
            plan = sched.plan_matmul_tc_sm90(4, K, N)
            assert plan.cluster in sched.GPP_MM_TC_CLUSTERS
            assert plan.cluster <= plan.num_k


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    s = (rng.random(N) * 2 + 0.5).astype(np.float32)
    return x, w, b, s


# path shapes at their planned splits (both tile widths, single- and
# multi-step slices) and a ragged one
CASES = [(32, 1024, 1024), (20, 2048, 576), (4, 2816, 1024), (7, 1000, 1001)]


@pytest.mark.parametrize("shape", CASES)
def test_cluster_replay_matches_jax_f32(shape):
    M, K, N = shape
    plan = sched.plan_matmul_tc_sm90(M, K, N)
    x, w, b, s = _inputs(M, K, N, 20)
    want = jgm.gpp_matmul(jnp.asarray(x), jnp.asarray(w),
                          bias=jnp.asarray(b), w_scale=jnp.asarray(s),
                          activation="silu", interpret=True)
    got = dense_cluster_ref(t(x), t(w), plan, bias=t(b), w_scale=t(s),
                            activation="silu")
    np.testing.assert_allclose(np32(got), np32(want), **F32)


@pytest.mark.parametrize("shape", CASES)
def test_cluster_replay_matches_jax_bf16(shape):
    M, K, N = shape
    plan = sched.plan_matmul_tc_sm90(M, K, N)
    x, w, b, s = _inputs(M, K, N, 21)
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    want = jgm.gpp_matmul(xb, wb, bias=jnp.asarray(b),
                          w_scale=jnp.asarray(s), activation="gelu",
                          interpret=True)
    got = dense_cluster_ref(t(xb), t(wb), plan, bias=t(b), w_scale=t(s),
                            activation="gelu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), **BF16)


@pytest.mark.parametrize("act", ("relu", "gelu", "silu", "tanh", "sigmoid",
                                 "none", None))
def test_cluster_replay_every_activation(act):
    # deepseek's kv down-projection at verify: 9 tiles of 64 columns, two
    # k-groups, clusters of 8
    M, K, N = CASES[1]
    plan = sched.plan_matmul_tc_sm90(M, K, N)
    assert (plan.block_n, plan.k_groups, plan.cluster) == (64, 2, 8)
    x, w, b, s = _inputs(M, K, N, 22)
    want = jgm.gpp_matmul(jnp.asarray(x), jnp.asarray(w),
                          bias=jnp.asarray(b), w_scale=jnp.asarray(s),
                          activation=act, interpret=True)
    got = dense_cluster_ref(t(x), t(w), plan, bias=t(b), w_scale=t(s),
                            activation=act)
    np.testing.assert_allclose(np32(got), np32(want), **F32)
    np.testing.assert_allclose(
        np32(got), np32(dense_ref(t(x), t(w), bias=t(b), w_scale=t(s),
                                  activation=act)), **F32)
