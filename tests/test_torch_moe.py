"""The port's grouped product and MoE layer against the JAX package on the
CPU, on the same numpy inputs and parameters.

`ops.dense_grouped(mode="ref")` / `kernels.ref.dense_grouped_ref` (the CUDA
`gpp_matmul_grouped`'s plain version) are held against JAX's
`gpp_matmul_grouped` in Pallas interpret mode and its `dense_grouped_ref`;
`moe_apply` and `_dispatch` against JAX's mesh-less path.

Tolerances: float32 1e-5 on the products (same f32 maths, another
summation order), 1e-3 absolute on int8 dequant (integer-valued sums of
hundreds of terms times a scale); 1e-4 on the MoE layer.  bf16 MoE rtol
2e-2, atol 0.1 (three bf16 ulps at the outputs' |y| ~ 5): the JAX CPU path
multiplies the experts in bf16 (`dense_grouped` ref einsum), the port
accumulates in f32 and rounds once (the kernel's numerics).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import gpp_matmul as jgm
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.kernels import ops
from repro_torch.kernels.ref import dense_grouped_ref
from repro_torch.models import moe as M

from _torch_parity import np32, t, tree_to_torch

pytestmark = pytest.mark.tier1

F32 = dict(rtol=1e-5, atol=1e-5)


def _grouped(E, C, D, F, seed=0, int8=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, C, D)).astype(np.float32)
    if int8:
        w = rng.integers(-127, 128, (E, D, F)).astype(np.int8)
    else:
        w = (rng.standard_normal((E, D, F)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((E, F)) * 0.1).astype(np.float32)
    return x, w, b


class TestDenseGroupedParity:
    @pytest.mark.parametrize("G", (1, 2, 4))
    def test_ring_depths_match_interpret_kernel(self, G):
        x, w, b = _grouped(3, 17, 48, 256)
        want = jgm.gpp_matmul_grouped(
            jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
            activation="silu", block_m=8, block_n=128, block_k=16,
            num_bufs=G, interpret=True)
        got = ops.dense_grouped(t(x), t(w), bias=t(b), activation="silu",
                                mode="ref")
        np.testing.assert_allclose(np32(got), np32(want), **F32)

    def test_ragged_capacity(self):
        """E/C/D/F that divide no tile size."""
        x, w, b = _grouped(5, 13, 24, 40, seed=1)
        want = jgm.gpp_matmul_grouped(jnp.asarray(x), jnp.asarray(w),
                                      bias=jnp.asarray(b), activation="silu",
                                      interpret=True)
        got = dense_grouped_ref(t(x), t(w), bias=t(b), activation="silu")
        np.testing.assert_allclose(np32(got), np32(want), **F32)
        ref = jref.dense_grouped_ref(jnp.asarray(x), jnp.asarray(w),
                                     bias=jnp.asarray(b), activation="silu")
        np.testing.assert_allclose(np32(got), np32(ref), **F32)

    @pytest.mark.parametrize("scale_shape", ("scalar", "per_expert",
                                             "per_col"))
    def test_int8_with_scale(self, scale_shape):
        x, w, _ = _grouped(3, 13, 64, 96, seed=2, int8=True)
        full = (np.random.default_rng(3).random((3, 96)) * 0.02
                + 1e-3).astype(np.float32)
        scale = {"scalar": full[0, 0], "per_expert": full[:, 0],
                 "per_col": full}[scale_shape]
        want = jgm.gpp_matmul_grouped(jnp.asarray(x), jnp.asarray(w),
                                      w_scale=jnp.asarray(scale),
                                      activation="silu", interpret=True)
        got = ops.dense_grouped(t(x), t(w), w_scale=torch.as_tensor(scale),
                                activation="silu")
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5,
                                   atol=1e-3)
        ref = jref.dense_grouped_ref(jnp.asarray(x), jnp.asarray(w),
                                     w_scale=jnp.asarray(scale),
                                     activation="silu")
        np.testing.assert_allclose(np32(got), np32(ref), rtol=1e-5,
                                   atol=1e-3)

    def test_shape_and_mode_checks(self):
        x = torch.zeros(2, 4, 8)
        with pytest.raises(ValueError, match="grouped shape mismatch"):
            ops.dense_grouped(x, torch.zeros(3, 8, 16))
        with pytest.raises(ValueError, match="wants"):
            ops.dense_grouped(torch.zeros(4, 8), torch.zeros(3, 8, 16))
        with pytest.raises(ValueError):       # no kernel for a CPU tensor
            ops.dense_grouped(x, torch.zeros(2, 8, 16), mode="kernel")


# ---------------------------------------------------------------------------
# the MoE layer (deepseek-v2-lite-16b SMOKE widths)
# ---------------------------------------------------------------------------

SMOKE = dict(d_model=64, d_ff=32, num_experts=8, experts_per_token=2,
             num_shared_experts=2)


def _moe(dtype="float32", **kw):
    jc = JM.MoeConfig(**SMOKE, dtype=jnp.dtype(dtype), **kw)
    pc = M.MoeConfig(**SMOKE, dtype=getattr(torch, dtype), **kw)
    jp = JL.init_from_specs(JM.moe_specs(jc), jax.random.PRNGKey(0),
                            scale=0.2)
    return jc, pc, jp, tree_to_torch(jp)


def _x(B, S, seed=5, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(
        (B, S, 64)).astype(dtype)


class TestMoeParity:
    @pytest.mark.parametrize("B,S", ((4, 1), (1, 32), (4, 5)))
    def test_moe_apply_matches_jax(self, B, S):
        """The serving path's three token counts (decode, prefill chunk,
        verify)."""
        jc, pc, jp, pp = _moe()
        x = _x(B, S)
        want = JM.moe_apply(jp, jc, jnp.asarray(x))
        got = M.moe_apply(pp, pc, t(x))
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-4,
                                   atol=1e-4)

    def test_dropped_tokens_match_jax(self):
        """capacity_factor 0.25 in one dispatch group of 64 tokens: C = 8
        slots for ~16 routed entries an expert, so most entries drop."""
        jc, pc, jp, pp = _moe(capacity_factor=0.25, dispatch_groups=1)
        x = _x(1, 64, seed=6)
        C = JM.capacity(jc, 64)
        assert C == M.capacity(pc, 64) == 8
        _, jmeta = JM._dispatch(jp, jc, jnp.asarray(x[0]), C)
        assert not bool(np.asarray(jmeta[2]).all())     # some tokens drop
        want = JM.moe_apply(jp, jc, jnp.asarray(x))
        got = M.moe_apply(pp, pc, t(x))
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-4,
                                   atol=1e-4)

    def test_dispatch_metadata(self):
        jc, pc, jp, pp = _moe(capacity_factor=0.5, dispatch_groups=1)
        x = _x(1, 40, seed=7)[0]
        C = M.capacity(pc, 40)
        jbuf, jmeta = JM._dispatch(jp, jc, jnp.asarray(x), C)
        buf, meta = M._dispatch(pp, pc, t(x)[None], C)
        for name, a, b in zip(("sorted_e", "slot", "keep", "token_idx"),
                              meta, jmeta):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b),
                                          err_msg=name)
        np.testing.assert_allclose(meta[4][0].numpy(), np.asarray(jmeta[4]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(np32(buf[0]), np32(jbuf), rtol=0, atol=0)
        s = meta[0][0].numpy()
        assert (np.diff(s) >= 0).all()                  # sorted by expert

    def test_router_weight_goes_in_its_stored_dtype(self, monkeypatch):
        """A bf16 model's router weight reaches `dense` as stored, with f32
        x (the reference's astype is folded into the kernel's load, which
        widens bf16 exactly): the logits are the bits of the f32 copy, and
        the routing is JAX's."""
        jc, pc, jp, pp = _moe("bfloat16", capacity_factor=0.5,
                              dispatch_groups=1)
        assert pp["router"].dtype == torch.bfloat16
        seen = []

        def spy(x, w, **kw):
            seen.append((x.dtype, w.dtype, w.data_ptr()))
            return ops.dense(x, w, **kw)

        monkeypatch.setattr(M, "dense", spy)
        x = jnp.asarray(_x(1, 40, seed=11)[0], jnp.bfloat16)
        C = M.capacity(pc, 40)
        _, meta = M._dispatch(pp, pc, t(x)[None], C)
        assert seen == [(torch.float32, torch.bfloat16,
                         pp["router"].data_ptr())]          # no copy
        xt = t(x).float()
        assert torch.equal(ops.dense(xt, pp["router"], mode="ref"),
                           ops.dense(xt, pp["router"].float(), mode="ref"))
        _, jmeta = JM._dispatch(jp, jc, x, C)
        for name, a, b in zip(("sorted_e", "slot", "keep", "token_idx"),
                              meta, jmeta):
            np.testing.assert_array_equal(a[0].numpy(), np.asarray(b),
                                          err_msg=name)

    def test_bf16(self):
        jc, pc, jp, pp = _moe("bfloat16")
        x = _x(4, 5, seed=8)
        xb = jnp.asarray(x, jnp.bfloat16)
        want = JM.moe_apply(jp, jc, xb)
        got = M.moe_apply(pp, pc, t(xb))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(np32(got), np32(want), rtol=2e-2,
                                   atol=0.1)

    def test_combine_is_deterministic_and_ordered(self):
        """Each token's k contributions add in sorted-entry order, one
        storage-dtype rounding after each add (the reference's scatter)."""
        _, pc, _, pp = _moe("bfloat16")
        x = t(jnp.asarray(_x(2, 8, seed=9), jnp.bfloat16))
        a = M.moe_apply(pp, pc, x)
        b = M.moe_apply(pp, pc, x)
        assert torch.equal(a, b)
        G, Tg, k, D = 1, 3, 2, 4
        out_buf = torch.arange(2 * 3 * D, dtype=torch.float32).reshape(
            G, 2, 3, D).to(torch.bfloat16)
        meta = (torch.tensor([[0, 0, 0, 1, 1, 1]]),        # sorted_e
                torch.tensor([[0, 1, 2, 0, 1, 2]]),        # slot
                torch.ones(1, 6, dtype=torch.bool),        # keep
                torch.tensor([[2, 0, 1, 0, 2, 1]]),        # token_idx
                torch.full((1, 6), 0.5))                   # w
        got = M._combine(out_buf, meta, Tg, torch.bfloat16)[0]
        rows = out_buf[0].reshape(6, D) * 0.5
        want = torch.stack([rows[1] + rows[3], rows[2] + rows[5],
                            rows[0] + rows[4]])
        assert torch.equal(got, want)
