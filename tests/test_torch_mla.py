"""The port's MLA paged attention against the JAX package on the CPU, on the
same numpy inputs and parameters.

- `kernels.ref.paged_attn_ref(mla=True)` (the CUDA MLA kernel's plain
  version) against JAX's `paged_attention(mla=True)` in Pallas interpret
  mode and its `paged_attn_ref(mla=True)`;
- `mla_{prefill,decode,verify}_paged` on the plain read path against the
  JAX functions (`paged_mode="ref"`), with and without q compression;
- the weight-absorbed form the card runs (`_mla_absorbed_attend`, with the
  plain MLA attention in place of the kernel) against JAX's
  `_mla_paged_attend` on the interpret-mode kernel: the reassociation
  (w_uk folded into q, w_uv after the latent output) holds.

Tolerances: float32 1e-5 on the attention op, 1e-4 on the layer outputs
(same f32 maths in another summation order; the absorbed form also
reassociates two contractions).  bf16 2e-2 (one bf16 rounding of two f32
sums that differ in order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as j_paged_attention
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels.ref import paged_attn_ref
from repro_torch.models import attention as A

from _torch_parity import np32, t, tree_to_torch

pytestmark = pytest.mark.tier1

F32 = dict(rtol=1e-5, atol=1e-5)
LAYER = dict(rtol=1e-4, atol=1e-4)
R, RR = 32, 8                                   # kv_lora, rope (SMOKE)


def _latent_pools(nb, bs, seed=1):
    rng = np.random.default_rng(seed)
    return {"c_kv": (rng.standard_normal((nb, bs, R)) * 0.3
                     ).astype(np.float32),
            "k_rope": (rng.standard_normal((nb, bs, RR)) * 0.3
                       ).astype(np.float32)}


MLA_CASES = {
    # name: (nb, bs, tables, positions, S)
    "heterogeneous": (11, 8, [[7, 2, 9, 4], [1, 5, 0, 0], [3, 6, 8, 10]],
                      [26, 9, 31], 1),
    "inactive_lane": (5, 8, [[1, 2, 0, 0], [0, 0, 0, 0]], [12, 0], 1),
    "prefill_unaligned": (9, 8, [[5, 1, 4, 2]], [13], 16),
    "verify": (9, 8, [[1, 2, 3, 4], [5, 6, 7, 0]], [20, 9], 3),
}


class TestMlaOpParity:
    @pytest.mark.parametrize("name", sorted(MLA_CASES))
    def test_plain_matches_interpret_kernel_and_ref(self, name):
        nb, bs, tables, positions, S = MLA_CASES[name]
        pools = _latent_pools(nb, bs)
        B = len(tables)
        q = np.random.default_rng(2).standard_normal(
            (B, S, 4, R + RR)).astype(np.float32)
        tb = np.asarray(tables, np.int32)
        pos = np.asarray(positions, np.int32)
        kw = dict(num_kv_heads=1, scale=0.2, mla=True)
        args = (jnp.asarray(q), jnp.asarray(pools["c_kv"]),
                jnp.asarray(pools["k_rope"]), jnp.asarray(tb),
                jnp.asarray(pos))
        want = j_paged_attention(*args, interpret=True, **kw)
        got = paged_attn_ref(t(q), t(pools["c_kv"]), t(pools["k_rope"]),
                             t(tb), t(pos), **kw)
        assert tuple(got.shape) == (B, S, 4, R)          # latent output
        np.testing.assert_allclose(np32(got), np32(want), **F32)
        np.testing.assert_allclose(np32(got),
                                   np32(jref.paged_attn_ref(*args, **kw)),
                                   **F32)

    def test_bf16_pools(self):
        nb, bs, tables, positions, S = MLA_CASES["heterogeneous"]
        pools = _latent_pools(nb, bs, seed=3)
        q = np.random.default_rng(4).standard_normal(
            (3, 1, 4, R + RR)).astype(np.float32)
        qb, cb, kb = (jnp.asarray(a, jnp.bfloat16)
                      for a in (q, pools["c_kv"], pools["k_rope"]))
        tb = jnp.asarray(tables, jnp.int32)
        pos = jnp.asarray(positions, jnp.int32)
        want = j_paged_attention(qb, cb, kb, tb, pos, num_kv_heads=1,
                                 scale=0.2, mla=True, interpret=True)
        got = ops.paged_attn(t(qb), t(cb), t(kb), t(tb), t(pos),
                             num_kv_heads=1, scale=0.2, mla=True)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(np32(got), np32(want), rtol=2e-2,
                                   atol=2e-2)

    def test_mode_routing(self):
        q = torch.zeros(1, 1, 4, R + RR)
        assert ops.resolve_paged_attn_mode("auto", q) == "ref"
        with pytest.raises(ValueError):
            ops.resolve_paged_attn_mode("interpret", q)
        with pytest.raises(ValueError):      # no kernel for a CPU tensor
            ops.paged_attn(q, torch.zeros(3, 8, R), torch.zeros(3, 8, RR),
                           torch.zeros(1, 2, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), num_kv_heads=1,
                           scale=1.0, mla=True, mode="kernel")


# ---------------------------------------------------------------------------
# MLA attention layer functions (SMOKE MLA shapes)
# ---------------------------------------------------------------------------

MLA = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
           kv_lora_rank=R, rope_head_dim=RR)


def _cfgs(q_lora, jmode="ref"):
    jc = JA.AttnConfig(**MLA, q_lora_rank=q_lora, dtype=jnp.float32,
                       paged_mode=jmode)
    pc = A.AttnConfig(**MLA, q_lora_rank=q_lora, dtype=torch.float32)
    return jc, pc


def _params(jc):
    p = JL.init_from_specs(JA.attn_specs(jc), jax.random.PRNGKey(0),
                           scale=0.1)
    # norm scales away from init's zeros, so the latent carries signal
    p = dict(p, kv_norm=jnp.ones_like(p["kv_norm"]))
    if "q_norm" in p:
        p["q_norm"] = jnp.ones_like(p["q_norm"])
    return p, tree_to_torch(p)


def _jpools(pools):
    return {k: jnp.asarray(v) for k, v in pools.items()}


def _tpools(pools):
    return {k: t(v).clone() for k, v in pools.items()}


class TestMlaLayerParity:
    @pytest.mark.parametrize("q_lora", (None, 12))
    def test_decode_paged(self, q_lora):
        jc, pc = _cfgs(q_lora)
        jp, pp = _params(jc)
        pools = _latent_pools(9, 8)
        tables = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32)
        positions = np.asarray([27, 11], np.int32)
        active = np.asarray([True, False])
        x = (np.random.default_rng(8).standard_normal((2, 1, 64)) * 0.5
             ).astype(np.float32)
        want, jcache = JA.mla_decode_paged(
            jp, jc, jnp.asarray(x), _jpools(pools), jnp.asarray(tables),
            jnp.asarray(positions), jnp.asarray(active))
        tp = _tpools(pools)
        got, pcache = A.mla_decode_paged(pp, pc, t(x), tp, t(tables),
                                         t(positions), t(active))
        np.testing.assert_allclose(np32(got[0]), np32(want[0]), **LAYER)
        for k in ("c_kv", "k_rope"):            # written in place
            assert pcache[k] is tp[k]
            np.testing.assert_allclose(np32(pcache[k]), np32(jcache[k]),
                                       **LAYER)

    @pytest.mark.parametrize("q_lora", (None, 12))
    @pytest.mark.parametrize("start", (8, 5))
    def test_prefill_chunk_paged(self, q_lora, start):
        jc, pc = _cfgs(q_lora)
        jp, pp = _params(jc)
        pools = _latent_pools(9, 8)
        table_row = np.asarray([[3, 1, 4, 2]], np.int32)
        x = (np.random.default_rng(9).standard_normal((1, 16, 64)) * 0.5
             ).astype(np.float32)
        want, jcache = JA.mla_prefill_paged(
            jp, jc, jnp.asarray(x), _jpools(pools), jnp.asarray(table_row),
            start)
        got, pcache = A.mla_prefill_paged(pp, pc, t(x), _tpools(pools),
                                          t(table_row), start)
        np.testing.assert_allclose(np32(got), np32(want), **LAYER)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(np32(pcache[k]), np32(jcache[k]),
                                       **LAYER)

    @pytest.mark.parametrize("q_lora", (None, 12))
    def test_verify_paged(self, q_lora):
        jc, pc = _cfgs(q_lora)
        jp, pp = _params(jc)
        pools = _latent_pools(9, 8)
        tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
        positions = np.asarray([21, 9], np.int32)
        active = np.asarray([True, True])
        nvalid = np.asarray([3, 1], np.int32)
        x = (np.random.default_rng(10).standard_normal((2, 3, 64)) * 0.5
             ).astype(np.float32)
        want, jcache = JA.mla_verify_paged(
            jp, jc, jnp.asarray(x), _jpools(pools), jnp.asarray(tables),
            jnp.asarray(positions), jnp.asarray(active), jnp.asarray(nvalid))
        got, pcache = A.mla_verify_paged(
            pp, pc, t(x), _tpools(pools), t(tables), t(positions), t(active),
            t(nvalid))
        np.testing.assert_allclose(np32(got), np32(want), **LAYER)
        for k in ("c_kv", "k_rope"):
            np.testing.assert_allclose(np32(pcache[k]), np32(jcache[k]),
                                       **LAYER)

    def test_specs_match_reference(self):
        for q_lora in (None, 12):
            jc, pc = _cfgs(q_lora)
            js, ps = JA.attn_specs(jc), A.attn_specs(pc)
            assert set(js) == set(ps)
            for k in js:
                assert tuple(ps[k].shape) == js[k].shape
            jpc = JA.paged_cache_specs(jc, 5, 8)
            ppc = A.paged_cache_specs(pc, 5, 8)
            assert {k: tuple(v.shape) for k, v in ppc.items()} == \
                {k: v.shape for k, v in jpc.items()}


class TestAbsorbedForm:
    @pytest.mark.parametrize("case", ("decode", "prefill", "verify"))
    def test_absorbed_plain_matches_jax_interpret_kernel(self, case):
        """The card's reassociated read (q through w_uk, MQA over the
        latent, w_uv after) on the plain MLA attention equals JAX's kernel
        path in interpret mode and the gathered up-projection path."""
        jc, pc = _cfgs(None, jmode="interpret")
        jp, pp = _params(jc)
        pools = _latent_pools(9, 8, seed=11)
        tables, positions, S = {
            "decode": ([[1, 2, 3, 4], [5, 6, 0, 0]], [27, 11], 1),
            "prefill": ([[3, 1, 4, 2]], [5], 16),
            "verify": ([[1, 2, 3, 4], [5, 6, 7, 0]], [21, 9], 3),
        }[case]
        tb = np.asarray(tables, np.int32)
        pos = np.asarray(positions, np.int32)
        q = (np.random.default_rng(12).standard_normal(
            (len(tables), S, 4, 16 + RR)) * 0.5).astype(np.float32)
        jargs = (jnp.asarray(q), jnp.asarray(pools["c_kv"]),
                 jnp.asarray(pools["k_rope"]), jnp.asarray(tb),
                 jnp.asarray(pos))
        prefill = case == "prefill"
        want = JA._mla_paged_attend(jp, jc, *jargs, prefill=prefill)
        got = A._mla_absorbed_attend(pp, pc, t(q), t(pools["c_kv"]),
                                     t(pools["k_rope"]), t(tb), t(pos),
                                     mode="ref")
        np.testing.assert_allclose(np32(got), np32(want), **LAYER)
        gathered = A._mla_paged_attend(pp, pc, t(q), t(pools["c_kv"]),
                                       t(pools["k_rope"]), t(tb), t(pos),
                                       prefill=prefill)
        np.testing.assert_allclose(np32(got), np32(gathered), **LAYER)
