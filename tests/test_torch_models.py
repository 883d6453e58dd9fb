"""The port's layers, paged GQA attention and paged step functions against
the JAX package on the CPU, on the same numpy inputs and parameters (JAX's
`init_params` / `init_from_specs`, carried over by `repro_torch.bridge`).
The JAX side reads the paged pools through its `kernels/ref.py` oracle
(`paged_mode="ref"`); the interpret-mode kernel is held against the port in
test_torch_kernels.py.

Tolerances: float32 1e-4 at the attention and layer level, 1e-4 on the
qwen1.5-0.5b SMOKE logits (same f32 maths in another summation order).
bf16 logits 0.1: the JAX CPU path multiplies in bf16 and adds the bias in
bf16 (`_dense_ref_path`), the port accumulates in f32 and rounds once (the
kernel's numerics), so the two drift by bf16 ulps through the layers.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch.bridge import config_from_reference
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models import transformer as tf

from _torch_parity import np32, t, tree_to_torch

pytestmark = pytest.mark.tier1

F32 = dict(rtol=1e-4, atol=1e-4)

GQA = dict(d_model=64, num_heads=4, num_kv_heads=2, head_dim=16)
CFGS = {"gqa": GQA, "window": dict(GQA, window=16)}


def _cfgs(name, mode="ref"):
    jc = JA.AttnConfig(**CFGS[name], dtype=jnp.float32, paged_mode=mode)
    pc = A.AttnConfig(**CFGS[name], dtype=torch.float32)
    return jc, pc


def _pools(nb, bs, seed=1):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal((nb, bs, 2, 16)) * 0.3).astype(np.float32)
            for k in ("k", "v")}


def _attn_params(jc):
    p = JL.init_from_specs(JA.attn_specs(jc), jax.random.PRNGKey(0))
    return p, tree_to_torch(p)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class TestLayers:
    def test_rmsnorm(self):
        rng = np.random.default_rng(0)
        x = rng.standard_normal((2, 3, 64)).astype(np.float32)
        s = rng.standard_normal(64).astype(np.float32)
        want = JL.rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x))
        got = L.rmsnorm({"scale": t(s)}, t(x))
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5,
                                   atol=1e-5)

    @pytest.mark.parametrize("theta", (1e4, 1e6))
    def test_rope_split_half(self, theta):
        rng = np.random.default_rng(1)
        x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
        pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
        want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
        got = L.rope(t(x), t(pos), theta)
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5,
                                   atol=1e-5)

    def test_mlp_embed_unembed(self):
        specs = JL.mlp_specs(32, 48, jnp.float32, "swiglu")
        specs["embedding"] = JL.sds((40, 32), jnp.float32)
        p = JL.init_from_specs(specs, jax.random.PRNGKey(2))
        pt = tree_to_torch(p)
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 3, 32)).astype(np.float32)
        toks = rng.integers(0, 40, (2, 3)).astype(np.int32)
        np.testing.assert_allclose(
            np32(L.mlp(pt, t(x), "swiglu")),
            np32(JL.mlp(p, jnp.asarray(x), "swiglu")), **F32)
        np.testing.assert_allclose(
            np32(L.embed(pt, t(toks).long())),
            np32(JL.embed(p, jnp.asarray(toks))), rtol=0, atol=0)
        np.testing.assert_allclose(
            np32(L.unembed(pt, t(x))), np32(JL.unembed(p, jnp.asarray(x))),
            **F32)


# ---------------------------------------------------------------------------
# GQA paged attention (TestAttentionLevelParity's shapes)
# ---------------------------------------------------------------------------

class TestAttentionParity:
    @pytest.mark.parametrize("name", sorted(CFGS))
    def test_decode_paged(self, name):
        jc, pc = _cfgs(name)
        jp, pp = _attn_params(jc)
        pools = _pools(9, 8)
        tables = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32)
        positions = np.asarray([27, 11], np.int32)
        active = np.asarray([True, False])
        x = (np.random.default_rng(8).standard_normal((2, 1, 64)) * 0.5
             ).astype(np.float32)
        want, jcache = JA.gqa_decode_paged(
            jp, jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                     pools.items()},
            jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(active))
        tpools = {k: t(v).clone() for k, v in pools.items()}
        got, pcache = A.gqa_decode_paged(pp, pc, t(x), tpools, t(tables),
                                         t(positions), t(active))
        np.testing.assert_allclose(np32(got[0]), np32(want[0]), **F32)
        for k in ("k", "v"):        # the writes land in place, as in JAX
            assert pcache[k] is tpools[k]
            np.testing.assert_allclose(np32(pcache[k]), np32(jcache[k]),
                                       **F32)

    @pytest.mark.parametrize("name", sorted(CFGS))
    @pytest.mark.parametrize("start", (8, 5))
    def test_prefill_chunk_paged(self, name, start):
        jc, pc = _cfgs(name)
        jp, pp = _attn_params(jc)
        pools = _pools(9, 8)
        table_row = np.asarray([[3, 1, 4, 2]], np.int32)
        x = (np.random.default_rng(9).standard_normal((1, 16, 64)) * 0.5
             ).astype(np.float32)
        want, jcache = JA.gqa_prefill_paged(
            jp, jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                     pools.items()},
            jnp.asarray(table_row), start)
        got, pcache = A.gqa_prefill_paged(
            pp, pc, t(x), {k: t(v).clone() for k, v in pools.items()},
            t(table_row), start)
        np.testing.assert_allclose(np32(got), np32(want), **F32)
        for k in ("k", "v"):
            np.testing.assert_allclose(np32(pcache[k]), np32(jcache[k]),
                                       **F32)

    @pytest.mark.parametrize("name", sorted(CFGS))
    def test_verify_paged(self, name):
        jc, pc = _cfgs(name)
        jp, pp = _attn_params(jc)
        pools = _pools(9, 8)
        tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
        positions = np.asarray([21, 9], np.int32)
        active = np.asarray([True, True])
        nvalid = np.asarray([3, 1], np.int32)
        x = (np.random.default_rng(10).standard_normal((2, 3, 64)) * 0.5
             ).astype(np.float32)
        want, jcache = JA.gqa_verify_paged(
            jp, jc, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                     pools.items()},
            jnp.asarray(tables), jnp.asarray(positions), jnp.asarray(active),
            jnp.asarray(nvalid))
        got, pcache = A.gqa_verify_paged(
            pp, pc, t(x), {k: t(v).clone() for k, v in pools.items()},
            t(tables), t(positions), t(active), t(nvalid))
        np.testing.assert_allclose(np32(got), np32(want), **F32)
        for k in ("k", "v"):
            np.testing.assert_allclose(np32(pcache[k]), np32(jcache[k]),
                                       **F32)


# ---------------------------------------------------------------------------
# the paged step functions on qwen1.5-0.5b SMOKE
# ---------------------------------------------------------------------------

def _smoke(dtype):
    jcfg = jregistry.get_config("qwen1.5-0.5b", smoke=True).with_(dtype=dtype)
    return jcfg, config_from_reference(jcfg)


def _drive(step_fns, caches, cfg_vocab):
    """Two prefill chunks (the second unaligned and ragged), two decode
    steps and one verify step; returns every step's logits."""
    prefill, decode, verify = step_fns
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg_vocab, size=13).astype(np.int32)
    table_row = np.arange(1, 5, dtype=np.int32)[None]
    outs = []
    for c0, last in ((0, 7), (8, 4)):
        toks = np.zeros((1, 8), np.int32)
        real = prompt[c0:c0 + 8]
        toks[0, :len(real)] = real
        logits, caches = prefill(toks, caches, table_row, c0, last)
        outs.append(np32(logits))
    tables = np.stack([table_row[0], np.zeros(4, np.int32)])
    tok, pos = int(np.argmax(outs[-1][0])), len(prompt)
    for _ in range(2):
        toks = np.asarray([[tok], [0]], np.int32)
        logits, caches = decode(toks, caches, tables,
                                np.asarray([pos, 0], np.int32),
                                np.asarray([True, False]))
        outs.append(np32(logits))
        tok = int(np.argmax(outs[-1][0, -1]))
        pos += 1
    toks = np.asarray([[tok, 3, 5], [0, 0, 0]], np.int32)
    logits, caches = verify(toks, caches, tables,
                            np.asarray([pos, 0], np.int32),
                            np.asarray([True, False]),
                            np.asarray([3, 1], np.int32))
    outs.append(np32(logits)[:1])
    return outs


def _jax_steps(jcfg, params):
    pf = jax.jit(lambda p, *a: jtf.prefill_chunk(p, jcfg, *a))
    dc = jax.jit(lambda p, *a: jtf.decode_step_paged(p, jcfg, *a))
    vf = jax.jit(lambda p, *a: jtf.verify_step_paged(p, jcfg, *a))

    def prefill(toks, caches, row, start, last):
        return pf(params, jnp.asarray(toks), caches, jnp.asarray(row),
                  start, last)

    def decode(toks, caches, tables, pos, active):
        return dc(params, jnp.asarray(toks), caches, jnp.asarray(tables),
                  jnp.asarray(pos), jnp.asarray(active))

    def verify(toks, caches, tables, pos, active, nvalid):
        return vf(params, jnp.asarray(toks), caches, jnp.asarray(tables),
                  jnp.asarray(pos), jnp.asarray(active), jnp.asarray(nvalid))
    return prefill, decode, verify


def _port_steps(cfg, params):
    def prefill(toks, caches, row, start, last):
        return tf.prefill_chunk(params, cfg, t(toks).long(), caches, t(row),
                                start, last)

    def decode(toks, caches, tables, pos, active):
        return tf.decode_step_paged(params, cfg, t(toks).long(), caches,
                                    t(tables), t(pos), t(active))

    def verify(toks, caches, tables, pos, active, nvalid):
        return tf.verify_step_paged(params, cfg, t(toks).long(), caches,
                                    t(tables), t(pos), t(active), t(nvalid))
    return prefill, decode, verify


class TestStepFunctionParity:
    @pytest.mark.parametrize("dtype,tol", (("float32", F32),
                                           ("bfloat16", dict(rtol=0.1,
                                                             atol=0.1))))
    def test_prefill_decode_verify_logits(self, dtype, tol):
        jcfg, cfg = _smoke(dtype)
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        params = tf.serving_params(tree_to_torch(jparams), cfg)
        specs = jtf.paged_cache_specs(jcfg, num_blocks=5, block_size=8)
        jcaches = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), specs)
        caches = tf.init_paged_caches(tf.paged_cache_specs(cfg, 5, 8), "cpu")
        want = _drive(_jax_steps(jcfg, jparams), jcaches, jcfg.vocab_size)
        got = _drive(_port_steps(cfg, params), caches, cfg.vocab_size)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, **tol)


class TestParamsAndBridge:
    def test_specs_match_reference_tree(self):
        jcfg, cfg = _smoke("bfloat16")
        jspecs = jtf.param_specs(jcfg)
        pspecs = tf.param_specs(cfg)
        flat = {}
        L.map_specs(lambda path, s: flat.__setitem__(path, s), pspecs)
        jflat = {tuple(getattr(k, "key", getattr(k, "idx", None))
                       for k in path): s
                 for path, s in jax.tree_util.tree_flatten_with_path(
                     jspecs)[0]}
        assert set(flat) == set(jflat)
        for path, s in flat.items():
            assert tuple(s.shape) == jflat[path].shape
            assert s.dtype == torch.bfloat16

    def test_init_params_rule_and_determinism(self):
        _, cfg = _smoke("float32")
        p1 = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        p2 = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
        assert torch.equal(p1["embed"]["embedding"], p2["embed"]["embedding"])
        assert torch.equal(p1["final_norm"]["scale"],
                           torch.ones(cfg.d_model))
        w = p1["blocks"]["b0"]["mlp"]["w_up"]
        assert float(w.abs().max()) <= 0.04 + 1e-6       # truncated at 2 sd
        assert abs(float(w.std()) - 0.02 * 0.88) < 3e-3  # trunc-normal sd

    def test_config_from_reference(self):
        jcfg = jregistry.get_config("qwen1.5-0.5b")
        cfg = config_from_reference(jcfg)
        assert cfg == registry.get_config("qwen1.5-0.5b")
        assert cfg.torch_dtype == torch.bfloat16
        assert cfg.active_params() == jcfg.active_params()

    def test_bf16_leaves_keep_their_bits(self):
        a = jnp.asarray([1.0, -2.5, 3.0e-3], jnp.bfloat16)
        got = t(a)
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(np32(got), np.asarray(a, np.float32))

    def test_cpu_must_be_asked_for(self):
        _, cfg = _smoke("float32")
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tf.init_params(cfg, torch.Generator(), "cuda")
