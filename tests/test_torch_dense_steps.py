"""The port's dense-cache step functions (`transformer.prefill` /
`decode_step` and `cache_specs`) and cross attention against the JAX
package's on the CPU, at float32 on the SMOKE configs of all ten archs,
with the same parameters (JAX `init_params`, carried over by
`repro_torch.bridge`) and the same numpy-seeded inputs: token ids, or
frame embeddings for musicgen, and patch embeddings (`enc`) for
llama-3.2-vision's cross layers.  `prefill` then two `decode_step`s: the
logits of every step within 1e-4 of the row's largest |logit| (f32 sums
taken in another order), the same greedy tokens, and caches of the same
tree, shapes, dtypes and values (1e-4 of the leaf's largest |value|).
Also: the window ring past the window (gemma3, danube), the caches given
to `decode_step` left as they were, parameter specs and counts equal to
the reference's (zamba2's shared block counted once)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import attention as jattn
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch.bridge import config_from_reference
from repro_torch.models import attention as attn
from repro_torch.models import registry
from repro_torch.models import transformer as tf

from _torch_parity import np32, tree_to_torch

pytestmark = pytest.mark.tier1

TOL = 1e-4
B, S, MAX_LEN = 2, 6, 12


@pytest.fixture(scope="module", params=registry.ARCH_NAMES)
def arch(request):
    jcfg = jregistry.get_config(request.param, smoke=True).with_(
        dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, config_from_reference(jcfg), tree_to_torch(jparams)


def _inputs(cfg, S, seed):
    """The step's input (tokens or embeddings) and enc, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = (rng.standard_normal((B, cfg.encoder_tokens, cfg.d_model))
           .astype(np.float32) if cfg.encoder_tokens else None)
    return x, enc


def _batch(cfg, x, enc, to=lambda a: a):
    b = {"tokens" if cfg.input_mode == "tokens" else "embeds": to(x)}
    if enc is not None:
        b["enc"] = to(enc)
    return b


def _close_logits(got, want):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    scale = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= TOL * np.maximum(scale, 1.0)).all()
    assert (got.argmax(-1) == want.argmax(-1)).all()


def _same_tree(got, want, leaf, path=()):
    """Walk two trees of the same dict keys / list lengths / None leaves
    (the reference's numpy tree and the port's), calling leaf(path, g, w)
    at each array."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_tree(got[k], want[k], leaf, path + (k,))
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, leaf, path + (i,))
    elif want is None:
        assert got is None, path
    else:
        leaf(path, got, want)


def _close_caches(got, want):
    def leaf(path, g, w):
        g, w = np32(g), np32(w)
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= TOL * max(1.0, np.abs(w).max()), path
    _same_tree(got, jax.tree.map(np.asarray, want), leaf)


def _steps(jcfg, jparams, cfg, params, S, max_len, seed=0):
    """prefill then two decode steps on both sides; yields the logits and
    caches of each step."""
    x, enc = _inputs(cfg, S, seed)
    jl, jc = jtf.prefill(jparams, jcfg, _batch(cfg, x, enc), max_len)
    gl, gc = tf.prefill(params, cfg, _batch(cfg, x, enc, torch.from_numpy),
                        max_len)
    yield gl, jl, gc, jc
    for i, pos in enumerate((S, S + 1)):
        nx, _ = _inputs(cfg, 1, seed + 1 + i)
        jl, jc = jtf.decode_step(jparams, jcfg, nx, jc, pos, enc=enc)
        gl, gc = tf.decode_step(
            params, cfg, torch.from_numpy(nx), gc, pos,
            enc=None if enc is None else torch.from_numpy(enc))
        yield gl, jl, gc, jc


def test_prefill_and_decode_match_jax(arch):
    for gl, jl, gc, jc in _steps(*arch, S, MAX_LEN):
        assert gl.shape == (B, 1, arch[2].vocab_size)
        _close_logits(gl, jl)
        _close_caches(gc, jc)


def _dtype(jdt):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
        np.dtype(jdt).name]


def _same_specs(got, want):
    def leaf(path, g, w):
        assert (tuple(g.shape), g.dtype) == (w.shape, _dtype(w.dtype)), path
    _same_tree(got, want, leaf)


def test_cache_specs_match_jax(arch):
    jcfg, _, cfg, _ = arch
    for dtype in ("float32", "bfloat16"):
        _same_specs(tf.cache_specs(cfg.with_(dtype=dtype), 3, MAX_LEN),
                    jtf.cache_specs(jcfg.with_(dtype=dtype), 3, MAX_LEN))


def test_param_specs_and_counts_match_jax(arch):
    jcfg, jparams, cfg, params = arch
    for dtype in ("float32", "bfloat16"):
        _same_specs(tf.param_specs(cfg.with_(dtype=dtype)),
                    jtf.param_specs(jcfg.with_(dtype=dtype)))
    for smoke in (True, False):
        j = jregistry.get_config(cfg.name, smoke=smoke)
        assert registry.get_config(cfg.name, smoke=smoke) == \
            config_from_reference(j)
        assert config_from_reference(j).active_params() == j.active_params()


def test_decode_leaves_its_input_caches(arch):
    jcfg, jparams, cfg, params = arch
    x, enc = _inputs(cfg, S, 0)
    _, caches = tf.prefill(params, cfg, _batch(cfg, x, enc,
                                               torch.from_numpy), MAX_LEN)
    before = [t.clone() for t in _flat(caches)]
    nx, _ = _inputs(cfg, 1, 9)
    tf.decode_step(params, cfg, torch.from_numpy(nx), caches, S,
                   enc=None if enc is None else torch.from_numpy(enc))
    assert all(torch.equal(a, b) for a, b in zip(before, _flat(caches)))


def _flat(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _flat(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _flat(v)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("name", ("gemma3-12b", "h2o-danube-1.8b"))
def test_window_ring_past_the_window(name):
    # a 20-token prompt past the 16-token window, max_len 24: the window
    # layers keep a 16-slot ring written at pos % 16
    jcfg = jregistry.get_config(name, smoke=True).with_(dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(3))
    cfg, params = config_from_reference(jcfg), tree_to_torch(jparams)
    for gl, jl, gc, jc in _steps(jcfg, jparams, cfg, params, 20, 24, 4):
        _close_logits(gl, jl)
        _close_caches(gc, jc)


def test_cross_attention_matches_jax():
    jcfg = jregistry.get_config("llama-3.2-vision-11b", smoke=True).with_(
        dtype="float32")
    jac = jtf._attn_cfg(jcfg, "cross")
    ac = tf._attn_cfg(config_from_reference(jcfg), "cross")
    rng = np.random.default_rng(0)
    p = {k: (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
         for k, s in jattn.cross_attn_specs(jac).items()}
    p["q_norm"] = rng.uniform(0.5, 1.5, p["q_norm"].shape).astype(np.float32)
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    want = jattn.cross_attn_forward({k: jnp.asarray(v) for k, v in p.items()},
                                    jac, jnp.asarray(x), jnp.asarray(enc))
    got = attn.cross_attn_forward(
        {k: torch.from_numpy(v) for k, v in p.items()}, ac,
        torch.from_numpy(x), torch.from_numpy(enc))
    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-5, atol=1e-5)
