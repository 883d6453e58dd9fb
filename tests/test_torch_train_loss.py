"""The port's training loss and its gradients against the JAX package on the
CPU, at float32 on the SMOKE configs, with the same numpy-seeded
parameters (the layout of `param_specs`) and the same numpy batch:
`transformer.loss_fn` against `jax.value_and_grad` of
`repro.models.transformer.loss_fn`, the loss within 1e-5 relative and every
gradient leaf within 1e-4 x max(its largest |ref| value, 1e-3 x the largest
over all leaves).  This file holds qwen1.5-0.5b (GQA with qkv bias, tied
embeddings), deepseek-v2-lite-16b (MLA + MoE) and gemma3-12b (window
layers, scaled tied embeddings); `test_torch_train_loss_mixers.py` the
others.  Also: block remat on == off (and that it recomputes),
`cross_entropy_chunked` over several chunks == one chunk == the
reference's, the tied embedding's gradient through lookup and head, the
training head reading the live table, the three `autograd.Function`s of
`kernels.ops` with their kernel calls monkeypatched to the plain versions
against autograd through the plain route, and `aux_load_balance_loss`."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch.bridge import config_from_reference, params_from_numpy
from repro_torch.checkpoint.manager import _flatten_with_names
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import (dense_grouped_ref, dense_ref,
                                     rmsnorm_ref)
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import layers
from repro_torch.models.layers import map_specs
from repro_torch.models import moe
from repro_torch.models import transformer as tf

from _torch_parity import np32, tree_to_torch

pytestmark = pytest.mark.tier1

LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
ARCHS = ("qwen1.5-0.5b", "deepseek-v2-lite-16b", "gemma3-12b")
_CACHE: dict = {}


def numpy_params(cfg, seed: int = 0):
    """f32 parameters from a numpy seed in the layout both packages share
    (`param_specs`), by the reference's rule: ones for norm scales, zeros
    for biases and 1-D leaves, normal(0, 0.02) clipped at 2 sigma else."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1])
        if "scale" in name or "norm_w" in name:
            return np.ones(s.shape, np.float32)
        if "bias" in name or len(s.shape) < 2:
            return np.zeros(s.shape, np.float32)
        return (np.clip(rng.standard_normal(s.shape), -2, 2)
                * 0.02).astype(np.float32)
    return map_specs(leaf, tf.param_specs(cfg))


def reference(arch: str):
    """(JAX cfg, JAX params, port cfg, port params) at SMOKE in f32, the
    same numpy-seeded parameters on both sides, made once a process."""
    if arch not in _CACHE:
        jcfg = jregistry.get_config(arch, smoke=True).with_(dtype="float32")
        cfg = config_from_reference(jcfg)
        tree = numpy_params(cfg)
        _CACHE[arch] = (jcfg, jax.tree.map(jnp.asarray, tree), cfg,
                        params_from_numpy(tree))
    return _CACHE[arch]


def train_batch(cfg, B: int = 2, S: int = 16, seed: int = 0) -> dict:
    """A numpy training batch: labels, tokens or frame embeddings, and
    `enc` for cross layers."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.input_mode == "tokens":
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)
    else:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.encoder_tokens:
        b["enc"] = rng.standard_normal(
            (B, cfg.encoder_tokens, cfg.d_model)).astype(np.float32)
    return b


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def assert_grads_close(got: dict, want: dict, rtol: float = GRAD_RTOL):
    """Trees of gradients by leaf name: each leaf within rtol x max(its
    largest |want| value, 1e-3 x the largest over all leaves)."""
    got, want = _flatten_with_names(got), _flatten_with_names(want)
    assert got.keys() == want.keys()
    top = max(np.abs(np32(w)).max() for w in want.values())
    for name, w in want.items():
        g, w = np32(got[name]), np32(w)
        assert g.shape == w.shape, name
        scale = max(np.abs(w).max(), 1e-3 * top)
        err = np.abs(g - w).max()
        assert err <= rtol * scale, (name, err, scale)


def reference_grads(arch: str):
    """The reference's jitted loss and gradients on `train_batch`, made
    once a process."""
    key = (arch, "grads")
    if key not in _CACHE:
        jcfg, jparams, cfg, _ = reference(arch)
        batch = train_batch(cfg)
        _CACHE[key] = jax.jit(jax.value_and_grad(
            lambda p: jtf.loss_fn(p, jcfg, batch)))(jparams)
    return _CACHE[key]


def check_against_jax(arch: str):
    _, _, cfg, params = reference(arch)
    jloss, jgrads = reference_grads(arch)
    loss, grads = value_and_grad(cfg, params, as_torch(train_batch(cfg)))
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    assert_grads_close(grads, tree_to_torch(jgrads))


def check_remat(arch: str):
    """Block remat on and off: the same loss and gradients (the same ops,
    recomputed), and with it on each superblock layer runs twice."""
    _, _, cfg, params = reference(arch)
    batch = as_torch(train_batch(cfg))
    calls = {"n": 0}
    apply_block = tf.apply_block

    def counted(*a, **kw):
        calls["n"] += 1
        return apply_block(*a, **kw)
    runs = {}
    for remat in ("block", "none"):
        calls["n"] = 0
        tf.apply_block = counted
        try:
            runs[remat] = value_and_grad(cfg.with_(remat=remat), params,
                                         batch)
        finally:
            tf.apply_block = apply_block
        runs[remat] += (calls["n"],)
    body = cfg.num_layers - len(cfg.prefix_pattern)
    assert runs["none"][2] == cfg.num_layers
    assert runs["block"][2] == cfg.num_layers + body
    assert float(runs["block"][0]) == float(runs["none"][0])
    assert_grads_close(runs["block"][1], runs["none"][1], rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    check_against_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_off(arch):
    check_remat(arch)


def test_value_and_grad_leaves_params_alone():
    _, _, cfg, params = reference("qwen1.5-0.5b")
    value_and_grad(cfg, params, as_torch(train_batch(cfg)))
    assert not any(t.requires_grad for t in
                   _flatten_with_names(params).values())


@pytest.mark.parametrize("S,chunk", ((32, 8), (32, 16), (24, 16)))
def test_cross_entropy_chunked(S, chunk):
    # several chunks == one chunk == the reference's chunked loss, values
    # and gradients; 24 % 16 falls back to one chunk, as in the reference
    rng = np.random.default_rng(S + chunk)
    B, D, V = 2, 16, 40
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((V, D)).astype(np.float32) * 0.3
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    want, (jdx, jdw) = jax.value_and_grad(
        lambda xx, ww: jlayers.cross_entropy_chunked(
            lambda xc: jlayers.lm_head({"w_out": ww}, xc), xx,
            jnp.asarray(labels), chunk=chunk), argnums=(0, 1))(x, w)
    got = {}
    for c in (chunk, S):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        loss = layers.cross_entropy_chunked(
            lambda xc: layers.lm_head({"w_out": wt}, xc), xt,
            torch.from_numpy(labels), chunk=c)
        loss.backward()
        loss = loss.detach()
        got[c] = (loss, xt.grad, wt.grad)
        assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
        np.testing.assert_allclose(np32(xt.grad), np.asarray(jdx),
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(np32(wt.grad), np.asarray(jdw),
                                   rtol=1e-5, atol=1e-7)
    full = layers.cross_entropy(
        layers.lm_head({"w_out": torch.from_numpy(w)}, torch.from_numpy(x)),
        torch.from_numpy(labels))
    assert abs(float(full) - float(got[S][0])) <= 1e-6 * abs(float(full))


def test_tied_embedding_gradient_through_lookup_and_head():
    # the tied table's gradient is the reference's, and the sum of the
    # head's (every row) and the lookup's (the batch's tokens' rows only)
    _, _, cfg, params = reference("qwen1.5-0.5b")
    assert cfg.tie_embeddings
    batch = train_batch(cfg)
    _, g = value_and_grad(cfg, params, as_torch(batch))
    want = np32(reference_grads("qwen1.5-0.5b")[1]["embed"]["embedding"])
    got = np32(g["embed"]["embedding"])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=GRAD_RTOL * np.abs(want).max())
    # the head alone: the lookup reads a detached copy of the table
    table = params["embed"]["embedding"].detach().requires_grad_()
    x = tf.hidden_states(dict(params, embed={"embedding": table.detach()}),
                         cfg, as_torch(batch))
    loss = layers.cross_entropy_chunked(
        lambda xc: layers.head_logits(xc, table, None), x,
        as_torch(batch)["labels"])
    head = np32(torch.autograd.grad(loss, table)[0])
    seen = np.unique(batch["tokens"])
    unseen = np.setdiff1d(np.arange(cfg.vocab_size), seen)
    assert np.abs(head[unseen]).min(axis=1).max() > 0
    lookup = got - head
    assert np.abs(lookup[unseen]).max() <= 1e-7
    assert (np.abs(lookup[seen]).max(axis=1) > 0).all()


def test_training_head_reads_the_live_table():
    # a serving copy in the params (stale here: zeros) is never read by the
    # training loss; the gradient reaches the live table
    _, _, cfg, params = reference("qwen1.5-0.5b")
    batch = as_torch(train_batch(cfg))
    loss, g = value_and_grad(cfg, params, batch)
    served = tf.serving_params(params, cfg)
    served["embed"]["embedding_t"] = torch.zeros_like(
        served["embed"]["embedding_t"])
    loss2, g2 = value_and_grad(cfg, served, batch)
    assert float(loss2) == float(loss)
    assert torch.equal(g2["embed"]["embedding"], g["embed"]["embedding"])
    assert not g2["embed"]["embedding_t"].any()
    # untied: lm_head reads w_out, not w_out_t
    p = {"w_out": torch.randn(9, 4), "w_out_t": torch.zeros(4, 9)}
    x = torch.randn(3, 4)
    torch.testing.assert_close(layers.lm_head(p, x), x @ p["w_out"].t())


# -- the autograd.Functions of kernels.ops, their kernels monkeypatched ----

def _plain_kernels(monkeypatch):
    """Route `dense` / `dense_grouped` / `rmsnorm` to the kernel route on
    the CPU, each kernel call replaced by its plain version; returns the
    launch counts."""
    n = {"dense": 0, "grouped": 0, "rmsnorm": 0}

    def fake(key, fn):
        def call(*a, **kw):
            n[key] += 1
            return fn(*a, **kw)
        return call
    kw_drop = ("num_bufs", "record", "route")
    monkeypatch.setattr(ops, "resolve_mode",
                        lambda mode, t: "ref" if mode == "ref" else "kernel")
    monkeypatch.setattr(ops, "gpp_matmul", fake("dense", lambda x, w, **kw:
        dense_ref(x, w, **{k: v for k, v in kw.items() if k not in kw_drop})))
    monkeypatch.setattr(ops, "gpp_matmul_grouped", fake(
        "grouped", lambda x, w, **kw: dense_grouped_ref(
            x, w, **{k: v for k, v in kw.items() if k not in kw_drop})))
    monkeypatch.setattr(rn, "rmsnorm", fake("rmsnorm", rmsnorm_ref))
    return n


def _grads(fn, *ts):
    ts = [t.detach().requires_grad_() if t is not None
          and t.is_floating_point() else t for t in ts]
    y = fn(*ts)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(5))
    wrt = [t for t in ts if t is not None and t.requires_grad]
    return y, torch.autograd.grad(y, wrt, g.to(y.dtype))


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("act", (None, "silu", "gelu", "relu", "tanh",
                                 "sigmoid"))
def test_dense_function_matches_plain(monkeypatch, dtype, act):
    n = _plain_kernels(monkeypatch)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 24, generator=g).to(dtype)
    w = (torch.randn(24, 3, 8, generator=g) * 0.2).to(dtype)
    b = torch.randn(3, 8, generator=g).to(dtype)
    y_k, g_k = _grads(lambda x, w, b: ops.dense(x, w, bias=b, activation=act,
                                                mode="kernel"), x, w, b)
    assert n["dense"] == 1
    y_p, g_p = _grads(lambda x, w, b: ops.dense(x, w, bias=b, activation=act,
                                                mode="ref"), x, w, b)
    assert n["dense"] == 1
    assert torch.equal(y_k, y_p)
    for a, e in zip(g_k, g_p):
        assert a.dtype == e.dtype
        torch.testing.assert_close(a, e, rtol=1e-6 if dtype == torch.float32
                                   else 0, atol=1e-6 if dtype == torch.float32
                                   else 0)


def test_dense_function_scale_and_int8(monkeypatch):
    # an int8 W and its dequant scale take no gradient; x's is the plain one
    _plain_kernels(monkeypatch)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 16, generator=g)
    w = torch.randint(-127, 128, (16, 7), generator=g, dtype=torch.int8)
    sc = torch.rand(7, generator=g) * 1e-2
    _, (gx,) = _grads(lambda x: ops.dense(x, w, w_scale=sc,
                                          activation="silu", mode="kernel"),
                      x)
    _, (px,) = _grads(lambda x: ops.dense(x, w, w_scale=sc,
                                          activation="silu", mode="ref"), x)
    torch.testing.assert_close(gx, px, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="w_scale"):
        ops.dense(x, w, w_scale=sc.requires_grad_(), mode="kernel")


@pytest.mark.parametrize("scale", (None, "scalar", "expert", "column"))
@pytest.mark.parametrize("act", (None, "silu"))
def test_dense_grouped_function_matches_plain(monkeypatch, scale, act):
    n = _plain_kernels(monkeypatch)
    monkeypatch.setattr("repro_torch.kernels.ops.grouped_ref_chunk",
                        lambda E, K, N: 2)        # chunks of experts
    g = torch.Generator().manual_seed(2)
    E, C, D, F = 5, 4, 12, 10
    x = torch.randn(E, C, D, generator=g)
    w = torch.randn(E, D, F, generator=g) * 0.3
    b = torch.randn(E, F, generator=g)
    sc = {None: None, "scalar": torch.tensor(0.7),
          "expert": torch.rand(E, generator=g) + 0.5,
          "column": torch.rand(E, F, generator=g) + 0.5}[scale]
    y_k, g_k = _grads(lambda x, w, b: ops.dense_grouped(
        x, w, bias=b, w_scale=sc, activation=act, mode="kernel"), x, w, b)
    y_p, g_p = _grads(lambda x, w, b: ops.dense_grouped(
        x, w, bias=b, w_scale=sc, activation=act, mode="ref"), x, w, b)
    assert n["grouped"] == 1
    torch.testing.assert_close(y_k, y_p, rtol=0, atol=0)
    for a, e in zip(g_k, g_p):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_rmsnorm_function_matches_plain(monkeypatch, dtype):
    n = _plain_kernels(monkeypatch)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(3, 4, 32, generator=g).to(dtype)
    p = {"scale": (1 + 0.1 * torch.randn(32, generator=g)).to(dtype)}
    y_k, g_k = _grads(lambda x, s: ops.rmsnorm({"scale": s}, x,
                                               mode="kernel"), x, p["scale"])
    y_p, g_p = _grads(lambda x, s: ops.rmsnorm({"scale": s}, x, mode="ref"),
                      x, p["scale"])
    assert n["rmsnorm"] == 1
    assert torch.equal(y_k, y_p)
    for a, e in zip(g_k, g_p):
        assert a.dtype == dtype
        torch.testing.assert_close(a, e, rtol=0, atol=0)


def test_wrappers_run_bare_without_a_gradient(monkeypatch):
    # no gradient wanted (serving): the kernel wrappers, no Function
    n = _plain_kernels(monkeypatch)
    calls = []
    monkeypatch.setattr(ops.DenseKernel, "apply",
                        lambda *a: calls.append(a))
    x, w = torch.randn(3, 8), torch.randn(8, 4)
    with torch.no_grad():
        ops.dense(x, w.requires_grad_(), mode="kernel")
    ops.dense(x, w.detach(), mode="kernel")
    assert n["dense"] == 2 and not calls


@pytest.mark.parametrize("arch", ("qwen1.5-0.5b", "deepseek-v2-lite-16b"))
def test_loss_through_the_functions_matches_plain(monkeypatch, arch):
    # the whole training loss on the kernel route, each kernel its plain
    # version, against autograd through the plain route
    _, _, cfg, params = reference(arch)
    batch = as_torch(train_batch(cfg))
    plain = value_and_grad(cfg.with_(dense_kernel="ref"), params, batch)
    n = _plain_kernels(monkeypatch)
    ker = value_and_grad(cfg.with_(dense_kernel="kernel"), params, batch)
    assert n["dense"] > 0 and n["rmsnorm"] > 0
    assert (n["grouped"] > 0) == bool(cfg.num_experts)
    assert float(ker[0]) == float(plain[0])
    assert_grads_close(ker[1], plain[1], rtol=1e-6)


def test_aux_load_balance_loss_matches_jax():
    jcfg, jparams, cfg, params = reference("deepseek-v2-lite-16b")
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["b0"]["moe"])
    want = jmoe.aux_load_balance_loss(jp, jtf._moe_cfg(jcfg), jnp.asarray(x))
    p = tf._index(params["blocks"]["b0"]["moe"], 0)
    got = moe.aux_load_balance_loss(p, tf._moe_cfg(cfg), torch.from_numpy(x))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
