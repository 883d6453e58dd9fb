"""The port's layer streamer (`repro_torch.core.streamer`) against the JAX
package's `repro.core.streamer` on the CPU, in one process (world size 1:
every leaf whole on the device, the reference's `mesh=None`), on the same
numpy-seeded inputs: the chunk helpers; `stream_layers` in every mode at
L in {1, 2, 5, 7, 9} and G in {2, 3, 5, 8} against the reference's and
against the plain layer loop (rtol 1e-5, atol 1e-6, as
`test_streamer_schedule.py`), with a hypothesis case over L, G and the
seed; the gradients of the streamed modes against resident's (rtol 1e-4,
atol 1e-6), with and without block remat; the recorded issue order
against the reference's rule (the prologue, then layer min(i+k, L-1) with
chunk chunks-k) and the bytes a step; `StreamSettings`' checks;
`plan_for_layer` at the reference's rates; `ModelConfig.stream` through
the bridge; and `transformer.forward` / `loss_fn` on qwen SMOKE streamed
by gpp (ring 3) against the JAX package's at f32 and against the port's
resident run bit for bit.  The multi-rank cases are in
`test_torch_streamer_dist.py`."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro.core import streamer as js
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro_torch.bridge import config_from_reference
from repro_torch.core import streamer as ps
from repro_torch.launch.steps import stream_specs, value_and_grad
from repro_torch.models import transformer as tf

from _torch_parity import np32, tree_to_torch
from test_torch_train_loss import (as_torch, assert_grads_close, reference,
                                   train_batch)

pytestmark = pytest.mark.tier1

RTOL, ATOL = 1e-5, 1e-6


def _inputs(L, D=8, B=4, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((L, D, D)) * 0.2).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


def _plain(w, x):
    for i in range(w.shape[0]):
        x = np.tanh(x @ w[i])
    return x


def _tanh_layer(c, ws):
    return torch.tanh(c @ ws["w"])


def _jtanh_layer(c, ws):
    return jnp.tanh(c @ ws["w"])


def _port(mode, ring, w, x, L, record=None, **kw):
    return ps.stream_layers(
        _tanh_layer, torch.from_numpy(x),
        {"w": torch.from_numpy(w)}, L,
        settings=ps.StreamSettings(mode=mode, ring_depth=ring, **kw),
        mesh=None, shard_specs={"w": None}, full_specs={"w": None},
        record=record)


def _jax(mode, ring, w, x, L):
    return np.asarray(js.stream_layers(
        _jtanh_layer, jnp.asarray(x),
        {"w": jnp.asarray(w)}, L,
        settings=js.StreamSettings(mode=mode, ring_depth=ring),
        mesh=None, shard_specs={"w": None}, full_specs={"w": None}))


# ---------------------------------------------------------------------------
# chunk helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", (1, 5, 8, 13, 64))
@pytest.mark.parametrize("chunks", (1, 2, 3, 7))
def test_chunk_bounds_match_reference(dim, chunks):
    chunks = min(chunks, dim)
    spans = [ps._chunk_bounds(dim, chunks, c) for c in range(chunks)]
    assert spans == [js._chunk_bounds(dim, chunks, c) for c in range(chunks)]
    assert spans[0][0] == 0 and spans[-1][1] == dim
    assert all(b == c for (_, b), (c, _) in zip(spans, spans[1:]))


@pytest.mark.parametrize("chunk_dim", (0, 1, -1))
@pytest.mark.parametrize("chunks", (1, 2, 3))
def test_take_put_match_reference(chunk_dim, chunks):
    x = np.arange(5 * 7, dtype=np.float32).reshape(5, 7)
    buf, jbuf = torch.zeros(5, 7), jnp.zeros((5, 7))
    for c in range(chunks):
        got = ps._take_chunk(torch.from_numpy(x), chunk_dim, chunks, c)
        want = js._take_chunk(jnp.asarray(x), chunk_dim, chunks, c)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert ps._put_chunk(buf, got, chunk_dim, chunks, c) is buf
        jbuf = js._put_chunk(jbuf, want, chunk_dim, chunks, c)
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(buf.numpy(), x)


def test_layer_views():
    ws = {"a": torch.arange(12.0).reshape(3, 2, 2), "b": [torch.arange(3.0)]}
    got = ps._layer(ws, 1)
    assert torch.equal(got["a"], ws["a"][1]) and got["b"][0].item() == 1.0
    assert got["a"].data_ptr() == ws["a"][1].data_ptr()


# ---------------------------------------------------------------------------
# stream_layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring", (2, 3, 5, 8))
@pytest.mark.parametrize("L", (1, 2, 5, 7, 9))
@pytest.mark.parametrize("mode", ps.MODES)
def test_modes_match_reference_and_plain_loop(mode, L, ring):
    w, x = _inputs(L, seed=L + 10 * ring)
    got = _port(mode, ring, w, x, L).numpy()
    np.testing.assert_allclose(got, _jax(mode, ring, w, x, L), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, _plain(w, x), rtol=RTOL, atol=ATOL)


@given(st.integers(1, 9), st.integers(2, 8), st.integers(0, 3))
@settings(max_examples=20, deadline=None)
def test_gpp_any_depth_any_length(L, ring, seed):
    w, x = _inputs(L, seed=seed)
    got = _port("gpp", ring, w, x, L).numpy()
    np.testing.assert_allclose(got, _jax("gpp", ring, w, x, L), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, _plain(w, x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("remat", (False, True))
@pytest.mark.parametrize("mode", ("insitu", "naive_pp", "gpp"))
def test_streamed_gradients_match_resident(mode, remat):
    w, x = _inputs(6, seed=3)

    def apply_fn(c, ws):
        f = lambda c, w: torch.tanh(c @ w)              # noqa: E731
        if remat:
            return torch.utils.checkpoint.checkpoint(f, c, ws["w"],
                                                     use_reentrant=False)
        return f(c, ws["w"])

    def grads(m):
        ws = torch.from_numpy(w).requires_grad_()
        xs = torch.from_numpy(x).requires_grad_()
        y = ps.stream_layers(apply_fn, xs, {"w": ws}, 6,
                             settings=ps.StreamSettings(mode=m, ring_depth=4),
                             mesh=None, shard_specs={"w": None},
                             full_specs={"w": None})
        return torch.autograd.grad((y ** 2).sum(), (ws, xs))

    (gw, gx), (rw, rx) = grads(mode), grads("resident")
    np.testing.assert_allclose(gw.numpy(), rw.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), rx.numpy(), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gw.numpy(), _jax_gpp_grad(w, x), rtol=1e-4,
                               atol=1e-6)


_GRAD: dict = {}


def _jax_gpp_grad(w, x):
    """The reference's gpp gradient of sum(y^2) (ring 4), made once."""
    if "w" not in _GRAD:
        _GRAD["w"] = np.asarray(jax.grad(lambda ws: (js.stream_layers(
            _jtanh_layer, jnp.asarray(x), ws, 6,
            settings=js.StreamSettings(mode="gpp", ring_depth=4), mesh=None,
            shard_specs={"w": None}, full_specs={"w": None}) ** 2).sum())(
            {"w": jnp.asarray(w)})["w"])
    return _GRAD["w"]


def _rule(L, G):
    """The reference's issue order (`repro/core/streamer.py:189-209`) as
    (step, layer, chunk) triples: step -1 is the prologue and chunk None a
    whole layer."""
    G = max(2, min(G, L))
    chunks = max(1, G - 1)
    out = [(-1, min(j, L - 1), None) for j in range(G - 1)]
    for i in range(L):
        for k in range(1, G):
            c = chunks - k if chunks > 1 else 0
            out.append((i, min(i + k, L - 1), None if chunks == 1 else c))
    return out


@pytest.mark.parametrize("ring", (2, 3, 4, 8))
@pytest.mark.parametrize("L", (1, 3, 6))
def test_gpp_issue_order_is_the_reference_rule(L, ring):
    w, x = _inputs(L)
    rec = []
    _port("gpp", ring, w, x, L, record=rec)
    assert [r[:3] for r in rec] == _rule(L, ring)
    # after the prologue every step fetches exactly one layer's bytes
    per_step = {}
    for step, _, _, nbytes in rec:
        per_step[step] = per_step.get(step, 0) + nbytes
    layer = w[0].nbytes
    assert per_step.pop(-1) == layer * (max(2, min(ring, L)) - 1)
    assert set(per_step.values()) == {layer}


@pytest.mark.parametrize("chunk_dim", (0, 1))
def test_gpp_chunk_dim(chunk_dim):
    # a (D, F) leaf cut by rows or by columns, 3 chunks of uneven size
    rng = np.random.default_rng(5)
    w = rng.standard_normal((5, 8, 7)).astype(np.float32) * 0.3
    x = rng.standard_normal((2, 8)).astype(np.float32)
    out = ps.stream_layers(
        lambda c, ws: torch.tanh(c @ ws["w"])[:, :1].expand(-1, 8) + c,
        torch.from_numpy(x), {"w": torch.from_numpy(w)}, 5,
        settings=ps.StreamSettings(mode="gpp", ring_depth=4,
                                   chunk_dim=chunk_dim),
        mesh=None, shard_specs={"w": None}, full_specs={"w": None})
    want = x
    for i in range(5):
        want = np.tanh(want @ w[i])[:, :1].repeat(8, 1) + want
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=ATOL)


def test_naive_pp_and_insitu_issue_nothing_for_whole_leaves():
    # world size 1: the leaves are whole on the device, so only gpp copies
    w, x = _inputs(4)
    for mode in ("insitu", "naive_pp"):
        rec = []
        _port(mode, 3, w, x, 4, record=rec)
        assert rec == []


# ---------------------------------------------------------------------------
# settings and the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", ({"mode": "stream"}, {"ring_depth": 1},
                                {"ring_depth": 0}, {"mode": ""},
                                {"mode": "gpp", "ring_depth": -2}))
def test_settings_reject_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        js.StreamSettings(**kw)
    with pytest.raises(ValueError) as got:
        ps.StreamSettings(**kw)
    assert str(got.value) == str(want.value)


def test_settings_defaults_match_reference():
    assert ps.MODES == js.MODES
    ref = js.StreamSettings()
    got = ps.StreamSettings()
    assert (got.mode, got.ring_depth, got.chunk_dim, got.fsdp_axis) == \
        (ref.mode, ref.ring_depth, ref.chunk_dim, ref.fsdp_axis)


@pytest.mark.parametrize("data", (None, 1, 2, 4, 16))
@pytest.mark.parametrize("flops", (1e9, 3e10, 2e12))
def test_plan_for_layer_matches_reference(data, flops):
    # the reference's own rates (its defaults), passed to both
    rates = {"flops_per_s": 197e12, "ici_bytes_per_s": 50e9}
    kw = {"layer_bytes": 25.7e6, "layer_flops": flops}
    sizes = None if data is None else {"data": data, "model": 2}
    jmesh = None if data is None else types.SimpleNamespace(shape=sizes,
                                                            empty=False)
    want = js.plan_for_layer(mesh=jmesh, settings=js.StreamSettings(),
                             **kw, **rates)
    got = ps.plan_for_layer(mesh=sizes, settings=ps.StreamSettings(),
                            **kw, **rates)
    assert (got.ring_depth, got.chunks) == (want.ring_depth, want.chunks)
    assert got.t_compute == pytest.approx(want.t_compute, rel=1e-12)
    assert got.t_transfer == pytest.approx(want.t_transfer, rel=1e-12)


def test_config_stream_through_the_bridge():
    jcfg, _, cfg, _ = reference("qwen1.5-0.5b")
    assert isinstance(cfg.stream, ps.StreamSettings)
    j = jcfg.with_(stream=js.StreamSettings(mode="gpp", ring_depth=3,
                                            chunk_dim=0))
    got = config_from_reference(j).stream
    assert got == ps.StreamSettings(mode="gpp", ring_depth=3, chunk_dim=0)


# ---------------------------------------------------------------------------
# the streamed forward and loss
# ---------------------------------------------------------------------------

def _streamed(ring=3):
    jcfg, jparams, cfg, params = reference("qwen1.5-0.5b")
    jcfg = jcfg.with_(stream=js.StreamSettings(mode="gpp", ring_depth=ring))
    jspecs = jsteps._stream_pspecs(jcfg, types.SimpleNamespace(shape={}),
                                   jsteps._rules_for(
                                       jcfg, types.SimpleNamespace(shape={})))
    return jcfg, jparams, config_from_reference(jcfg), params, jspecs


def test_streamed_forward_matches_jax_and_resident():
    jcfg, jparams, cfg, params, jspecs = _streamed()
    batch = train_batch(cfg)
    del batch["labels"]
    want = np.asarray(jtf.forward(jparams, jcfg, batch, None, *jspecs))
    specs = stream_specs(cfg)
    got = tf.forward(params, cfg, as_torch(batch), None, *specs)
    err = np.abs(np32(got) - want).max()
    assert err <= 2e-4 * max(1.0, np.abs(want).max()), err
    resident = tf.forward(params, cfg.with_(stream=ps.StreamSettings()),
                          as_torch(batch))
    assert torch.equal(got, resident)
    hidden = tf.hidden_states(params, cfg, as_torch(batch), None, *specs)
    assert torch.equal(hidden, tf.hidden_states(params, cfg,
                                                as_torch(batch)))


def test_streamed_loss_and_grads_match_jax_and_resident():
    jcfg, jparams, cfg, params, jspecs = _streamed()
    batch = train_batch(cfg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.loss_fn(p, jcfg, batch, None, *jspecs)))(jparams)
    loss, grads = value_and_grad(cfg, params, as_torch(batch), None,
                                 *stream_specs(cfg))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert_grads_close(grads, tree_to_torch(jgrads))
    rloss, rgrads = value_and_grad(cfg.with_(stream=ps.StreamSettings()),
                                   params, as_torch(batch))
    assert torch.equal(loss, rloss)
    for g, r in zip(tf.tree_leaves(grads), tf.tree_leaves(rgrads)):
        assert torch.equal(g, r)
