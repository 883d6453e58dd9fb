"""The port's sharded steps on one rank, against the JAX package, in this
process (no spawn).

  specs   `launch.steps._rules_for`, `dist.sharding.param_pspecs` (train
          and serve rules) and `cache_pspecs` (batches 1 / 8 / 128) equal
          the reference's `PartitionSpec`s, read as tuples, for every arch
          on mesh shapes (2, 2), (16, 16) and (2, 16, 16).  Pure functions:
          the reference reads a mesh through `.shape` / `.axis_names`, so a
          namespace stands in for it.  Adafactor's state specs: the
          factors' shapes equal the reference's, and `make_train_step`
          keeps every factor whole, as the reference's does.
  1x1     a gloo process group of one rank (a `HashStore`, destroyed at the
          module's end so the other files of the same worker see no group)
          and a 1x1 ("data", "model") `DeviceMesh`, against the JAX package
          under `make_mesh_compat((1, 1))` on its one CPU device, where the
          reference takes its `_moe_shard_map*` paths: `moe_apply` with
          dropped tokens (capacity_factor 1.0; one dispatch group, as the
          reference's shard map) within 1e-5, in both the train and the
          serve form, and `make_train_step` / `make_prefill_step` /
          `make_decode_step` on SMOKE qwen1.5-0.5b and deepseek-v2-lite
          (2 layers: the dense one and a MoE one) at f32 within 1e-4
          (loss, grad norm and updated parameters at step 200, past the
          warm-up, so that AdamW's +-3e-4 update shows; every gradient
          leaf of the step within 1e-4 of its own scale of the mesh-less
          `value_and_grad`'s, which test_torch_train_loss.py holds to
          `jax.value_and_grad`, at a capacity that drops no token;
          logits and caches).
"""
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.configs.base import ShapeConfig as JShape
from repro.dist import sharding as jshd
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh_compat, mesh_context
from repro.models import moe as JM
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.models.layers import init_from_specs as jinit
from repro.optim import adafactor as jadafactor
from repro.optim import adamw as jadamw
from repro_torch.bridge import config_from_reference
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import on_mesh
from repro_torch.launch import steps
from repro_torch.models import moe as M
from repro_torch.models import transformer as tf
from repro_torch.models.layers import tree_map
from repro_torch.models.registry import ARCH_NAMES
from repro_torch.optim import adafactor, adamw

from _torch_parity import np32, tree_to_torch

pytestmark = pytest.mark.tier1

MESHES = {"2x2": {"data": 2, "model": 2},
          "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
RULE_FIELDS = ("tp_axis", "fsdp_axes", "dp_axes", "fsdp", "moe_ep_mode",
               "moe_serve_resident")


def _jflat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P) or x is None)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            None if spec is None else tuple(spec) for path, spec in leaves}


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in _flat(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: s for i, v in enumerate(tree)
                for p, s in _flat(v, path + (i,)).items()}
    return {path: tree}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_spec_trees_match_reference(arch, mesh):
    sizes = MESHES[mesh]
    jmesh = types.SimpleNamespace(shape=sizes, axis_names=tuple(sizes))
    jcfg = jregistry.get_config(arch, smoke=True)
    cfg = config_from_reference(jcfg)
    for serve in (False, True):
        jr = jsteps._rules_for(jcfg, jmesh, serve)
        r = steps._rules_for(cfg, sizes, serve)
        assert {k: getattr(r, k) for k in RULE_FIELDS} == \
            {k: getattr(jr, k) for k in RULE_FIELDS}
        want = _jflat(jshd.param_pspecs(jtf.param_specs(jcfg), jmesh, jr))
        assert _flat(shd.param_pspecs(tf.param_specs(cfg), sizes, r)) == want
        for batch in (1, 8, 128):
            want = _jflat(jshd.cache_pspecs(jtf.cache_specs(jcfg, batch, 64),
                                            jmesh, jr, batch))
            got = _flat(shd.cache_pspecs(tf.cache_specs(cfg, batch, 64),
                                         sizes, r, batch))
            assert got == want, (serve, batch)
    # Adafactor's state: the reference's make_train_step keeps every factor
    # whole (src/repro/launch/steps.py:93-100); the shapes are its own
    jfac = jax.tree_util.tree_flatten_with_path(
        jadafactor.adafactor_state_specs(jtf.param_specs(jcfg))["factors"])[0]
    jfac = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(s.shape) for path, s in jfac}
    fac = _flat(adafactor.adafactor_state_specs(tf.param_specs(cfg))
                ["factors"])
    assert {k: tuple(v.shape) for k, v in fac.items()} == jfac
    opt = steps.make_train_step(cfg.with_(optimizer="adafactor"), sizes,
                                ShapeConfig("t", 64, 8, "train")).arg_specs[1]
    assert _flat(opt["factors"]) == {k: (None,) * len(v)
                                     for k, v in jfac.items()}
    assert opt["count"] == ()


# ---------------------------------------------------------------------------
# a 1x1 mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already up")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        yield mesh, make_mesh_compat((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


MOE = dict(d_model=32, d_ff=16, num_experts=8, experts_per_token=2,
           capacity_factor=1.0, dispatch_groups=4)


@pytest.mark.parametrize("serve", (False, True), ids=("train", "serve"))
def test_moe_apply_drops_tokens_as_the_reference(meshes, serve):
    mesh, jmesh = meshes
    jc = JM.MoeConfig(**MOE, dtype=jnp.float32, serve_resident=serve)
    c = M.MoeConfig(**MOE, dtype=torch.float32, serve_resident=serve)
    jp = jinit(JM.moe_specs(jc), jax.random.PRNGKey(0))
    x = (np.random.default_rng(1).standard_normal((4, 16, 32)) * 0.5
         ).astype(np.float32)
    with mesh_context(jmesh):
        want = np.asarray(jax.jit(lambda p, x: JM.moe_apply(p, jc, x))(jp, x))
    p = tree_to_torch(jp)
    # the port's mesh-less dispatch in 4 groups (held to the reference's
    # by test_torch_moe.py)
    local = np32(M.moe_apply(p, c, torch.from_numpy(x)))
    spec = shd.map_spec_tree(lambda s: (None,) * len(s.shape),
                             M.moe_specs(c))
    with on_mesh(mesh):
        got = np32(M.moe_apply(p, c, torch.from_numpy(x), spec=spec))
    scale = np.abs(want).max()
    # the one group drops other tokens than the four groups do
    assert np.abs(local - want).max() > 1e-2 * scale
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.abs(got - want).max() <= 1e-4 * scale


def _close(got, want, tol=1e-4):
    got, want = np32(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _same(got, want, tol=1e-4):
    fg, fw = _flat(got), _jflat_arrays(want)
    assert set(fg) == set(fw)
    for k in fw:
        if fw[k] is None:
            assert fg[k] is None, k
        else:
            _close(fg[k], fw[k], tol)


def _leafwise(got, want, tol=1e-4):
    """Each leaf within `tol` of its own largest |value| (1e-3 of the
    tree's largest for a leaf near 0)."""
    fg, fw = _flat(got), {k: np32(w) for k, w in _flat(want).items()}
    assert set(fg) == set(fw)
    top = max(np.abs(w).max() for w in fw.values())
    for k, w in fw.items():
        g = np32(fg[k])
        assert g.shape == w.shape, k
        scale = max(np.abs(w).max(), 1e-3 * top)
        assert np.abs(g - w).max() <= tol * scale, k


def _jflat_arrays(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: x is None)[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            None if a is None else np.asarray(a) for path, a in leaves}


STEP_ARCHS = ("qwen1.5-0.5b", "deepseek-v2-lite-16b")


@pytest.fixture(scope="module", params=STEP_ARCHS)
def model(request, meshes):
    # deepseek at 2 of its 3 SMOKE layers: the dense layer and one MoE
    jcfg = jregistry.get_config(request.param, smoke=True).with_(
        dtype="float32", num_layers=2)
    cfg = config_from_reference(jcfg)
    # the same numbers on both sides (the port's init is quick)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jparams = jax.tree.map(jnp.asarray, _to_numpy(params))
    return jcfg, jparams, cfg, params


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


# past the warm-up: the learning rate at its 3e-4 peak, so that AdamW's
# first update (about +-lr a weight) is larger than the 1e-4 it is held to
TRAIN_STEP = 200


def test_train_step_matches_reference(meshes, model):
    mesh, jmesh = meshes
    jcfg, jparams, cfg, params = model
    B, S = 2, 16
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    with mesh_context(jmesh):
        jb = jsteps.make_train_step(jcfg, jmesh, JShape("t", S, B, "train"))
        # the jitted step donates its parameters: give it a copy
        mine = jax.tree.map(lambda a: jnp.array(a, copy=True), jparams)
        jp, _, jm = jb.fn(mine, jadamw.adamw_init(mine), batch,
                          jnp.asarray(TRAIN_STEP))
        jp = jax.tree.map(np.asarray, jp)
    b = steps.make_train_step(cfg, mesh, ShapeConfig("t", S, B, "train"))
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    # the step's own gradients, every leaf put back together, against the
    # mesh-less `value_and_grad`, whose every leaf test_torch_train_loss.py
    # holds to `jax.value_and_grad` at this tolerance (a second JAX
    # compile of the backward here would cost the file its time budget);
    # at a capacity that drops no token, where the mesh's one dispatch
    # group and the mesh-less groups are the same function
    gcfg = cfg.with_(moe_capacity_factor=cfg.num_experts
                     / cfg.experts_per_token) if cfg.num_experts else cfg
    gb = steps.make_train_step(gcfg, mesh, ShapeConfig("t", S, B, "train"))
    loss, grads = gb.meta["loss_and_grads"](params, tb)
    wloss, wgrads = steps.value_and_grad(gcfg, params, tb)
    _close(loss, wloss)
    _leafwise(shd.gather_tree(grads, gb.arg_specs[0], mesh), wgrads)
    # the step consumes its parameters: give it a copy, as for JAX's
    p, _, m = b.fn(tree_map(torch.clone, params), adamw.adamw_init(params),
                   tb, TRAIN_STEP)
    _close(m["loss"], jm["loss"])
    _close(m["grad_norm"], jm["grad_norm"])
    assert abs(float(m["lr"]) - 3e-4) <= 1e-9
    _same(p, jp)


def test_prefill_and_decode_steps_match_reference(meshes, model):
    mesh, jmesh = meshes
    jcfg, jparams, cfg, params = model
    B, S, T = 2, 12, 16
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (3, B, 1)).astype(np.int32)
    with mesh_context(jmesh):
        jpre = jsteps.make_prefill_step(jcfg, jmesh,
                                        JShape("p", T, B, "prefill"))
        jdec = jsteps.make_decode_step(jcfg, jmesh,
                                       JShape("d", T, B, "decode"))
        jl, jc = jpre.fn(jparams, {"tokens": toks[:, :S]})
        # the jitted decode donates its caches: keep copies
        want = [(np.array(jl), jax.tree.map(np.array, jc))]
        for i in range(3):
            jl, jc = jdec.fn(jparams, nxt[i], jc, jnp.asarray(S + i))
            want.append((np.array(jl), jax.tree.map(np.array, jc)))
    pre = steps.make_prefill_step(cfg, mesh, ShapeConfig("p", T, B,
                                                         "prefill"))
    dec = steps.make_step(cfg, mesh, ShapeConfig("d", T, B, "decode"))
    gl, gc = pre.fn(params, {"tokens": torch.from_numpy(toks).long()})
    # the decode step writes its caches in place: keep copies
    got = [(gl, tree_map(torch.clone, gc))]
    for i in range(3):
        gl, gc = dec.fn(params, torch.from_numpy(nxt[i]).long(), gc, S + i)
        got.append((gl, tree_map(torch.clone, gc)))
    for (gl, gc), (jl, jc) in zip(got, want):
        _close(gl, jl)
        _same(gc, jc)


# ---------------------------------------------------------------------------
# the context-parallel attention's key-blocked softmax, in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", (None, 16), ids=("causal", "window16"))
@pytest.mark.parametrize("q_offset,rows", ((0, 64), (16, 16), (48, 16)))
def test_sdpa_kv_chunked_matches_reference(window, q_offset, rows):
    """`attention._sdpa_kv_chunked` against the reference's at 16-key
    blocks over 64 keys (a context-parallel rank's rows at q_offset), 6 /
    2 heads x 8, f32, within 1e-5; both also equal `_sdpa`."""
    from repro.models import attention as JA
    from repro_torch.models import attention as A
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, rows, 6, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 64, 2, 8)).astype(np.float32)
            for _ in range(2))
    scale = 8 ** -0.5
    want = np.asarray(JA._sdpa_kv_chunked(q, k, v, scale, window=window,
                                          chunk=16, q_offset=q_offset))
    got = np32(A._sdpa_kv_chunked(*map(torch.from_numpy, (q, k, v)), scale,
                                  window=window, chunk=16,
                                  q_offset=q_offset))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    plain = np32(A._sdpa(*map(torch.from_numpy, (q, k, v)),
                         A.causal_mask(rows, 64, q_offset, window), scale))
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
