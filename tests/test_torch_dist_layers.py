"""The tensor-parallel and context-parallel layer forms on 4 ranks, against
the JAX package's mesh-less functions, mirroring `tests/test_distributed.
py::TestContextParallelAttention` and `TestMoEShardMap`.

More than one rank runs on gloo only, as CPU processes: this file runs
itself as a script (`python tests/test_torch_dist_layers.py OUT`) that
starts 4 ranks once (`launch.mesh.spawn_ranks`); the ranks build a 1x4
and a 2x2 ("data", "model") mesh, run every case on the same numpy inputs
(each leaf cut to the rank's piece by `dist.sharding.shard_tree` as its
spec says, each dp rank its rows), and rank 0 writes the outputs and the
whole gradients to OUT.  The tests compute the JAX package's mesh-less
function, its output and `jax.grad` of the same loss (sum(out^2) / n over
every row), on the same inputs and hold the two to:

  cp         1x4, AttnConfig(48, 6 heads, 2 kv heads, 8): 6 heads do not
             divide 4, so the context-parallel form; output 2e-4, the w_q
             gradient rtol 1e-3 / atol 1e-4; window 16 (3 heads, 1 kv
             head): output 2e-4
  heads      2x2, GQA with q/k/v biases (4 heads, 2 kv heads) and MQA (4
             heads, 1 kv head): output and every gradient
  mlp, embed, head_vocab, head_dmodel
             2x2: output and every gradient (the head with its vocab or its
             d_model on the model axis)
  moe        `_moe_shard_map` on 2x2 (w_* as ("model", "data", None),
             capacity_factor 8.0): output 1e-4 of JAX's `moe_apply`,
             router / w_gate / w_up / w_down gradients rtol 1e-3 / atol
             1e-4; `_moe_shard_map_serve` (w_* as ("model", None, None),
             d_ff cut over "data" inside) likewise
and, for every leaf whole on the model axis, its gradient is the same on
every model rank.  A gradient comes back whole: gathered over the axes its
leaf is split on, and summed over "data" when the leaf is whole there (the
dp ranks' rows), as the train step does, except in the serve form, whose
collectives already sum it.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
GQA = {"heads": dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                     qkv_bias=True),
       "mqa": dict(d_model=32, num_heads=4, num_kv_heads=1, head_dim=8)}
CP = dict(d_model=48, num_heads=6, num_kv_heads=2, head_dim=8)
CP_WINDOW = dict(d_model=24, num_heads=3, num_kv_heads=1, head_dim=8,
                 window=16)
MOE = dict(d_model=32, d_ff=16, num_experts=8, experts_per_token=2,
           capacity_factor=8.0, dispatch_groups=4)
D, F, V = 32, 64, 64


def _normal(rng, shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(specs, seed: int):
    """numpy leaves for a spec tree (anything with .shape): ones for norm
    scales, small normals otherwise."""
    rng = np.random.default_rng(seed)

    def leaf(name, s):
        if "norm" in name or name == "scale":
            return np.ones(s.shape, np.float32)
        return _normal(rng, s.shape, 0.2)

    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        return leaf(name, t)
    return walk(specs)


def _inputs():
    """Every case's (params, input) as numpy, the same in both processes."""
    from repro_torch.models import attention as A
    from repro_torch.models import moe as M
    from repro_torch.models.layers import Spec
    import torch
    f32 = torch.float32
    rng = np.random.default_rng(7)
    out = {}
    for name, kw in (("cp", CP), ("cp_window", CP_WINDOW)):
        c = A.AttnConfig(**kw, dtype=f32)
        B = 4 if name == "cp" else 2
        out[name] = (_params(A.attn_specs(c), 1),
                     _normal(rng, (B, 64, kw["d_model"]), 0.5))
    for name, kw in GQA.items():
        c = A.AttnConfig(**kw, dtype=f32)
        out[name] = (_params(A.attn_specs(c), 2), _normal(rng, (4, 16, D),
                                                           0.5))
    out["mlp"] = (_params({"w_gate": Spec((D, F), f32),
                           "w_up": Spec((D, F), f32),
                           "w_down": Spec((F, D), f32)}, 3),
                  _normal(rng, (4, 16, D), 0.5))
    out["embed"] = (_params({"embedding": Spec((V, D), f32)}, 4),
                    rng.integers(0, V, (4, 16)).astype(np.int64))
    for name in ("head_vocab", "head_dmodel"):
        out[name] = (_params({"embedding": Spec((V, D), f32)}, 5),
                     _normal(rng, (4, 16, D), 0.5))
    out["labels"] = rng.integers(0, V, (4, 16)).astype(np.int64)
    out["embed_w"] = _normal(rng, (4, 16, D), 1.0)
    for name, serve in (("moe", False), ("moe_serve", True)):
        c = M.MoeConfig(**MOE, dtype=f32, serve_resident=serve)
        out[name] = (_params(M.moe_specs(c), 6), _normal(rng, (4, 16, D),
                                                          0.5))
    return out


# ---------------------------------------------------------------------------
# the ranks (run by the script)
# ---------------------------------------------------------------------------

def _case(mesh, params, specs, x, x_spec, fn, loss_fn, dp_sum=True):
    """Run fn(pieces, x piece) on the mesh; returns (whole output, whole
    gradients, max spread of the replicated leaves' gradients across the
    model ranks)."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.collectives import Par, all_reduce, on_mesh
    whole = shd.map_spec_tree(lambda s, a: torch.from_numpy(a), specs,
                              params)
    mine = shd.map_spec_tree(lambda s, t: shd.piece(t, s, mesh)
                             .requires_grad_(), specs, whole)
    xin = shd.piece(torch.from_numpy(x), x_spec, mesh)
    with on_mesh(mesh):
        out = fn(mine, xin)
    names = sorted(mine)
    loss = loss_fn(out)
    grads = torch.autograd.grad(loss, [mine[n] for n in names])
    par = Par(mesh)
    got = {}
    spread = 0.0
    for n, g in zip(names, grads):
        s = specs[n]
        if "model" not in shd.leaf_axes(s):
            mx = all_reduce(g, par, ("model",), op="max")
            mn = -all_reduce(-g, par, ("model",), op="max")
            spread = max(spread, float((mx - mn).abs().max()))
        g = shd.whole(g, s, mesh)
        if dp_sum and "data" not in shd.leaf_axes(s):
            g = all_reduce(g, par, ("data",))
        got[n] = g.numpy()
    out_spec = (x_spec[0],) + (None,) * (out.dim() - 1)
    return shd.whole(out.detach(), out_spec, mesh).numpy(), got, spread


def _sq_loss(n):
    return lambda out: (out ** 2).sum() / n


def _rank(rank, world, out_path):
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import attention as A
    from repro_torch.models import layers as Ly
    from repro_torch.models import moe as M
    f32 = torch.float32
    inputs = _inputs()
    res = {}
    no_fsdp = shd.ShardRules(fsdp=False)

    def attn_case(name, kw, mesh, sizes, x_spec):
        c = A.AttnConfig(**kw, dtype=f32)
        params, x = inputs[name]
        specs = shd.sharded_pspecs_one_layer(A.attn_specs(c), sizes, no_fsdp)
        B, S = x.shape[:2]
        pos = torch.arange(S)[None].expand(x.shape[0] // (
            sizes["data"] if x_spec[0] else 1), S)
        return _case(mesh, params, specs, x, x_spec,
                     lambda p, xi: A.gqa_forward(p, c, xi, pos[:xi.shape[0]],
                                                 specs),
                     _sq_loss(x.size // x.shape[-1] * c.d_model))

    mesh = make_host_mesh(1, 4)
    sizes = {"data": 1, "model": 4}
    for name, kw in (("cp", CP), ("cp_window", CP_WINDOW)):
        res[name] = attn_case(name, kw, mesh, sizes, (None, None, None))

    mesh = make_host_mesh(2, 2)
    sizes = {"data": 2, "model": 2}
    rows = ("data", None, None)
    for name, kw in GQA.items():
        res[name] = attn_case(name, kw, mesh, sizes, rows)

    n = 4 * 16 * D
    params, x = inputs["mlp"]
    specs = shd.sharded_pspecs_one_layer(
        {k: Ly.Spec(v.shape, f32) for k, v in params.items()}, sizes,
        no_fsdp)
    res["mlp"] = _case(mesh, params, specs, x, rows,
                       lambda p, xi: Ly.mlp(p, xi, "swiglu", spec=specs),
                       _sq_loss(n))

    params, toks = inputs["embed"]
    specs = {"embedding": ("model", None)}
    w = torch.from_numpy(inputs["embed_w"]).chunk(2)[mesh.get_local_rank(
        "data")]
    res["embed"] = _case(mesh, params, specs, toks, ("data", None),
                         lambda p, t: Ly.embed(p, t, specs),
                         lambda out: (out * w).sum() / n)

    labels = torch.from_numpy(inputs["labels"]).chunk(2)[
        mesh.get_local_rank("data")]
    for name, spec in (("head_vocab", ("model", None)),
                       ("head_dmodel", (None, "model"))):
        params, x = inputs[name]
        specs = {"embedding": spec}
        res[name] = _case(
            mesh, params, specs, x, rows,
            lambda p, xi, spec=spec: Ly.head_logits_tp(xi, p["embedding"],
                                                       spec, "ref"),
            lambda out: Ly._token_nll(out, labels).sum() / (4 * 16))

    for name, serve in (("moe", False), ("moe_serve", True)):
        c = M.MoeConfig(**MOE, dtype=f32, serve_resident=serve)
        params, x = inputs[name]
        w_spec = ("model", None, None) if serve else ("model", "data", None)
        specs = {"router": (None, None), "w_gate": w_spec, "w_up": w_spec,
                 "w_down": w_spec}
        res[name] = _case(mesh, params, specs, x, rows,
                          lambda p, xi, c=c, specs=specs: M.moe_apply(
                              p, c, xi, spec=specs),
                          _sq_loss(n), dp_sum=not serve)

    if rank == 0:
        flat = {}
        meta = {}
        for name, (out, grads, spread) in res.items():
            flat[f"{name}/out"] = out
            for k, g in grads.items():
                flat[f"{name}/grad/{k}"] = g
            meta[name] = spread
        np.savez(out_path, **flat)
        Path(str(out_path) + ".json").write_text(json.dumps(meta))


def _main(argv):
    from repro_torch.launch.mesh import spawn_ranks
    spawn_ranks(_rank, 4, argv[0])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks") / "layers.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, str(out)],
                          capture_output=True, text=True, timeout=240,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out) as data:
        got = dict(data)
    return got, json.loads(Path(str(out) + ".json").read_text())


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def _jax_case(fn, params, x, loss):
    import jax
    import jax.numpy as jnp
    jp = jax.tree.map(jnp.asarray, params)
    xj = jnp.asarray(x)
    out, grads = jax.jit(lambda p: (fn(p, xj), jax.grad(
        lambda q: loss(fn(q, xj)))(p)))(jp)
    return np.asarray(out), jax.tree.map(np.asarray, grads)


def _jax_attn(kw, params, x):
    import jax.numpy as jnp
    from repro.models import attention as JA
    c = JA.AttnConfig(**kw, dtype=jnp.float32)
    B, S = x.shape[:2]
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    return _jax_case(lambda p, xi: JA.gqa_forward(p, c, xi, pos), params, x,
                     lambda o: (o ** 2).sum() / o.size)


def _check(got, name, out, grads, out_tol, rtol, atol, only=None):
    np.testing.assert_allclose(got[f"{name}/out"], out, rtol=out_tol,
                               atol=out_tol)
    for k, g in grads.items():
        if only is None or k in only:
            np.testing.assert_allclose(got[f"{name}/grad/{k}"], g, rtol=rtol,
                                       atol=atol, err_msg=f"{name} {k}")


def test_context_parallel_attention(ranks, inputs):
    got, _ = ranks
    out, grads = _jax_attn(CP, *inputs["cp"])
    _check(got, "cp", out, grads, 2e-4, 1e-3, 1e-4, only=("w_q",))


def test_context_parallel_attention_with_a_window(ranks, inputs):
    got, _ = ranks
    out, _ = _jax_attn(CP_WINDOW, *inputs["cp_window"])
    np.testing.assert_allclose(got["cp_window/out"], out, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("name", GQA)
def test_head_parallel_attention(ranks, inputs, name):
    got, _ = ranks
    out, grads = _jax_attn(GQA[name], *inputs[name])
    _check(got, name, out, grads, 2e-4, 1e-3, 1e-4)


def test_tensor_parallel_mlp(ranks, inputs):
    from repro.models import layers as JL
    got, _ = ranks
    out, grads = _jax_case(lambda p, x: JL.mlp(p, x, "swiglu"),
                           *inputs["mlp"], lambda o: (o ** 2).sum() / o.size)
    _check(got, "mlp", out, grads, 1e-4, 1e-3, 1e-4)


def test_vocab_parallel_embedding(ranks, inputs):
    from repro.models import layers as JL
    got, _ = ranks
    w = inputs["embed_w"]
    out, grads = _jax_case(lambda p, t: JL.embed(p, t), *inputs["embed"],
                           lambda o: (o * w).sum() / o.size)
    _check(got, "embed", out, grads, 1e-6, 1e-5, 1e-6)


@pytest.mark.parametrize("name", ("head_vocab", "head_dmodel"))
def test_tensor_parallel_head(ranks, inputs, name):
    from repro.models import layers as JL
    got, _ = ranks
    labels = inputs["labels"]
    out, grads = _jax_case(lambda p, x: JL.unembed(p, x), *inputs[name],
                           lambda o: JL.cross_entropy(o, labels))
    _check(got, name, out, grads, 1e-4, 1e-3, 1e-4)


@pytest.mark.parametrize("name", ("moe", "moe_serve"))
def test_moe_shard_maps(ranks, inputs, name):
    import jax.numpy as jnp
    from repro.models import moe as JM
    got, _ = ranks
    c = JM.MoeConfig(**MOE, dtype=jnp.float32)
    out, grads = _jax_case(lambda p, x: JM.moe_apply(p, c, x), *inputs[name],
                           lambda o: (o ** 2).sum() / o.size)
    _check(got, name, out, grads, 1e-4, 1e-3, 1e-4)


def test_replicated_gradients_agree_across_model_ranks(ranks):
    _, spread = ranks
    assert max(spread.values()) == 0.0, spread


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    _main(sys.argv[1:])
