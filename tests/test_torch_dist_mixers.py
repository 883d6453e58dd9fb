"""The tensor-parallel forms of MLA, cross attention, Mamba2, mLSTM and sLSTM,
Adafactor on a mesh, and the layer streamer over ("pod", "data"), on 4
ranks against the JAX package's mesh-less functions.

More than one rank runs on gloo only, as CPU processes: this file runs
itself as a script (`python tests/test_torch_dist_mixers.py OUT`) that
starts 4 ranks once (`launch.mesh.spawn_ranks`); the ranks build a 2x2 and
a 1x4 ("data", "model") mesh and a (2, 2, 1) ("pod", "data", "model") one,
run every case on the same numpy inputs (each leaf cut to the rank's piece
by `dist.sharding.piece` as its spec says, each dp rank its rows), and
rank 0 writes the outputs and the whole gradients to OUT.  The tests
compute the JAX package's mesh-less function, its output and `jax.grad` of
sum(out^2) / n over every row, on the same inputs, and hold the two to
output 2e-4, every gradient rtol 1e-3 / atol 1e-4:

  heads form, 2x2 (the heads divide the model axis):
    mla, mla_qlora  deepseek SMOKE widths (4 heads, kv_lora 32, rope 8),
                    without and with a q_lora rank
    cross           4 heads, 2 kv heads, over 8 encoder embeddings
    mamba           4 heads, d_inner 64, d_state 8
    mlstm, slstm    2 heads
  whole form, 1x4 (2 heads do not divide 4): mla_whole, cross_whole,
    mamba_whole, mlstm_whole, slstm_whole
The gradients of the inputs (x, and enc for cross) are held too.  For
every leaf and input whole on the model axis, its gradient is the same on
every model rank.  A gradient comes back whole: gathered over the axes its
leaf is split on, and summed over "data" when the leaf is whole there (the
dp ranks' rows), as the train step does.

  adafactor  2x2: a tree of leaves split over "data", "model", both, or
             neither; the ranks' pieces after two steps, gathered, within
             1e-6 of their scale of the JAX `adafactor_update` of the
             whole leaves, the factors whole and equal on every rank
  stream     (2, 2, 1): 4 layers whose leaves are split over ("pod",
             "data") on their rows (w1) and columns (w2, also the chunk
             dim), two rows a rank; insitu's, naive_pp's and gpp's
             outputs and gradients, gathered, within 1e-5 of
             single-process resident's over every row
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
B, S, T = 4, 16, 8          # rows, positions, encoder embeddings
MLA = dict(d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
           kv_lora_rank=32, rope_head_dim=8)
ATTN = {"mla": MLA, "mla_qlora": dict(MLA, q_lora_rank=16),
        "mla_whole": dict(MLA, num_heads=2, num_kv_heads=2),
        "cross": dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8),
        "cross_whole": dict(d_model=32, num_heads=2, num_kv_heads=1,
                            head_dim=8)}
SSM = {"mamba": dict(d_model=32, d_inner=64, d_state=8, n_heads=4),
       "mamba_whole": dict(d_model=32, d_inner=64, d_state=8, n_heads=2)}
XLSTM = {"mlstm": dict(d_model=32, n_heads=2),
         "slstm": dict(d_model=32, n_heads=2),
         "mlstm_whole": dict(d_model=32, n_heads=2),
         "slstm_whole": dict(d_model=32, n_heads=2)}
WHOLE = ("mla_whole", "cross_whole", "mamba_whole", "mlstm_whole",
         "slstm_whole")
# adafactor: (shape, spec on the 2x2 mesh)
ADAF = {"both": ((8, 6), ("data", "model")),
        "rows": ((4, 6, 8), (None, None, "model")),
        "cols": ((6, 8), ("data", None)),
        "whole": ((6, 5), (None, None)),
        "vec": ((8,), ("model",)),
        "flat": ((5,), (None,))}
ADAF_STEPS = 2
STREAM = dict(L=4, D=16, F=32)


def _normal(rng, shape, scale):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _params(specs, seed: int):
    """numpy leaves for a spec tree (anything with .shape): ones for norm
    scales, small normals otherwise (the SSM's A_log / D / dt_bias too)."""
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if "norm" in name:
            return np.ones(t.shape, np.float32)
        return _normal(rng, t.shape, 0.2)
    return walk(specs)


def _torch_cfgs(name):
    """(the port's config, its parameter specs) of a case."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import ssm as SM
    from repro_torch.models import xlstm as X
    f32 = torch.float32
    if name in ATTN:
        c = A.AttnConfig(**ATTN[name], dtype=f32)
        return c, (A.cross_attn_specs if name.startswith("cross")
                   else A.attn_specs)(c)
    if name in SSM:
        c = SM.SsmConfig(**SSM[name], dtype=f32)
        return c, SM.ssm_specs(c)
    c = X.XlstmConfig(**XLSTM[name], dtype=f32)
    return c, (X.mlstm_specs if name.startswith("mlstm")
               else X.slstm_specs)(c)


def _inputs():
    """Every case's (params, input) as numpy, the same in both processes."""
    rng = np.random.default_rng(11)
    out = {}
    for i, name in enumerate((*ATTN, *SSM, *XLSTM)):
        c, specs = _torch_cfgs(name)
        out[name] = (_params(specs, 20 + i),
                     _normal(rng, (B, S, c.d_model), 0.5))
    out["enc"] = _normal(rng, (B, T, 32), 0.5)
    out["adaf"] = [{k: _normal(rng, shape, 0.5)
                    for k, (shape, _) in ADAF.items()}
                   for _ in range(ADAF_STEPS + 1)]       # params, grads...
    L, D, F = STREAM["L"], STREAM["D"], STREAM["F"]
    out["stream"] = ({"w1": _normal(rng, (L, D, F), 0.3),
                      "w2": _normal(rng, (L, F, D), 0.3)},
                     _normal(rng, (8, D), 1.0))
    return out


def _run(name, p, x, enc=None, spec=None):
    """The port's forward of a case (on the mesh with `spec`)."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.models import ssm as SM
    from repro_torch.models import xlstm as X
    c, _ = _torch_cfgs(name)
    if name.startswith("mla"):
        pos = torch.arange(x.shape[1])[None].expand(x.shape[0], -1)
        return A.mla_forward(p, c, x, pos, spec)
    if name.startswith("cross"):
        return A.cross_attn_forward(p, c, x, enc, spec)
    if name.startswith("mamba"):
        return SM.ssm_forward(p, c, x, spec)
    fn = X.mlstm_forward if name.startswith("mlstm") else X.slstm_forward
    return fn(p, c, x, spec)


# ---------------------------------------------------------------------------
# the ranks (run by the script)
# ---------------------------------------------------------------------------

def _case(mesh, params, specs, fn, n):
    """Run fn(pieces) on the mesh; returns (whole output, whole gradients,
    max spread of the model-replicated leaves' gradients across the model
    ranks)."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.collectives import Par, all_reduce, on_mesh
    mine = {k: shd.piece(torch.from_numpy(a), specs[k], mesh)
            .requires_grad_() for k, a in params.items()}
    with on_mesh(mesh):
        out = fn(mine)
    names = sorted(mine)
    grads = torch.autograd.grad((out ** 2).sum() / n,
                                [mine[k] for k in names])
    par = Par(mesh)
    got, spread = {}, 0.0
    for k, g in zip(names, grads):
        s = specs[k]
        if "model" not in shd.leaf_axes(s):
            mx = all_reduce(g, par, ("model",), op="max")
            mn = -all_reduce(-g, par, ("model",), op="max")
            spread = max(spread, float((mx - mn).abs().max()))
        g = shd.whole(g, s, mesh)
        if "data" not in shd.leaf_axes(s):
            g = all_reduce(g, par, ("data",))
        got[k] = g.numpy()
    whole_out = shd.whole(out.detach(), ("data",), mesh)
    return whole_out.numpy(), got, spread


def _mixer(mesh, sizes, name, params, x, enc):
    """A case's output and the gradients of its leaves and of its inputs
    (x, and enc for cross attention: rows over "data")."""
    from repro_torch.dist import sharding as shd
    c, pspecs = _torch_cfgs(name)
    specs = shd.sharded_pspecs_one_layer(pspecs, sizes,
                                         shd.ShardRules(fsdp=False))
    leaves = dict(params, x=x)
    specs["x"] = ("data", None, None)
    if name.startswith("cross"):
        leaves["enc"], specs["enc"] = enc, ("data", None, None)
    n = x.size // x.shape[-1] * c.d_model
    return _case(mesh, leaves, specs,
                 lambda p: _run(name, {k: v for k, v in p.items()
                                       if k not in ("x", "enc")},
                                p["x"], p.get("enc"), specs), n)


def _adafactor(mesh):
    """Two Adafactor steps of the ranks' pieces; (the params gathered, the
    factors, the factors' spread across the ranks)."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.collectives import Par, all_reduce, on_mesh
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import adafactor as adaf
    steps = _inputs()["adaf"]
    specs = {k: s for k, (_, s) in ADAF.items()}
    whole = {k: torch.from_numpy(a) for k, a in steps[0].items()}
    params = shd.shard_tree(whole, specs, mesh)
    state = adaf.adafactor_init(whole)
    cfg = adaf.AdafactorConfig(lr=0.05, weight_decay=0.01)
    with on_mesh(mesh):
        for g in steps[1:]:
            grads = shd.shard_tree({k: torch.from_numpy(a)
                                    for k, a in g.items()}, specs, mesh)
            params, state, m = adaf.adafactor_update(cfg, grads, state,
                                                     params, specs=specs)
    par = Par(mesh)
    spread = 0.0
    for t in tree_leaves(state["factors"]):
        mx = all_reduce(t, par, ("data", "model"), op="max")
        mn = -all_reduce(-t, par, ("data", "model"), op="max")
        spread = max(spread, float((mx - mn).abs().max()))
    got = {k: v.numpy() for k, v in shd.gather_tree(params, specs,
                                                    mesh).items()}
    factors = {f"{k}/{n}": v.numpy() for k, st in state["factors"].items()
               for n, v in st.items()}
    return got, factors, spread, float(m["grad_norm"])


def _stream(mesh):
    """The streamed modes over (pod 2, data 2) FSDP shards, two rows a
    rank, against resident on one process over every row: the largest
    difference of the outputs and of the w1 / w2 gradients, gathered, per
    mode."""
    import torch
    from repro_torch.core.streamer import StreamSettings, stream_layers
    from repro_torch.dist import sharding as shd
    ws_np, x_np = _inputs()["stream"]
    fs = ("pod", "data")
    shard = {"w1": (fs, None), "w2": (None, fs)}
    full = {"w1": (None, None), "w2": (None, None)}
    stacked = {"w1": (None, fs, None), "w2": (None, None, fs)}
    L = STREAM["L"]

    def apply_fn(c, w):
        return torch.tanh(torch.tanh(c @ w["w1"]) @ w["w2"])

    def run(mode, ws, x, m=None):
        ws = {k: v.clone().requires_grad_() for k, v in ws.items()}
        y = stream_layers(apply_fn, x, ws, L,
                          settings=StreamSettings(mode=mode, ring_depth=3),
                          mesh=m, shard_specs=shard if m else None,
                          full_specs=full if m else None)
        return y.detach(), torch.autograd.grad((y ** 2).sum(),
                                               [ws["w1"], ws["w2"]])
    whole = {k: torch.from_numpy(v) for k, v in ws_np.items()}
    x = torch.from_numpy(x_np)
    ref_y, ref_g = run("resident", whole, x)
    mine = shd.shard_tree(whole, stacked, mesh)
    rows = shd.piece(x, (fs, None), mesh)
    out = {}
    for mode in ("insitu", "naive_pp", "gpp"):
        y, g = run(mode, mine, rows, mesh)
        y = shd.whole(y, (fs, None), mesh)
        g = [shd.whole(gi, stacked[k], mesh)
             for gi, k in zip(g, ("w1", "w2"))]
        out[mode] = max(float((y - ref_y).abs().max()),
                        *(float((a - b).abs().max())
                          for a, b in zip(g, ref_g)))
    return out


def _rank(rank, world, out_path):
    from repro_torch.launch.mesh import make_host_mesh
    inputs = _inputs()
    res = {}
    for shape, names in (((2, 2), [n for n in (*ATTN, *SSM, *XLSTM)
                                   if n not in WHOLE]),
                         ((1, 4), WHOLE)):
        mesh = make_host_mesh(*shape)
        sizes = {"data": shape[0], "model": shape[1]}
        for name in names:
            params, x = inputs[name]
            res[name] = _mixer(mesh, sizes, name, params, x, inputs["enc"])
        if shape == (2, 2):
            adaf = _adafactor(mesh)
    stream = _stream(make_host_mesh(2, 1, pod=2))
    if rank == 0:
        flat, meta = {}, {"spread": {}, "stream": stream}
        for name, (out, grads, spread) in res.items():
            flat[f"{name}/out"] = out
            for k, g in grads.items():
                flat[f"{name}/grad/{k}"] = g
            meta["spread"][name] = spread
        got, factors, spread, gnorm = adaf
        for k, v in got.items():
            flat[f"adaf/param/{k}"] = v
        for k, v in factors.items():
            flat[f"adaf/factor/{k}"] = v
        meta["adaf_spread"], meta["adaf_gnorm"] = spread, gnorm
        np.savez(out_path, **flat)
        Path(str(out_path) + ".json").write_text(json.dumps(meta))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks") / "mixers.npz"
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


def _jax_fn(name):
    """The JAX package's mesh-less function of a case: fn(params, x,
    enc)."""
    import jax.numpy as jnp
    from repro.models import attention as JA
    from repro.models import ssm as JS
    from repro.models import xlstm as JX
    f32 = jnp.float32
    if name.startswith("mla"):
        c = JA.AttnConfig(**ATTN[name], dtype=f32)

        def fn(p, x, enc):
            pos = jnp.broadcast_to(jnp.arange(x.shape[1])[None], x.shape[:2])
            return JA.mla_forward(p, c, x, pos)
        return fn
    if name.startswith("cross"):
        c = JA.AttnConfig(**ATTN[name], dtype=f32)
        return lambda p, x, enc: JA.cross_attn_forward(p, c, x, enc)
    if name.startswith("mamba"):
        c = JS.SsmConfig(**SSM[name], dtype=f32)
        return lambda p, x, enc: JS.ssm_forward(p, c, x)
    c = JX.XlstmConfig(**XLSTM[name], dtype=f32)
    fn = JX.mlstm_forward if name.startswith("mlstm") else JX.slstm_forward
    return lambda p, x, enc: fn(p, c, x)


def _jax_case(name, params, x, enc):
    """(output, the gradients of the leaves and of x / enc)."""
    import jax
    import jax.numpy as jnp
    fn = _jax_fn(name)
    leaves = dict(params, x=x)
    if name.startswith("cross"):
        leaves["enc"] = enc
    jp = jax.tree.map(jnp.asarray, leaves)
    ej = jnp.asarray(enc)

    def run(q):
        w = {k: v for k, v in q.items() if k not in ("x", "enc")}
        return fn(w, q["x"], q.get("enc", ej))
    out, grads = jax.jit(lambda p: (run(p), jax.grad(
        lambda q: (run(q) ** 2).sum() / run(q).size)(p)))(jp)
    return np.asarray(out), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("name", [n for n in (*ATTN, *SSM, *XLSTM)])
def test_mixer_forms_match_the_reference(ranks, inputs, name):
    got, _ = ranks
    params, x = inputs[name]
    out, grads = _jax_case(name, params, x, inputs["enc"])
    np.testing.assert_allclose(got[f"{name}/out"], out, rtol=2e-4,
                               atol=2e-4)
    assert set(grads) == {k.split("/")[-1] for k in got
                          if k.startswith(f"{name}/grad/")}
    for k, g in grads.items():
        np.testing.assert_allclose(got[f"{name}/grad/{k}"], g, rtol=1e-3,
                                   atol=1e-4, err_msg=f"{name} {k}")


def test_replicated_gradients_agree_across_model_ranks(ranks):
    _, meta = ranks
    assert max(meta["spread"].values()) == 0.0, meta["spread"]


def _jax_adafactor(steps):
    import jax
    import jax.numpy as jnp
    from repro.optim import adafactor as JO
    cfg = JO.AdafactorConfig(lr=0.05, weight_decay=0.01)
    params = jax.tree.map(jnp.asarray, steps[0])
    state = JO.adafactor_init(params)
    for g in steps[1:]:
        params, state, m = JO.adafactor_update(
            cfg, jax.tree.map(jnp.asarray, g), state, params)
    return params, state, m


def test_adafactor_pieces_match_the_whole_update(ranks, inputs):
    got, meta = ranks
    params, state, m = _jax_adafactor(inputs["adaf"])
    for k, want in params.items():
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-3)
        err = float(np.abs(got[f"adaf/param/{k}"] - want).max())
        assert err <= 1e-6 * scale, (k, err)
    for k, st in state["factors"].items():
        for n, want in st.items():
            want = np.asarray(want)
            have = got[f"adaf/factor/{k}/{n}"]
            assert have.shape == want.shape, (k, n)
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-9,
                                       err_msg=f"{k} {n}")
    assert meta["adaf_spread"] == 0.0
    assert abs(meta["adaf_gnorm"] - float(m["grad_norm"])) <= \
        1e-6 * float(m["grad_norm"])


@pytest.mark.parametrize("mode", ("insitu", "naive_pp", "gpp"))
def test_streamer_over_pod_and_data_matches_resident(ranks, mode):
    _, meta = ranks
    assert meta["stream"][mode] <= 1e-5, meta["stream"]


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import spawn_ranks
    spawn_ranks(_rank, 4, sys.argv[1])
