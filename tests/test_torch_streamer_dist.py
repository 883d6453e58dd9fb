"""The layer streamer across ranks: FSDP-sharded layers gathered over a
process group, mirroring `tests/test_distributed.py::TestStreamerDistributed`
(and its gradient test) on the port.

More than one rank runs on gloo only, as CPU processes: this file runs
itself as a script (`python tests/test_torch_streamer_dist.py WORLD OUT
CASES`) that starts WORLD gloo ranks meeting at a file store
(`launch.mesh.spawn_ranks`), each of which builds
`launch.mesh.make_host_mesh(WORLD, 1)` and runs the named cases;
rank 0 writes what they measured to OUT as JSON, and the tests below hold
it to the tolerances.  Two spawns in all (4 ranks, then 2):

  toy    the reference's toy (L = 6, D = 64, F = 128, B = 8 rows split
         over 4 ranks, ring 3; w1 sharded on its rows, w2 on its columns,
         which is also its chunk dim): every mode's output equals the
         single-process resident run's rows (atol 1e-5), the count of
         `all_gather` calls is gpp > naive_pp >= insitu > 0, and gpp with
         `chunk_dim` 0 (w1's FSDP dim) at rings 3 and 4 (uneven
         sub-chunks of a rank's shard) equals resident too
  grads  L = 5, D = 32, one row a rank, loss mean(y^2) summed over ranks:
         each streamed mode's gradient, reduce-scattered to the ranks'
         shards and gathered back, equals single-process resident's (rtol
         1e-4, atol 1e-5), also with the chunk dim on the FSDP dim
  qwen   qwen1.5-0.5b SMOKE at f32, its stacked blocks FSDP-sharded by
         `param_pspecs` over 2 ranks, `loss_fn` streamed by gpp (ring 3)
         with `stream_specs`, half the batch a rank: the mean of the
         ranks' losses equals resident's loss on the whole batch (rtol
         1e-5), and the gradients (each rank's loss over 2; shards
         gathered, whole leaves summed) equal resident's (1e-4 of a
         leaf's scale)
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
MODES = ("insitu", "naive_pp", "gpp")


# ---------------------------------------------------------------------------
# the ranks (run by the script)
# ---------------------------------------------------------------------------

def _shard(t, dim: int, rank: int, n: int):
    per = t.shape[dim] // n
    return t.narrow(dim, rank * per, per).clone()


def _gather_cat(t, dim: int, n: int):
    import torch
    import torch.distributed as dist
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous())
    return torch.cat(parts, dim=dim)


def _count_gathers():
    """Wrap `torch.distributed.all_gather` with a call counter."""
    import torch.distributed as dist
    inner = dist.all_gather
    box = {"n": 0}

    def counted(*a, **kw):
        box["n"] += 1
        return inner(*a, **kw)
    dist.all_gather = counted
    return box, lambda: setattr(dist, "all_gather", inner)


def _case_toy(rank, n, mesh):
    import torch
    from repro_torch.core.streamer import StreamSettings, stream_layers
    L, D, F, B = 6, 64, 128, 8
    rng = np.random.default_rng(0)
    w1 = torch.from_numpy((rng.standard_normal((L, D, F)) * 0.05)
                          .astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((L, F, D)) * 0.05)
                          .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))
    shard = {"w1": ("data", None), "w2": (None, "data")}
    full = {"w1": (None, None), "w2": (None, None)}
    local = {"w1": _shard(w1, 1, rank, n), "w2": _shard(w2, 2, rank, n)}
    rows = _shard(x, 0, rank, n)

    def apply_fn(c, w):
        return c + torch.tanh(c @ w["w1"]) @ w["w2"]

    want = _shard(stream_layers(apply_fn, x, {"w1": w1, "w2": w2}, L,
                                settings=StreamSettings(), mesh=None,
                                shard_specs=None, full_specs=None), 0,
                  rank, n)
    out = {"err": {}, "gathers": {}}
    box, undo = _count_gathers()
    runs = [(m, StreamSettings(mode=m, ring_depth=3)) for m in MODES]
    runs += [(f"gpp ring {g} chunk_dim 0",
              StreamSettings(mode="gpp", ring_depth=g, chunk_dim=0))
             for g in (3, 4)]
    for name, st in runs:
        box["n"] = 0
        got = stream_layers(apply_fn, rows, local, L, settings=st,
                            mesh=mesh, shard_specs=shard, full_specs=full)
        out["err"][name] = float((got - want).abs().max())
        out["gathers"][name] = box["n"]
    undo()
    return out


def _case_grads(rank, n, mesh):
    import torch
    from repro_torch.core.streamer import StreamSettings, stream_layers
    L, D, B = 5, 32, n
    rng = np.random.default_rng(1)
    w = torch.from_numpy((rng.standard_normal((L, D, D)) * 0.1)
                         .astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))

    def apply_fn(c, ws):
        return torch.tanh(c @ ws["w"])

    def grad(mode, xs, ws, mesh_, shard, cd=-1):
        ws = ws.clone().requires_grad_()
        y = stream_layers(apply_fn, xs, {"w": ws}, L,
                          settings=StreamSettings(mode=mode, ring_depth=4,
                                                  chunk_dim=cd),
                          mesh=mesh_, shard_specs={"w": shard},
                          full_specs={"w": (None, None)})
        return torch.autograd.grad((y ** 2).sum() / (B * D), ws)[0]

    want = grad("resident", x, w, None, None).numpy()
    out = {}
    for name, mode, cd in [(m, m, -1) for m in MODES] + \
            [("gpp chunk_dim 0", "gpp", 0)]:
        g = grad(mode, _shard(x, 0, rank, n), _shard(w, 1, rank, n), mesh,
                 ("data", None), cd)
        full = _gather_cat(g, 1, n).numpy()
        out[name] = {"ok": bool(np.allclose(full, want, rtol=1e-4,
                                            atol=1e-5)),
                     "err": float(np.abs(full - want).max())}
    return out


def _case_qwen(rank, n, mesh):
    import torch
    import torch.distributed as dist
    from repro_torch.core.streamer import StreamSettings
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.steps import stream_specs, value_and_grad
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_leaves, tree_map
    cfg = registry.get_config("qwen1.5-0.5b", smoke=True).with_(
        dtype="float32")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(2)
    B, S = 2 * n, 16
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                 .astype(np.int64))
             for k in ("tokens", "labels")}
    rloss, rgrads = value_and_grad(cfg, params, batch)

    # the stacked blocks rest as FSDP shards; the rest stays whole
    rules = shd.ShardRules()
    specs = shd.param_pspecs(tf.param_specs(cfg), mesh, rules)
    dims = tree_map(lambda p, s: None, params, specs)
    dims["blocks"] = tree_map(
        lambda p, s: next((d for d, e in enumerate(s) if e == "data"), None),
        params["blocks"], specs["blocks"])
    local = tree_map(lambda p, d: p if d is None else _shard(p, d, rank, n),
                     params, dims)
    sharded = [d is not None for d in tree_leaves(dims)]
    scfg = cfg.with_(stream=StreamSettings(mode="gpp", ring_depth=3))
    mine = {k: v[rank * 2:rank * 2 + 2] for k, v in batch.items()}
    live = tree_map(lambda p: p.detach().requires_grad_(), local)
    loss = tf.loss_fn(live, scfg, mine, mesh,
                      *stream_specs(scfg, mesh, rules))
    grads = torch.autograd.grad(loss / n, tree_leaves(live))
    total = loss.detach().clone()
    dist.all_reduce(total)
    got, want = [], tree_leaves(rgrads)
    for g, d, is_sharded in zip(grads, tree_leaves(dims), sharded):
        if is_sharded:
            got.append(_gather_cat(g, d, n))
        else:
            g = g.clone()
            dist.all_reduce(g)
            got.append(g)
    top = max(float(w.abs().max()) for w in want)
    worst = max(float((g - w).abs().max())
                / max(float(w.abs().max()), 1e-3 * top)
                for g, w in zip(got, want))
    return {"loss": float(total) / n, "resident_loss": float(rloss),
            "grad_err_over_scale": worst, "sharded_leaves": sum(sharded),
            "mesh": [list(mesh.mesh_dim_names), list(mesh.shape),
                     mesh.get_group("data").size()]}


CASES = {"toy": _case_toy, "grads": _case_grads, "qwen": _case_qwen}


def _rank(rank, world, out_path, cases):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(world, 1)
    out = {c: CASES[c](rank, world, mesh) for c in cases}
    if rank == 0:
        Path(out_path).write_text(json.dumps(out))


def _main(argv):
    from repro_torch.launch.mesh import spawn_ranks
    spawn_ranks(_rank, int(argv[0]), argv[1], argv[2].split(","))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _spawn(world: int, cases: str, tmp) -> dict:
    out = tmp / f"ranks{world}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, __file__, str(world), str(out), cases],
        capture_output=True, text=True, timeout=240, env=env,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _spawn(4, "toy,grads", tmp_path_factory.mktemp("ranks"))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _spawn(2, "qwen", tmp_path_factory.mktemp("ranks"))


@pytest.mark.parametrize("mode", MODES)
def test_modes_match_single_process_resident(four, mode):
    assert four["toy"]["err"][mode] <= 1e-5


def test_gather_counts(four):
    # the reference's assertion on its all-gathers, on the port's calls
    n = four["toy"]["gathers"]
    assert n["gpp"] > n["naive_pp"] >= n["insitu"] > 0, n
    # per leaf: L layers in situ, one more for naive_pp's first, and gpp's
    # prologue (G-1 = 2 layers) plus G-1 = 2 chunks a step
    assert (n["insitu"], n["naive_pp"], n["gpp"]) == (12, 14, 28)


@pytest.mark.parametrize("ring", (3, 4))
def test_chunk_dim_on_the_fsdp_dim(four, ring):
    assert four["toy"]["err"][f"gpp ring {ring} chunk_dim 0"] <= 1e-5


@pytest.mark.parametrize("case", MODES + ("gpp chunk_dim 0",))
def test_gradients_after_reduce_scatter(four, case):
    assert four["grads"][case]["ok"], four["grads"][case]


def test_qwen_loss_on_two_ranks(two):
    q = two["qwen"]
    assert q["mesh"] == [["data", "model"], [2, 1], 2]
    assert q["sharded_leaves"] > 0
    assert abs(q["loss"] - q["resident_loss"]) <= \
        1e-5 * abs(q["resident_loss"])


def test_qwen_gradients_on_two_ranks(two):
    assert two["qwen"]["grad_err_over_scale"] <= 1e-4


if __name__ == "__main__":
    _main(sys.argv[1:])
