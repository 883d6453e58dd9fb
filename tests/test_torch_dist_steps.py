"""The sharded step builders (`launch.steps`) on a 2x2 mesh of 4 ranks,
mirroring `tests/test_distributed.py::TestStepsOnHostMesh`.

More than one rank runs on gloo only, as CPU processes: this file runs
itself as a script (`python tests/test_torch_dist_steps.py OUT`) that
starts 4 ranks once (`launch.mesh.spawn_ranks`); each builds a 2x2
("data", "model") mesh, cuts whole SMOKE parameters (f32, the same seed on
every rank) and batches to its pieces with `dist.sharding.shard_tree`, runs
the cases, and rank 0 writes what they measured to OUT.  The references
are the port's mesh-less steps (held to the JAX package's by
`test_torch_train*.py` and `test_torch_dense_steps.py`), run on rank 0:

  gemma3   `make_train_step` (S 64, B 8; tensor-parallel heads / MLP /
           vocab, ZeRO-3 over "data") at step 200, past the warm-up, so
           that AdamW's +-3e-4 update shows: the loss and the grad norm
           within 1e-4 of the mesh-less step's, and every gradient leaf
           of the step (`meta["loss_and_grads"]`) and every updated
           parameter, put back together by `gather_tree`, within 1e-4 of
           its own scale
  danube   `make_prefill_step` / `make_decode_step` at B = 1 < dp, so the
           cache is split on its sequence dim (`cache_pspecs`): a 48-token
           prompt, then 8 greedy decode steps, whose tokens equal the
           mesh-less `prefill` / `decode_step`'s, logits within 1e-4 of a
           row's largest |logit|
  qwen2    `make_train_step` with `StreamSettings(mode="gpp",
           ring_depth=3)`: the loss and the parameters equal the resident
           step's on the same mesh within 1e-5
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


def _scaled_err(got, want) -> float:
    """max |got - want| over max(|want|, 1e-3 x the tree's largest)."""
    import torch
    from repro_torch.models.layers import tree_leaves
    g, w = tree_leaves(got), tree_leaves(want)
    top = max(float(x.abs().max()) for x in w)
    return max(float((a - b).abs().max())
               / max(float(b.abs().max()), 1e-3 * top) for a, b in zip(g, w)
               if isinstance(b, torch.Tensor) and b.numel())


# past the warm-up: the learning rate at its 3e-4 peak, so that AdamW's
# first update (about +-lr a weight) is larger than the bounds below
TRAIN_STEP = 200


def _train(cfg, mesh, B, S, seed, with_mesh: bool, grads: bool = False):
    """(params, opt state, metrics) after one train step from seeded whole
    parameters, put back together on a mesh; with `grads`, also the
    step's gradients (`meta["loss_and_grads"]` on the mesh, put back
    together; `value_and_grad` without one)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    params = tf.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    rng = np.random.default_rng(seed)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
             for k in ("tokens", "labels")}
    if not with_mesh:
        b = make_train_step(cfg)
        out = b.fn(params, adamw.adamw_init(params), batch, TRAIN_STEP)
        return out + ((value_and_grad(cfg, params, batch)[1],)
                      if grads else ())
    b = make_train_step(cfg, mesh, ShapeConfig("t", S, B, "train"))
    p_psp, _, b_psp, _ = b.arg_specs
    mine = shd.shard_tree(params, p_psp, mesh)
    rows = shd.shard_tree(batch, b_psp, mesh)
    g = (shd.gather_tree(b.meta["loss_and_grads"](mine, rows)[1], p_psp,
                         mesh),) if grads else ()
    p, o, m = b.fn(mine, adamw.adamw_init(mine), rows, TRAIN_STEP)
    return (shd.gather_tree(p, p_psp, mesh), o, m) + g


def _case_gemma3(rank, mesh):
    from repro_torch.models import registry
    cfg = registry.get_config("gemma3-12b", smoke=True).with_(
        dtype="float32")
    p, _, m, g = _train(cfg, mesh, 8, 64, 0, True, grads=True)
    if rank:
        return None
    wp, _, wm, wg = _train(cfg, mesh, 8, 64, 0, False, grads=True)
    return {"loss": float(m["loss"]), "want_loss": float(wm["loss"]),
            "gnorm": float(m["grad_norm"]),
            "want_gnorm": float(wm["grad_norm"]),
            "lr": float(m["lr"]),
            "grads_err": _scaled_err(g, wg),
            "params_err": _scaled_err(p, wp)}


def _case_qwen2(rank, mesh):
    from repro_torch.core.streamer import StreamSettings
    from repro_torch.models import registry
    cfg = registry.get_config("qwen2-7b", smoke=True).with_(dtype="float32")
    rp, _, rm = _train(cfg, mesh, 8, 64, 1, True)
    gcfg = cfg.with_(stream=StreamSettings(mode="gpp", ring_depth=3))
    gp, _, gm = _train(gcfg, mesh, 8, 64, 1, True)
    return None if rank else {
        "loss": float(gm["loss"]), "want_loss": float(rm["loss"]),
        "params_err": _scaled_err(gp, rp)}


def _case_danube(rank, mesh):
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    cfg = registry.get_config("h2o-danube-1.8b", smoke=True).with_(
        dtype="float32")
    T, P, N = 64, 48, 8
    params = tf.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, P)))
    pre = make_prefill_step(cfg, mesh, ShapeConfig("long", T, 1, "prefill"))
    dec = make_decode_step(cfg, mesh, ShapeConfig("long", T, 1, "decode"))
    mine = shd.shard_tree(params, dec.arg_specs[0], mesh)
    logits, caches = pre.fn(shd.shard_tree(params, pre.arg_specs[0], mesh),
                            {"tokens": prompt})
    cache_psp = dec.meta["cache_pspecs"]
    k0 = caches["blocks"]["b0"]["k"]
    out = {"seq_sharded": cache_psp["blocks"]["b0"]["k"],
           "local_cache": list(k0.shape)}
    got_tok, got_logits = [], [logits]
    tok = logits[:, -1].argmax(-1)[:, None]
    for i in range(N):
        got_tok.append(int(tok[0, 0]))
        logits, caches = dec.fn(mine, tok, caches, P + i)
        got_logits.append(logits)
        tok = logits[:, -1].argmax(-1)[:, None]
    if rank:
        return None
    with torch.no_grad():
        wl, wc = tf.prefill(params, cfg, {"tokens": prompt}, T)
        want_tok, want_logits = [], [wl]
        tok = wl[:, -1].argmax(-1)[:, None]
        for i in range(N):
            want_tok.append(int(tok[0, 0]))
            wl, wc = tf.decode_step(params, cfg, tok, wc, P + i)
            want_logits.append(wl)
            tok = wl[:, -1].argmax(-1)[:, None]
    err = max(float((g - w).abs().max() / w.abs().max())
              for g, w in zip(got_logits, want_logits))
    return out | {"tokens": got_tok, "want_tokens": want_tok,
                  "logits_err": err}


CASES = {"gemma3": _case_gemma3, "danube": _case_danube,
         "qwen2": _case_qwen2}


def _rank(rank, world, out_path):
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(2, 2)
    out = {name: fn(rank, mesh) for name, fn in CASES.items()}
    if rank == 0:
        Path(out_path).write_text(json.dumps(out))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks") / "steps.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, str(out)],
                          capture_output=True, text=True, timeout=240,
                          env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_gemma3_train_step_on_2x2(ranks):
    g = ranks["gemma3"]
    assert abs(g["loss"] - g["want_loss"]) <= 1e-4 * abs(g["want_loss"])
    assert abs(g["gnorm"] - g["want_gnorm"]) <= 1e-4 * abs(g["want_gnorm"])
    assert abs(g["lr"] - 3e-4) <= 1e-9
    assert g["grads_err"] <= 1e-4
    assert g["params_err"] <= 1e-4


def test_danube_decode_on_a_sequence_sharded_cache(ranks):
    d = ranks["danube"]
    assert d["seq_sharded"] == [None, None, "data", None, None]
    assert d["local_cache"][2] == 8          # 16 ring slots over 2 ranks
    assert d["tokens"] == d["want_tokens"]
    assert d["logits_err"] <= 1e-4


def test_qwen2_gpp_streamed_train_step_on_2x2(ranks):
    q = ranks["qwen2"]
    assert abs(q["loss"] - q["want_loss"]) <= 1e-5 * abs(q["want_loss"])
    assert q["params_err"] <= 1e-5


if __name__ == "__main__":
    from repro_torch.launch.mesh import spawn_ranks
    spawn_ranks(_rank, 4, sys.argv[1])
