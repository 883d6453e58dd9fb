"""`examples/torch_quickstart.py` against the JAX example `examples/
quickstart.py`, on the reference's own parameters.

The JAX example trains qwen1.5-0.5b SMOKE (bf16) for 10 steps on its 2x2
host mesh from `init_params(cfg, PRNGKey(0))`, then decodes 8 tokens
greedily.  Its cosine schedule warms up over 200 steps, so step 9 runs at
9/200 of the 3e-4 peak and its loss does not fall over the 10 steps: the
port is held to the reference's trajectory, not to descent.

This file runs itself as a script (`python tests/test_torch_examples_
quickstart.py PARAMS.npz OUT.json`) that imports the port only: it rebuilds
the reference's parameters from the .npz (`bridge.params_from_numpy`) and
runs the port's quickstart on 4 gloo ranks (the 2x2 mesh), then at world
size 1.  gloo ranks are forked, so they are never forked from this pytest
process, which has imported JAX.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
# bf16 SMOKE model: the losses are f32 means over 512 tokens of bf16
# products that round apart between XLA and the port's plain path, and the
# reference prints them to 4 decimals (5e-5); measured on the CPU: at most
# 9e-5 apart over the 10 steps, on the mesh and at world size 1
LOSS_ATOL = 2e-4
# the 2x2 run against world size 1: the tensor-parallel forms sum their
# pieces in another order, again in bf16 (measured: 4.2e-5)
MESH_ATOL = 1e-4


def _flat(tree, path=()):
    """{"a/0/b": array} over nested dicts / lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield "/".join(path), np.asarray(tree)


def _main(npz_path: str, out_path: str) -> None:
    """The port's side, in a process with no JAX."""
    import ml_dtypes
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "examples")]
    import torch_quickstart as qs
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import map_specs

    with np.load(npz_path) as data:
        arrays = {k: data[k] for k in data.files}

    def leaf(path, spec):
        name = "/".join(map(str, path))
        if f"{name}@bf16" in arrays:
            return arrays[f"{name}@bf16"].view(ml_dtypes.bfloat16)
        return arrays[name]
    cfg = registry.get_config("qwen1.5-0.5b", smoke=True)
    params = params_from_numpy(map_specs(leaf, tf.param_specs(cfg)))
    out = {"mesh": qs.run("cpu", 4, params),
           "world1": qs.run("cpu", 0, params)}
    Path(out_path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    from repro.models import registry
    from repro.models import transformer as rtf
    d = tmp_path_factory.mktemp("quickstart")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, "examples/quickstart.py"],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=env, cwd=ROOT)
    cfg = registry.get_config("qwen1.5-0.5b", smoke=True)
    params = rtf.init_params(cfg, jax.random.PRNGKey(0))
    flat = {}
    for k, a in _flat(jax.tree.map(np.asarray, params)):
        if a.dtype.name == "bfloat16":
            flat[f"{k}@bf16"] = a.view(np.uint16)
        else:
            flat[k] = a
    np.savez(d / "params.npz", **flat)
    port = subprocess.run(
        [sys.executable, __file__, str(d / "params.npz"), str(d / "out.json")],
        capture_output=True, text=True, timeout=240, env=env, cwd=d)
    out, err = ref.communicate(timeout=240)
    assert ref.returncode == 0, err[-3000:]
    assert port.returncode == 0, port.stderr[-3000:]
    losses = [float(v) for v in re.findall(r"^step \d+: loss (\S+)$", out,
                                           re.M)]
    toks = json.loads(re.search(r"^generated: (\[.*\])$", out,
                                re.M).group(1))
    got = json.loads((d / "out.json").read_text())
    return {"ref": {"losses": losses, "generated": toks}, **got,
            "port_stdout": port.stdout}


def test_reference_printed_ten_losses(runs):
    assert len(runs["ref"]["losses"]) == 10
    assert len(runs["ref"]["generated"]) == 9


@pytest.mark.parametrize("which", ("mesh", "world1"))
def test_losses_follow_the_reference(runs, which):
    """Each of the 10 losses within LOSS_ATOL of the JAX example's (which
    prints them to 4 decimals)."""
    got, want = runs[which]["losses"], runs["ref"]["losses"]
    assert len(got) == 10
    gaps = [abs(a - b) for a, b in zip(got, want)]
    assert max(gaps) <= LOSS_ATOL, list(zip(got, want))


@pytest.mark.parametrize("which", ("mesh", "world1"))
def test_greedy_tokens_equal_the_reference(runs, which):
    """The 9 greedy tokens equal the JAX example's; where they part, the
    port's logit lead at that position shows how close the tie was."""
    got, want = runs[which]["generated"], runs["ref"]["generated"]
    part = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                None)
    assert part is None, (
        f"parted at token {part}: port {got[part]} vs reference "
        f"{want[part]}, the port's lead over its runner-up "
        f"{runs[which]['gaps'][part]:.4g}")


def test_mesh_run_matches_world_size_1(runs):
    """The 2x2 run on 4 gloo ranks against the mesh-less run on the same
    parameters: the same tokens, losses within MESH_ATOL."""
    a, b = runs["mesh"], runs["world1"]
    assert a["generated"] == b["generated"]
    assert max(abs(x - y) for x, y in zip(a["losses"], b["losses"])) \
        <= MESH_ATOL


def test_mesh_run_printed_like_the_reference(runs):
    """Rank 0 prints the reference's lines: 10 step losses, then the
    tokens."""
    lines = runs["port_stdout"].splitlines()
    assert sum(bool(re.match(r"^step \d+: loss \d+\.\d{4}$", ln))
               for ln in lines) == 20               # two runs of 10
    assert sum(ln.startswith("generated: [") for ln in lines) == 2


if __name__ == "__main__":
    _main(*sys.argv[1:])
