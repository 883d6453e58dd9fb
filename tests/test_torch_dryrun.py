"""The port's dry run (`repro_torch.launch.dryrun`) on fake process groups.

A fake group makes this process rank 0 of the mesh and becomes its default
group, so the cells run in processes of their own: this file runs itself
as a script (`python tests/test_torch_dryrun.py OUT`) that writes what it
counted to OUT as JSON, and the tests below read it.  The script runs:

  small  every `cells_for` shape of the ten SMOKE configs at a small
         `ShapeConfig` (SMALL) on a 2x2 ("data", "model") and a (2, 2, 1)
         ("pod", "data", "model") fake mesh: every cell ok, a rank's
         parameter bytes equal to the pieces that the reference's
         `param_pspecs` give each leaf under the reference's `_rules_for`
         (serving rules for prefill / decode, and the experts kept
         resident for decode as its `make_decode_step` does)
  fails  `dryrun.main` on one cell whose step builder raises: the record
         keeps the error and the exit code is 1

and `test_production_cell_cli` runs `python -m repro_torch.launch.dryrun`
on one production cell (qwen1.5-0.5b decode_32k on the 16x16 mesh).
"""
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = {"2x2": ((2, 2), ("data", "model")),
           "2x2x1": ((2, 2, 1), ("pod", "data", "model"))}
# (seq_len, global_batch) a shape: the batch divides both meshes' dp, and
# long_500k's single row puts the caches on their sequence dim
SMALL = {"train_4k": (16, 4), "prefill_32k": (16, 4), "decode_32k": (32, 4),
         "long_500k": (64, 1)}


# ---------------------------------------------------------------------------
# the script
# ---------------------------------------------------------------------------

def _small_cells() -> list:
    from repro_torch.configs.base import SHAPES, ShapeConfig, cells_for
    from repro_torch.launch import dryrun
    from repro_torch.models import registry
    out = []
    for arch in registry.ARCH_NAMES:
        cfg = registry.get_config(arch, smoke=True)
        for name in cells_for(cfg):
            seq, batch = SMALL[name]
            shape = ShapeConfig(name, seq, batch, SHAPES[name].kind)
            for mesh, layout in LAYOUTS.items():
                rec = dryrun.run_cell(arch, name, False, cfg=cfg, shape=shape,
                                      layout=layout, verbose=False)
                rec["layout"] = mesh
                out.append(rec)
    return out


def _failing_cell(tmp: Path) -> dict:
    from repro_torch.launch import dryrun

    def broken(*a, **kw):
        raise RuntimeError("a step that cannot be built")
    dryrun.make_step = broken
    out = tmp / "fails.json"
    rc = dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                      "--single-pod-only", "--out", str(out)])
    return {"rc": rc, "records": json.loads(out.read_text())}


def _main(argv):
    out = Path(argv[0])
    res = {"small": _small_cells(), "fails": _failing_cell(out.parent)}
    out.write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def counted(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "cells.json"
    proc = subprocess.run([sys.executable, __file__, str(out)],
                          capture_output=True, text=True, timeout=300,
                          env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def _cells():
    from repro_torch.configs.base import cells_for
    from repro_torch.models import registry
    return [(arch, name, mesh) for arch in registry.ARCH_NAMES
            for name in cells_for(registry.get_config(arch, smoke=True))
            for mesh in LAYOUTS]


def _record(counted, arch, name, mesh):
    (rec,) = [r for r in counted["small"] if (r["arch"], r["shape"],
                                              r["layout"]) == (arch, name,
                                                               mesh)]
    return rec


def _reference_param_bytes(arch, name, mesh) -> int:
    """A rank's bytes of the parameters under the reference's specs."""
    import jax
    from repro.configs.base import SHAPES as JSHAPES
    from repro.dist import sharding as jshd
    from repro.launch import steps as jsteps
    from repro.models import registry as jregistry
    from repro.models import transformer as jtf
    dims, names = LAYOUTS[mesh]
    sizes = dict(zip(names, dims))
    jmesh = types.SimpleNamespace(shape=sizes)
    jcfg = jregistry.get_config(arch, smoke=True)
    kind = JSHAPES[name].kind
    if kind == "decode" and jcfg.num_experts and \
            jcfg.num_experts % sizes["model"] == 0:
        jcfg = jcfg.with_(moe_serve_resident=True)
    rules = jsteps._rules_for(jcfg, jmesh, serve=kind != "train")
    specs = jtf.param_specs(jcfg)
    pspecs = jshd.param_pspecs(specs, jmesh, rules)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(specs),
                          jax.tree.leaves(pspecs, is_leaf=lambda x: isinstance(
                              x, jax.sharding.PartitionSpec))):
        n = math.prod(leaf.shape) * leaf.dtype.itemsize
        for entry in spec:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                n //= sizes.get(a, 1) if a else 1
        total += n
    return total


@pytest.mark.parametrize("arch,name,mesh", _cells())
def test_small_cell_counts(counted, arch, name, mesh):
    rec = _record(counted, arch, name, mesh)
    assert rec["ok"], rec.get("traceback")
    assert rec["mesh"] == mesh
    assert rec["flops_per_device"] > 0 and rec["dot_coverage"] == 1.0
    assert rec["param_bytes"] == _reference_param_bytes(arch, name, mesh)
    assert rec["argument_bytes"] > rec["param_bytes"]
    assert rec["bytes_per_device"] == rec["argument_bytes"] + \
        rec["output_bytes"]
    assert rec["temp_bytes"] >= 0 and rec["fits"]
    assert rec["hbm_bytes"] == rec["argument_bytes"] + rec["temp_bytes"] + \
        rec["output_bytes"] - rec["alias_bytes"]
    kinds = set(rec["collectives"])
    assert kinds <= {"all-gather", "reduce-scatter", "all-reduce",
                     "all-to-all"}, kinds
    if mesh == "2x2":                  # a model axis of 2 ranks
        assert {"all-gather", "all-reduce"} <= kinds, kinds
    assert rec["collective_bytes_per_device"] == sum(
        v["bytes"] for v in rec["collectives"].values())


def test_failed_cell_is_recorded(counted):
    f = counted["fails"]
    assert f["rc"] == 1
    (rec,) = f["records"]
    assert not rec["ok"]
    assert rec["error"] == "RuntimeError: a step that cannot be built"
    assert "a step that cannot be built" in rec["traceback"]


def test_production_cell_cli(tmp_path):
    out = tmp_path / "dryrun.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "decode_32k", "--single-pod-only",
         "--out", str(out)], capture_output=True, text=True, timeout=120,
        env=_env(), cwd=ROOT)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "1/1 cells counted" in proc.stdout
    (rec,) = json.loads(out.read_text())
    assert rec["ok"] and rec["mesh"] == "16x16" and rec["fits"]
    # the caches hold every kv head on every model rank, cut over dp: 8 of
    # the 128 rows a rank, 32,768 positions, 24 layers of K and V in bf16
    assert rec["argument_bytes"] > 24 * 2 * 8 * 32_768 * 16 * 64 * 2
    from repro_torch.launch import report
    rows = report.rows_from(str(out))
    assert report.markdown_table(rows).splitlines()[2].startswith(
        "| qwen1.5-0.5b | decode_32k | 16x16 | ")


if __name__ == "__main__":
    _main(sys.argv[1:])
