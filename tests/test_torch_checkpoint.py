"""The port's checkpoint manager (`repro_torch.checkpoint.manager`), the
cases of `tests/test_checkpoint.py` but the elastic one (re-sharding onto
another mesh comes with distribution): the round trip with bf16 leaves,
an uncommitted step ignored, corruption detected, keep-last-k cleanup, the
async save, a shape mismatch refused.  And both directions of cross
restore with the reference's `CheckpointManager`: a checkpoint either
package writes restores in the other, every leaf bit-equal, with the same
leaf names, dtypes entries and file layout."""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch.checkpoint.manager import (COMMITTED, CheckpointManager,
                                            _flatten_with_names)

from _torch_parity import tree_to_torch

pytestmark = pytest.mark.tier1


def tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 4, generator=g),
                   "b": torch.ones(4),
                   "blocks": [torch.randn(3, 2, generator=g).bfloat16(),
                              {"scale": -torch.zeros(2).bfloat16()}]},
        "opt": {"mu": torch.zeros(8, 4),
                "count": torch.tensor(3, dtype=torch.int32),
                "lr": torch.tensor(-0.0, dtype=torch.bfloat16)},
    }


def _bits(t: torch.Tensor):
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()])


def assert_same_bits(got, want):
    got, want = _flatten_with_names(got), _flatten_with_names(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(_bits(g), _bits(w)), k


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        t = tree()
        mgr.save(10, t)
        restored, step = mgr.restore(tree(seed=1))
        assert step == 10
        assert_same_bits(restored, t)
        manifest = json.loads((tmp_path / "step_10" / "manifest.json")
                              .read_text())
        assert manifest["dtypes"]["['params']['blocks'][0]"] == "bfloat16"
        assert "['opt']['count']" in manifest["leaf_names"]

    def test_uncommitted_ignored(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, tree())
        mgr.save(2, tree(seed=2))
        # a crash mid-write of step 3: a directory without the marker
        os.makedirs(tmp_path / "step_3")
        assert mgr.latest_step() == 2
        with pytest.raises(FileNotFoundError, match="not committed"):
            mgr.restore(tree(), step=3)

    def test_corruption_detected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(5, tree())
        shard = tmp_path / "step_5" / "shard_0.npz"
        data = shard.read_bytes()
        shard.write_bytes(data[:-8] + b"deadbeef")
        with pytest.raises(IOError, match="corrupt"):
            mgr.restore(tree())

    def test_gc_keeps_last_k(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, tree())
        assert mgr.all_steps() == [3, 4]
        assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4"]

    def test_async_save(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        t = tree()
        mgr.save(7, t, blocking=False)
        # the snapshot is taken before save returns
        t["params"]["w"].add_(1.0)
        mgr.wait()
        assert mgr.latest_step() == 7
        restored, _ = mgr.restore(tree())
        assert_same_bits(restored["params"]["b"], t["params"]["b"])
        assert torch.equal(restored["params"]["w"] + 1.0, t["params"]["w"])

    def test_shape_mismatch_rejected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, tree())
        bad = tree()
        bad["params"]["w"] = torch.zeros(4, 4)
        with pytest.raises(ValueError, match="shape"):
            mgr.restore(bad)

    def test_no_checkpoint(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no committed"):
            CheckpointManager(str(tmp_path)).restore(tree())

    def test_restore_casts_to_the_example(self, tmp_path):
        # the example tree's dtype wins, as the reference's astype
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"w": torch.full((2,), 1.5)})
        out, _ = mgr.restore({"w": torch.zeros(2, dtype=torch.bfloat16)})
        assert out["w"].dtype == torch.bfloat16
        assert out["w"].tolist() == [1.5, 1.5]


def _jax_tree(seed=0):
    k = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(k)
    return {
        "params": {"w": jax.random.normal(k1, (8, 4)),
                   "b": jnp.ones((4,)),
                   "blocks": [jax.random.normal(k2, (3, 2)).astype(
                       jnp.bfloat16),
                       {"scale": -jnp.zeros((2,), jnp.bfloat16)}]},
        "opt": {"mu": jnp.zeros((8, 4)), "count": jnp.array(3, jnp.int32),
                "lr": jnp.array(-0.0, jnp.bfloat16)},
    }


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jt = _jax_tree()
    JManager(str(tmp_path)).save(4, jt)
    restored, step = CheckpointManager(str(tmp_path)).restore(tree(seed=5))
    assert step == 4
    assert_same_bits(restored, tree_to_torch(jt))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    t = tree()
    CheckpointManager(str(tmp_path)).save(6, t)
    jt, step = JManager(str(tmp_path)).restore(_jax_tree(seed=1))
    assert step == 6
    assert_same_bits(tree_to_torch(jax.tree.map(np.asarray, jt)), t)
    # the same manifest entries the reference writes for the same tree
    JManager(str(tmp_path / "ref")).save(6, jax.tree.map(
        np.asarray, jt))
    mine = json.loads((tmp_path / "step_6" / "manifest.json").read_text())
    ref = json.loads((tmp_path / "ref" / "step_6" / "manifest.json")
                     .read_text())
    for key in ("step", "host_id", "leaf_names", "dtypes"):
        assert mine[key] == ref[key], key
    assert (tmp_path / "step_6" / COMMITTED).exists()
