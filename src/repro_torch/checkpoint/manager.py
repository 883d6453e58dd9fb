"""Fault-tolerant checkpointing (the port's copy of
`repro.checkpoint.manager`): atomic step directories, a manifest, and
step-granular resume.

Layout:  <dir>/step_<n>/
            manifest.json          {step, leaf names, dtypes, hashes}
            shard_<host>.npz       the host's leaves, one array a leaf
            _COMMITTED             written last: a step directory without
                                   it is what a crash mid-write left, and
                                   restore ignores it

The format is the reference's, leaf for leaf: a leaf is named as
`jax.tree_util.keystr` names it (`['params']['blocks']['b0']['w']`,
`['opt']['count']`, `[0]` for a list element), and a bf16 (or float8) leaf
is stored as its raw 16- (8-) bit pattern with its dtype's name in the
manifest's `dtypes`.  So a checkpoint written by either package restores
in the other, bit for bit.  The bits come from the tensor itself
(`view(torch.int16)`): no ml_dtypes.

`save(..., blocking=False)` snapshots the tree to host memory and writes
it in a background thread; `wait()` joins it.

On a mesh each rank holds pieces of the leaves (`dist.sharding`):
`save(..., specs=, mesh=)` gathers whole leaves (every rank calls it) and
rank 0 writes them in the same format, so a checkpoint does not depend on
the mesh that wrote it; `restore(..., shardings=specs, mesh=)` reads whole
leaves and cuts this rank's pieces, onto any mesh (the reference's elastic
resume).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

COMMITTED = "_COMMITTED"

# dtypes npz cannot hold: stored as raw unsigned bits (the manifest keeps
# the dtype's name), read back through a signed view torch can wrap
_RAW_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.uint8),
}
_SIGNED = {np.dtype(np.uint16): np.int16, np.dtype(np.uint8): np.uint8}


def _key(k) -> str:
    """One path entry as `jax.tree_util.keystr` spells it."""
    return f"[{k!r}]"


def _flatten_with_names(tree, prefix: str = "") -> dict:
    """{keystr name: leaf} in the reference's order (dict keys sorted, as
    JAX flattens a dict); None leaves are empty subtrees, as in JAX."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_names(tree[k], prefix + _key(k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten_with_names(v, prefix + _key(i)))
        return out
    if tree is None:
        return {}
    return {prefix: tree}


def _treedef(tree) -> str:
    """The tree's structure, leaves as `*` (informational, as the
    reference's `treedef` entry)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "None" if tree is None else "*"


def _to_host(leaf) -> "tuple[np.ndarray, str]":
    """A tensor as a numpy array of its own memory, and the name of its
    dtype; bf16 / float8 as their raw unsigned bits."""
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    name = str(t.dtype).removeprefix("torch.")
    if name in _RAW_DTYPES:
        _, raw, view = _RAW_DTYPES[name]
        return t.view(view).numpy().view(raw), name
    return t.numpy(), name


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array back as a tensor of its own memory (np.array
    copies in C order and keeps a 0-d array 0-d)."""
    if dtype_name in _RAW_DTYPES:
        bits = np.array(arr).view(_SIGNED[arr.dtype])
        return torch.from_numpy(bits).view(_RAW_DTYPES[dtype_name][0])
    return torch.from_numpy(np.array(arr))


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, host_id: int = 0, keep: int = 3):
        self.dir = directory
        self.host_id = host_id
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: "threading.Thread | None" = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree, *, blocking: bool = True, specs=None,
             mesh=None) -> str:
        """Write a checkpoint for `step`.  Atomic: the commit marker goes
        last.  The tree is copied to host memory before this returns.
        With `specs` the leaves are the rank's pieces on `mesh`: every rank
        calls this, the whole leaves are gathered, and rank 0 writes."""
        if specs is not None:
            import torch.distributed as dist
            from repro_torch.dist.sharding import gather_tree
            tree = gather_tree(tree, specs, mesh)
            if dist.get_rank() != 0:
                return os.path.join(self.dir, f"step_{step}")
        named = {k: _to_host(v) for k, v in _flatten_with_names(tree).items()}
        structure = _treedef(tree)
        if blocking:
            return self._write(step, named, structure)
        self.wait()
        self._thread = threading.Thread(
            target=self._write, args=(step, named, structure), daemon=True)
        self._thread.start()
        return os.path.join(self.dir, f"step_{step}")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, named: dict, structure: str) -> str:
        final = os.path.join(self.dir, f"step_{step}")
        tmp = tempfile.mkdtemp(prefix=f".step_{step}_", dir=self.dir)
        try:
            shard_path = os.path.join(tmp, f"shard_{self.host_id}.npz")
            np.savez(shard_path, **{k: a for k, (a, _) in named.items()})
            manifest = {
                "step": step,
                "host_id": self.host_id,
                "leaf_names": sorted(named),
                "dtypes": {k: name for k, (_, name) in named.items()},
                "shard_sha256": {str(self.host_id): _sha256(shard_path)},
                "treedef": structure,
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f, indent=1)
            with open(os.path.join(tmp, COMMITTED), "w") as f:
                f.write("ok")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> "list[int]":
        return sorted(
            int(d.split("_")[1]) for d in os.listdir(self.dir)
            if d.startswith("step_")
            and os.path.exists(os.path.join(self.dir, d, COMMITTED)))

    def latest_step(self) -> "int | None":
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, example_tree, step: "int | None" = None, *,
                shardings=None, mesh=None):
        """Restore into the structure of `example_tree` (nested dicts /
        lists of tensors): each leaf shape-checked against the example's,
        then cast to its dtype and moved to its device.  With `shardings`
        (a spec tree of the example's structure) the example holds this
        rank's pieces on `mesh`: each stored whole leaf is checked against
        the piece's shape times its axes and cut to the rank's piece.
        Returns (tree, step)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        if not os.path.exists(os.path.join(path, COMMITTED)):
            raise FileNotFoundError(f"checkpoint {path} not committed")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        shard_file = os.path.join(path, f"shard_{self.host_id}.npz")
        if manifest["shard_sha256"][str(self.host_id)] != _sha256(shard_file):
            raise IOError(f"checkpoint {path} corrupt (hash mismatch)")
        dtypes = manifest.get("dtypes", {})
        specs = {} if shardings is None else _flatten_with_names(
            _spec_leaves(shardings))
        with np.load(shard_file) as data:
            def leaf(name, ex):
                t = _from_host(data[name], dtypes.get(name, ""))
                spec = specs.get(name)
                want = _whole_shape(ex.shape, spec, mesh)
                if tuple(t.shape) != want:
                    raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                                     f"{want}")
                if spec is not None:
                    from repro_torch.dist.sharding import piece
                    t = piece(t, spec.spec, mesh)
                return t.to(device=ex.device, dtype=ex.dtype)
            return _map_named(leaf, example_tree), step


class _SpecLeaf:
    """A spec held as one leaf (a spec is a tuple, which the tree walkers
    read as a sequence)."""

    def __init__(self, spec):
        self.spec = spec


def _spec_leaves(specs):
    from repro_torch.dist.sharding import map_spec_tree
    return map_spec_tree(_SpecLeaf, specs)


def _whole_shape(shape, spec: "_SpecLeaf | None", mesh) -> tuple:
    """A piece's shape times the sizes of the axes its dims are split
    over."""
    if spec is None:
        return tuple(shape)
    from repro_torch.dist.sharding import axis_sizes, entry_axes
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, e in enumerate(spec.spec):
        for a in entry_axes(e):
            out[d] *= sizes.get(a, 1)
    return tuple(out)


def _map_named(fn, tree, prefix: str = ""):
    """fn(keystr name, leaf) over the leaves of `tree`, keeping its
    structure (None stays None)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, prefix + _key(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_named(fn, v, prefix + _key(i))
                for i, v in enumerate(tree)]
    return None if tree is None else fn(prefix, tree)
