"""Sharding policy: parameter specs -> per-leaf dim specs (the port's copy
of `repro.dist.sharding`), and the cuts that stand for the reference's
`device_put(x, NamedSharding)`.

One rule object (`ShardRules`) decides where a tensor lives:

  tp_axis     tensor parallelism: the output-feature dim of column-parallel
              projections (q/k/v/up/gate, embeddings' vocab dim) and the
              contraction dim of the matching row-parallel ones (o-proj,
              down-proj); MoE expert stacks put the EXPERT dim here under
              `moe_ep_mode="tp"`.
  fsdp_axes   ZeRO-3: one more dim of every large tensor is sharded over
              the data axes and gathered a layer at a time, the "off-chip
              weight rewrite" that `core.streamer.stream_layers` schedules
              between the (sharded, gathered) spec pairs below.
  dp_axes     batch sharding for activations and caches.

A spec is a tuple with one entry a dim: None (whole), an axis name, or a
tuple of axis names; it stands for the reference's `PartitionSpec`.  A
mesh is anything `axis_sizes` reads: None (one device), a mapping of axis
name to size, or a `torch.distributed.device_mesh.DeviceMesh`.  Placement
is shape-driven (a dim must divide the axis size, else the leaf stays
whole on that dim), so the SMOKE configs on a small mesh and the full
widths go through the same code.

Each rank holds the local piece of every leaf that its spec names:
`shard_tree` cuts whole leaves into the calling rank's pieces (dim d of a
leaf split over the axes of its entry, the first axis outermost), and
`gather_tree` puts whole leaves back together (a collective: every rank
calls it).  `leaf_axes` names the axes a leaf is split over, which the
optimizer's global norm sums over.
"""
from __future__ import annotations

import dataclasses
from typing import Any

DimSpec = tuple       # one entry a dim: None, an axis name or a tuple of them


@dataclasses.dataclass(frozen=True)
class ShardRules:
    tp_axis: str = "model"
    fsdp_axes: "tuple[str, ...]" = ("data",)
    dp_axes: "tuple[str, ...]" = ("data",)
    fsdp: bool = True                  # ZeRO-3 shard params over fsdp_axes
    moe_ep_mode: str = "tp"            # experts over tp_axis ("tp") or dp
    moe_serve_resident: bool = False   # serving: experts resident, no FSDP


# row-parallel weights: TP goes on the leading (contraction) dim so the
# matmul reduces over the already-sharded axis (o-proj, down-proj)
_ROW_PARALLEL = ("w_o", "w_down", "w_out")
# 1-D / tiny leaves that always stay replicated
_REPLICATED = ("scale", "kv_norm", "q_norm", "k_norm", "b_q", "b_k", "b_v")


def axis_sizes(mesh) -> "dict[str, int]":
    """{axis name: size} of a mesh: None is one device (no axes), a
    mapping is taken as it is, a DeviceMesh gives its dim names."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axis_size(sizes: dict, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= sizes.get(a, 1)
    return n


def _axes_entry(axes: "tuple[str, ...]"):
    """Spec entry for a 1-or-many axis tuple."""
    return axes if len(axes) > 1 else axes[0]


def _leaf_name(path) -> str:
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


def _is_stacked(path) -> bool:
    """Leaves under the "blocks" group carry a leading superblock-stack
    dim (as `transformer.is_stacked_cache_path`)."""
    return "blocks" in path


def _leaf_pspec(shape, lead: int, name: str, mesh, rules: ShardRules,
                *, fsdp: "bool | None" = None) -> DimSpec:
    """Placement for one leaf: TP dim first, then one FSDP dim,
    shape-gated."""
    sizes = axis_sizes(mesh)
    fsdp = rules.fsdp if fsdp is None else fsdp
    dims: "list[Any]" = [None] * len(shape)
    rank = len(shape) - lead
    if rank <= 1 or name in _REPLICATED:
        return tuple(dims)
    tp = sizes.get(rules.tp_axis, 1)
    tp_dim = None
    if tp > 1:
        is_expert = rank == 3 and name in ("w_gate", "w_up", "w_down")
        if is_expert and rules.moe_ep_mode == "tp":
            cand = lead                       # expert dim over the model axis
        elif name in _ROW_PARALLEL or name == "embedding":
            cand = lead                       # contraction / vocab dim
        else:
            cand = len(shape) - 1             # column-parallel output dim
        for d in (cand, len(shape) - 1):
            if shape[d] % tp == 0:
                tp_dim = d
                dims[d] = rules.tp_axis
                break
    if fsdp and _axis_size(sizes, rules.fsdp_axes) > 1:
        fs = _axis_size(sizes, rules.fsdp_axes)
        for d in range(lead, len(shape)):
            if d != tp_dim and shape[d] % fs == 0:
                dims[d] = _axes_entry(rules.fsdp_axes)
                break
    return tuple(dims)


def _map_with_path(fn, tree, path=()):
    """fn(path, leaf) over nested dicts / lists of shaped leaves (a leaf
    is anything with a `.shape`); the path holds dict keys and list
    indices."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_pspecs(pspecs, mesh, rules: ShardRules):
    """Spec tree for the whole parameter tree (stacked "blocks" leaves keep
    their leading superblock dim whole: it is the layer loop's axis)."""
    return _map_with_path(
        lambda path, s: _leaf_pspec(s.shape, 1 if _is_stacked(path) else 0,
                                    _leaf_name(path), mesh, rules), pspecs)


def sharded_pspecs_one_layer(tree, mesh, rules: ShardRules):
    """Per-layer resting layout: TP + the ZeRO-3 FSDP shard, the form the
    streamer gathers FROM."""
    return _map_with_path(
        lambda path, s: _leaf_pspec(s.shape, 0, _leaf_name(path), mesh,
                                    rules), tree)


def gathered_pspecs(tree, mesh, rules: ShardRules):
    """Gathered (compute) layout: the FSDP dim whole again, TP kept, what
    one layer looks like while its GeMMs run."""
    return _map_with_path(
        lambda path, s: _leaf_pspec(s.shape, 0, _leaf_name(path), mesh,
                                    rules, fsdp=False), tree)


# ---------------------------------------------------------------------------
# cache placement
# ---------------------------------------------------------------------------

def cache_pspecs(tree, mesh, rules: ShardRules, batch: int):
    """KV-cache / recurrent-state placement: batch over the dp axes when it
    divides them; otherwise (long-context B < dp, e.g. long_500k at B=1)
    the SEQUENCE dim is sharded over dp instead, so a 500k-token cache
    never has to fit one device."""
    sizes = axis_sizes(mesh)
    dpn = _axis_size(sizes, rules.dp_axes)
    dp_entry = _axes_entry(rules.dp_axes)

    def f(path, s):
        if s is None:                     # a layer with no cache (cross)
            return None
        lead = 1 if _is_stacked(path) else 0
        dims: "list[Any]" = [None] * len(s.shape)
        if dpn > 1:
            if batch % dpn == 0:
                dims[lead] = dp_entry
            elif (len(s.shape) > lead + 1
                  and s.shape[lead + 1] % dpn == 0):
                dims[lead + 1] = dp_entry
        return tuple(dims)

    return _map_with_path(f, tree)


# ---------------------------------------------------------------------------
# the rank's pieces
# ---------------------------------------------------------------------------

def entry_axes(entry) -> "tuple[str, ...]":
    """The axes of one spec entry (None: none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def leaf_axes(spec) -> "tuple[str, ...]":
    """Every axis a leaf is split over, in dim order."""
    return tuple(a for e in (spec or ()) for a in entry_axes(e))


def drop_axes(specs, axes):
    """The spec tree with `axes` taken out of every entry (what a leaf looks
    like once it is gathered over them)."""
    axes = set(axes)

    def one(spec):
        out = []
        for e in spec:
            kept = tuple(a for a in entry_axes(e) if a not in axes)
            out.append(None if not kept else
                       kept[0] if len(kept) == 1 else kept)
        return tuple(out)
    return map_spec_tree(one, specs)


def map_spec_tree(fn, specs, *rest):
    """fn(spec, *leaves) over a spec tree (a spec is a tuple of entries;
    nested dicts / lists hold them), with trees of the same structure in
    `rest`.  None (a layer with no cache) stays None."""
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: map_spec_tree(fn, v, *(r[k] for r in rest))
                for k, v in specs.items()}
    if isinstance(specs, list):
        return [map_spec_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(specs)]
    return fn(specs, *rest)


def piece(t, spec, mesh):
    """This rank's piece of a whole tensor `t` under `spec`: along each dim,
    block r of its entry's axes (the first axis outermost).  A leaf split
    over no axis comes back as it is; a piece is a copy of its own."""
    sizes = axis_sizes(mesh)
    out = t
    for d, e in enumerate(spec or ()):
        for a in entry_axes(e):
            n = sizes.get(a, 1)
            if n == 1:
                continue
            if out.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(out.shape)} does not "
                                 f"divide over {a!r} ({n})")
            per = out.shape[d] // n
            out = out.narrow(d, mesh.get_local_rank(a) * per, per)
    return out if out is t else out.contiguous().clone()


def whole(t, spec, mesh):
    """The whole tensor from this rank's piece `t` under `spec` (all-gather
    over each split axis, innermost first); every rank of those axes must
    call it."""
    import torch
    # here, not at the top: dist.collectives imports this module
    from repro_torch.dist.collectives import all_gather
    sizes = axis_sizes(mesh)
    out = t
    for d, e in enumerate(spec or ()):
        for a in reversed(entry_axes(e)):
            n = sizes.get(a, 1)
            if n > 1:
                out = torch.cat(all_gather(out, mesh.get_group(a), n), dim=d)
    return out


def shard_tree(tree, specs, mesh):
    """The calling rank's pieces of a tree of whole tensors (the port's
    `device_put(tree, NamedSharding(mesh, specs))`)."""
    return map_spec_tree(lambda s, t: piece(t, s, mesh), specs, tree)


def gather_tree(tree, specs, mesh):
    """Whole leaves from the ranks' pieces (every rank calls it and gets
    them all)."""
    return map_spec_tree(lambda s, t: whole(t, s, mesh), specs, tree)
