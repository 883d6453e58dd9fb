"""The collectives that stand in for what the reference's GSPMD inserts.

The reference hands its jitted steps a spec tree and lets the partitioner
place the collectives.  Here each rank holds the local piece of every leaf
(`sharding.shard_tree`) and the model code writes the collectives out, on
the process groups of a `torch.distributed.device_mesh.DeviceMesh`'s axes
(gloo on CPU ranks, NCCL on the card).  Every one of them also runs on a
group of one rank, where it is the identity.

The ambient mesh: a step builder enters `on_mesh(mesh, rules)` around its
step, and the model's layers read it through `current()`, as the
reference's read `jax.sharding.get_abstract_mesh()`.  Outside it (None) the
layers run the mesh-less code.

Gradient convention.  An activation that is the same on every rank of an
axis (replicated) carries a gradient that is the same on every rank too; a
tensor that a rank computes from its own piece (its heads, its experts,
its rows) carries a partial gradient, which the ranks' sum makes whole.
The autograd pairs keep that:

  copy_to        forward identity, backward all-reduce (sum): a replicated
                 input entering a region each rank computes a part of
  reduce_from    forward all-reduce (sum), backward identity: the region's
                 partial outputs summed into a replicated one
  gather_from    forward all-gather along a dim, backward the rank's slice:
                 an activation piece made whole for replicated work after
                 it (the logits' vocab, context-parallel rows)
  gather_partial forward all-gather along a dim, backward the rank's slice
                 of the summed gradient (reduce-scatter): a weight piece
                 made whole for work that each rank does a part of (ZeRO-3
                 of a resident layer, the MoE shard maps' expert weights,
                 a projection stored on one dim and computed on another)

Each pair takes one axis or a spec entry of several (the kimi-scale
("pod", "data") dp and FSDP entry): a reduce runs over each of its axes,
and a gather over each in turn, innermost first, so that the pieces come
back in the order `sharding.piece` cuts them.

`take` moves a local piece from the layout one spec names to the one
another names, with these.  If a pair were wrong, gradients would come out
a whole number of times too large or too small on a mesh; the multi-rank
tests hold every gradient against the mesh-less one to catch that.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.dist.sharding import ShardRules, axis_sizes, entry_axes


class Par:
    """What the layers read of the ambient mesh: axis sizes, this rank's
    coordinate on each axis and the axis's process group, the sharding
    rules, and whether the batch is split over the dp axes.  `size` and
    `rank` also take a spec entry of several axes: their product, and the
    rank's block index over them (the first axis outermost, as
    `sharding.piece` cuts)."""

    def __init__(self, mesh, rules: "ShardRules | None" = None,
                 batch_split: bool = True):
        self.mesh = mesh
        self.rules = rules or ShardRules(
            dp_axes=tuple(a for a in ("pod", "data")
                          if a in axis_sizes(mesh)) or ("data",))
        self.sizes = axis_sizes(mesh)
        self.batch_split = batch_split

    def size(self, axis) -> int:
        n = 1
        for a in entry_axes(axis):
            n *= self.sizes.get(a, 1)
        return n

    def rank(self, axis) -> int:
        r = 0
        for a in entry_axes(axis):
            r = r * self.sizes.get(a, 1) + (
                self.mesh.get_local_rank(a) if a in self.sizes else 0)
        return r

    def group(self, axis: str):
        if axis not in self.sizes:
            raise ValueError(f"the mesh has no axis {axis!r}")
        return self.mesh.get_group(axis)

    @property
    def tp(self) -> int:
        return self.size("model")

    @property
    def dp_axis(self):
        """The dp axes as one spec entry: "data", or ("pod", "data") on a
        multi-pod mesh (the collectives below take either)."""
        axes = tuple(a for a in self.rules.dp_axes if a in self.sizes)
        if not axes:
            return "data"
        return axes if len(axes) > 1 else axes[0]

    @property
    def dp(self) -> int:
        return self.size(self.dp_axis)


_CURRENT: "list[Par | None]" = [None]


@contextlib.contextmanager
def on_mesh(mesh, rules: "ShardRules | None" = None, *,
            batch_split: bool = True):
    """Make `mesh` (a DeviceMesh) the ambient mesh inside the block; None
    leaves the block mesh-less."""
    prev = _CURRENT[0]
    _CURRENT[0] = None if mesh is None else Par(mesh, rules, batch_split)
    try:
        yield _CURRENT[0]
    finally:
        _CURRENT[0] = prev


def current() -> "Par | None":
    return _CURRENT[0]


def tp_par() -> "Par | None":
    """The ambient mesh when its model axis is larger than one rank."""
    par = _CURRENT[0]
    return par if par is not None and par.tp > 1 else None


# ---------------------------------------------------------------------------
# raw collectives (no autograd): the one all-gather / reduce-scatter pair
# of the port (the layer streamer's fetches and `sharding.whole` too)
# ---------------------------------------------------------------------------

def all_gather(x: torch.Tensor, group, n: int) -> "list[torch.Tensor]":
    """Every rank's `x` over `group` (n ranks), in rank order."""
    import torch.distributed as dist
    x = x.contiguous()
    parts = list(torch.empty((n, *x.shape), dtype=x.dtype,
                             device=x.device).unbind(0))
    # the list forms: torch 2.13 deprecates the *_into_tensor /
    # reduce_scatter_tensor calls, and 2.11 has no *_single ones
    dist.all_gather(parts, x, group=group)
    return parts


def reduce_scatter(g: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """This rank's block along `dim` of the sum of `g` over `group` (n
    ranks)."""
    import torch.distributed as dist
    parts = [p.contiguous() for p in g.chunk(n, dim=dim)]
    out = torch.empty_like(parts[0])
    dist.reduce_scatter(out, parts, group=group)
    return out


def _slice(x: torch.Tensor, dim: int, r: int, n: int) -> torch.Tensor:
    per = x.shape[dim] // n
    return x.narrow(dim, r * per, per)


def all_reduce(t: torch.Tensor, par: Par, axes, op: str = "sum"):
    """A copy of `t` reduced over each axis in `axes` (a tuple of axes or
    a spec entry; sum or max)."""
    import torch.distributed as dist
    # NCCL takes contiguous tensors only (a gradient may be a strided view)
    out = t.clone(memory_format=torch.contiguous_format)
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    for a in entry_axes(axes):
        dist.all_reduce(out, op=red, group=par.group(a))
    return out


# ---------------------------------------------------------------------------
# the autograd pairs
# ---------------------------------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axis):
        ctx.par, ctx.axis = par, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.par, ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par, axis):
        return all_reduce(x, par, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, par, axis, partial):
        ctx.dim, ctx.par, ctx.axis, ctx.partial = dim, par, axis, partial
        return torch.cat(all_gather(x, par.group(axis), par.size(axis)),
                         dim=dim)

    @staticmethod
    def backward(ctx, g):
        par, axis = ctx.par, ctx.axis
        if ctx.partial:
            out = reduce_scatter(g, ctx.dim, par.group(axis),
                                 par.size(axis))
        else:
            out = _slice(g, ctx.dim, par.rank(axis),
                         par.size(axis)).contiguous()
        return out, None, None, None, None


def copy_to(x, par: Par, axis="model"):
    return _Copy.apply(x, par, axis)


def reduce_from(x, par: Par, axis="model"):
    return _Reduce.apply(x, par, axis)


def _gathers(x, dim: int, par: Par, axis, partial: bool):
    # over a spec entry of several axes, innermost first: the pieces come
    # back in the order `sharding.piece` cuts them (the first axis
    # outermost), and each backward takes its axis's block in turn
    for a in reversed(entry_axes(axis)):
        if par.size(a) > 1:
            x = _Gather.apply(x, dim % x.ndim, par, a, partial)
    return x


def gather_from(x, dim: int, par: Par, axis="model"):
    return _gathers(x, dim, par, axis, False)


def gather_partial(x, dim: int, par: Par, axis="model"):
    return _gathers(x, dim, par, axis, True)


def local_block(x, dim: int, par: Par, axis="model"):
    """The rank's block of `x` along `dim` over `axis` (an entry)."""
    return _slice(x, dim, par.rank(axis), par.size(axis))


def take(w, have, want, par: Par, *, partial: bool = True):
    """This rank's piece of `w` in layout `want`, from its piece in layout
    `have` (specs: one entry a dim).  A dim split over an axis that `want`
    keeps whole is gathered (`gather_partial` when the work after it is a
    rank's part; over "model", `gather_from` when `partial` is False and
    the model ranks' work after it is replicated); a dim that `want`
    splits and `have` does not is cut to the rank's block, after a
    `copy_to` unless a `gather_partial` over that axis already sums the
    ranks' partial gradients of the whole.  With `partial`, a leaf whole
    on every model rank in both layouts also goes through a `copy_to`, as
    each rank's work on it is a part."""
    ndim = w.ndim
    have = tuple(have or (None,) * ndim)
    want = tuple(want or (None,) * ndim)
    summed = set()               # axes whose gather sums the gradient
    for d in range(ndim):
        keep = entry_axes(want[d])
        for a in reversed(entry_axes(have[d])):
            if a not in keep and par.size(a) > 1:
                # the dp ranks' work is always a part (their own rows)
                if partial or a != "model":
                    w = gather_partial(w, d, par, a)
                    summed.add(a)
                else:
                    w = gather_from(w, d, par, a)
    for d in range(ndim):
        had = entry_axes(have[d])
        for a in entry_axes(want[d]):
            if a not in had and par.size(a) > 1:
                if a not in summed:
                    w = copy_to(w, par, a)
                w = _slice(w, d, par.rank(a), par.size(a))
    if partial and par.tp > 1 and not any(
            "model" in entry_axes(e) for e in have + want):
        # whole on every model rank, used by a rank's part of the work
        w = copy_to(w, par)
    return w


class LocalLayer:
    """One rank's view of a recurrent layer under the model axis: its
    leaves and config, the entry and exit of its region (a copy and a
    reduce in a heads form, else nothing), and the cut / join of a state
    that rests whole on every model rank (`dims`: each state leaf's heads
    dim)."""

    def __init__(self, p, c, par=None, heads: bool = False,
                 dims: "dict | None" = None):
        self.p, self.c, self.par, self.heads = p, c, par, heads
        self.dims = dims or {}

    def enter(self, x):
        return copy_to(x, self.par) if self.heads else x

    def leave(self, y):
        return reduce_from(y, self.par) if self.heads else y

    def cut(self, state):
        """The rank's heads of a state whole on the model axis."""
        if not self.heads:
            return state
        return {n: local_block(t, self.dims[n], self.par)
                for n, t in state.items()}

    def join(self, state):
        """A state of the rank's heads, gathered whole over "model"."""
        if not self.heads:
            return state
        return {n: gather_from(t, self.dims[n], self.par)
                for n, t in state.items()}


def whole_layer(p, spec, par) -> dict:
    """Every leaf made whole on every model rank, for work each model rank
    does whole (the whole form)."""
    return {n: take(t, spec[n], None, par, partial=False)
            for n, t in p.items()}


def spec_dim(spec, axis: str = "model") -> "int | None":
    """The dim of a leaf that `spec` splits over `axis` (None: none)."""
    for d, e in enumerate(spec or ()):
        if axis in entry_axes(e):
            return d
    return None
