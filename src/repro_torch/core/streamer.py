"""Generalized ping-pong at layer scale: streamed layer execution (the
port's copy of `repro.core.streamer`).

Layer weights rest somewhere other than where they are computed on, and
each layer must be brought whole to the compute device ("rewritten")
before its GeMMs run ("compute").  The four modes are the paper's
strategies:

  resident   the weights already sit whole on the compute device: no
             streaming
  insitu     fetch layer i, then compute layer i: the fetch is on the
             critical path every step
  naive_pp   double buffer: fetch layer i+1 (whole) while layer i runs
  gpp        a ring of G buffers; each step fetches 1/(G-1) of each of
             the next G-1 layers, so the bytes a step are flat at exactly
             one layer and compute never waits even when a layer's fetch
             outlasts its compute

The ring schedule is the reference's: layer j's bytes arrive during steps
j-(G-1) ... j-1; at step i chunk (G-1-k) of layer min(i+k, L-1) goes into
slot (i+k) % G, for k = 1..G-1, after a prologue that fills slots 0..G-2
with layers 0..G-2 whole.

Where the leaves rest decides what a fetch is (no flag does).  A leaf
may also be split over the model axis (tensor parallelism): that dim stays
the rank's piece, and only the FSDP dim is gathered.


  identity       the leaves are whole on the compute device (world size
                 1; the reference's `mesh=None`): insitu and naive_pp hand
                 the layer over as it is, gpp still copies it through its
                 ring
  FSDP shards    `shard_specs` names the mesh's `fsdp_axis` on a dim that
                 `full_specs` keeps whole: the layer's shards are gathered
                 over the process group of each axis of that dim's entry
                 ("data", or the kimi-scale ("pod", "data"), innermost
                 first: `torch.distributed.all_gather`), and the gradient
                 goes back by a reduce-scatter (sum) over each, ZeRO-3 as
                 in the reference
  host memory    the stacked leaves rest on the CPU (pinned) and the carry
                 is on a CUDA device: a host-to-device copy on a side CUDA
                 stream; the gradient comes back to the host

On a CUDA device the fetches run on a side stream.  Each step's fetches
wait for every compute issued before that step (so a slot is rewritten
only after the layer that held it ran, and a fresh buffer's memory is no
longer read), and layer i's compute waits on the event recorded after the
step that issued its last chunk.  A stream-order or copy fault raises; a
streamed pass never moves to the CPU.

Under autograd (a leaf or the carry asks for a gradient), every layer gets
buffers of its own, which no later step writes: the layer's saved tensors
(and, with block remat, the checkpointed function's inputs) keep them, so
a training step holds all L layers on the compute device, as the
reference keeps every step's gathered weights as residuals.  Without
autograd the gpp ring is G buffers reused in place.

Ring depth comes from `core.schedule.plan_stream` (`plan_for_layer`).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.core.schedule import StreamPlan, plan_stream
from repro_torch.dist.collectives import all_gather, reduce_scatter
from repro_torch.dist.sharding import axis_sizes

MODES = ("resident", "insitu", "naive_pp", "gpp")
TP_AXIS = "model"    # a leaf's tensor-parallel dim: it stays local


@dataclasses.dataclass(frozen=True)
class StreamSettings:
    """Per-model streaming configuration (part of the arch config)."""

    mode: str = "resident"
    ring_depth: int = 4          # G: buffers held (gpp); >= 2
    chunk_dim: int = -1          # which dim of each leaf to fetch in chunks
    fsdp_axis: str = "data"      # mesh axis the weights are sharded over

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.ring_depth < 2:
            raise ValueError("ring_depth must be >= 2")


def _chunk_bounds(dim_size: int, chunks: int, c: int) -> "tuple[int, int]":
    """[lo, hi) of chunk c (the last chunk absorbs the remainder)."""
    base = dim_size // chunks
    lo = c * base
    hi = dim_size if c == chunks - 1 else lo + base
    return lo, hi


def _take_chunk(leaf: torch.Tensor, chunk_dim: int, chunks: int,
                c: int) -> torch.Tensor:
    """Chunk c of `leaf` along `chunk_dim`: a view."""
    d = chunk_dim % leaf.ndim
    lo, hi = _chunk_bounds(leaf.shape[d], chunks, c)
    return leaf.narrow(d, lo, hi - lo)


def _put_chunk(buf: torch.Tensor, chunk: torch.Tensor, chunk_dim: int,
               chunks: int, c: int) -> torch.Tensor:
    """Write `chunk` as chunk c of `buf` along `chunk_dim`, in place (the
    reference returns a new array); returns buf."""
    _take_chunk(buf, chunk_dim, chunks, c).copy_(chunk)
    return buf


# ---------------------------------------------------------------------------
# trees (nested dicts / lists / tuples; the structure comes from the first)
# ---------------------------------------------------------------------------

def _flatten(tree, path=()):
    """[(path, leaf)] in a fixed order."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flatten(v, path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _flatten(v, path + (i,))]
    return [(path, tree)]


def _unflatten(like, leaves):
    """`like`'s structure over an iterator of leaves."""
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _at(tree, path):
    """The entry of a spec tree at `path` (None when the tree stops)."""
    for k in path:
        if tree is None:
            return None
        tree = tree[k]
    return tree


def _layer(ws, i: int):
    """Layer i of leading-L stacked leaves: views."""
    return _unflatten(ws, iter(w[i] for _, w in _flatten(ws)))


def _device_of(carry) -> torch.device:
    for _, x in _flatten(carry):
        if isinstance(x, torch.Tensor):
            return x.device
    raise ValueError("the carry holds no tensor")


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


# ---------------------------------------------------------------------------
# one leaf's resting place and the fetches
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Leaf:
    src: torch.Tensor            # stacked (L, ...), the local shard
    fsdp_dim: "int | None"       # dim of one layer sharded over the groups
    n: int                       # ranks over the FSDP axes (1: not sharded)
    groups: list                 # (process group, ranks) an FSDP axis,
    #                              the first axis outermost
    full: "tuple[int, ...]"      # one layer, gathered

    def whole_here(self, dev: torch.device) -> bool:
        return self.fsdp_dim is None and self.src.device == dev

    def gather(self, piece: torch.Tensor) -> "list[torch.Tensor]":
        """Every rank's piece over the FSDP axes, in the order the axes cut
        the dim (the first outermost): one gather an axis, innermost
        first."""
        parts = [piece]
        for group, n in reversed(self.groups):
            got = all_gather(torch.stack(parts), group, n)
            parts = [p for g in got for p in g.unbind(0)]
        return parts

    def scatter(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's block of the sum of `g` over the FSDP axes."""
        for group, n in self.groups:
            g = reduce_scatter(g, self.fsdp_dim, group, n)
        return g


def _leaves(stacked_ws, settings, mesh, shard_specs, full_specs):
    """The FSDP dim of a leaf is the dim whose spec entry holds
    `settings.fsdp_axis` where `full_specs` keeps it whole; it is gathered
    over every axis of that entry (one, or the kimi-scale ("pod",
    "data")).  Any other split dim must be the model axis alone."""
    sizes = axis_sizes(mesh)
    out = []
    for path, w in _flatten(stacked_ws):
        shard, full = _at(shard_specs, path), _at(full_specs, path)
        dim, axes = None, ()
        for d, entry in enumerate(shard or ()):
            kept = () if full is None else _names(full[d])
            names = _names(entry)
            if settings.fsdp_axis in names and settings.fsdp_axis not in kept:
                dim = d
                axes = tuple(a for a in names
                             if a not in kept and sizes.get(a, 1) > 1)
            elif names and names != (TP_AXIS,):
                raise ValueError(
                    f"{path}: a dim sharded over {entry}: the streamer "
                    f"gathers the FSDP entry (one holding "
                    f"{settings.fsdp_axis!r}) and keeps the model axis")
        if TP_AXIS in axes:
            raise ValueError(f"{path}: the FSDP dim also holds the model "
                             f"axis")
        shape = list(w.shape[1:])
        groups = []
        if dim is not None and axes:
            if not hasattr(mesh, "get_group"):
                raise ValueError(
                    f"{path}: FSDP shards over {axes} need a DeviceMesh "
                    f"(launch.mesh) to gather over")
            groups = [(mesh.get_group(a), sizes[a]) for a in axes]
        else:
            dim = None
        n = 1
        for _, k in groups:
            n *= k
        if dim is not None:
            shape[dim] *= n
        out.append(_Leaf(w, dim, n, groups, tuple(shape)))
    return out


def _regions(leaf: _Leaf, buf: torch.Tensor, chunk_dim: int, chunks: int,
             c: int):
    """The views of `buf` (one layer, gathered) that rank r's piece of
    chunk c lands in, r = 0..n-1.  A rank's piece is chunk c of its own
    shard; when the chunk dim is the FSDP dim that piece is a sub-chunk of
    the rank's shard, not a slice of the global chunk, and lands at the
    rank's offset plus the sub-chunk's."""
    if leaf.fsdp_dim is None:
        return [_take_chunk(buf, chunk_dim, chunks, c)]
    d, cd = leaf.fsdp_dim, chunk_dim % buf.ndim
    per = leaf.full[d] // leaf.n
    out = []
    for r in range(leaf.n):
        if cd == d:
            lo, hi = _chunk_bounds(per, chunks, c)
            out.append(buf.narrow(d, r * per + lo, hi - lo))
        else:
            out.append(_take_chunk(buf, cd, chunks, c).narrow(d, r * per,
                                                               per))
    return out


class _Fetcher:
    """The fetches of one `stream_layers` call: buffers on the compute
    device, the side stream and its events, the issue record."""

    def __init__(self, leaves, dev, settings, record, grad: bool):
        self.leaves, self.dev, self.record = leaves, dev, record
        self.cd = settings.chunk_dim
        self.grad = grad
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.compute = torch.cuda.current_stream(dev)
            self.side = torch.cuda.Stream(dev)

    def buffers(self, skip=()):
        """One layer's buffers on the compute device (None at the leaf
        indices in `skip`)."""
        bufs = [None if i in skip else
                torch.empty(lf.full, dtype=lf.src.dtype, device=self.dev)
                for i, lf in enumerate(self.leaves)]
        if self.cuda:
            for b in bufs:
                if b is not None:
                    b.record_stream(self.side)
        return bufs

    def begin_step(self) -> None:
        """The fetches issued from here on wait for every compute issued
        so far."""
        if self.cuda:
            self.side.wait_stream(self.compute)

    def end_step(self):
        """An event after every fetch issued so far (None on the CPU)."""
        return self.side.record_event() if self.cuda else None

    def wait(self, event) -> None:
        """The compute issued from here on waits for `event`."""
        if event is not None:
            self.compute.wait_event(event)

    def finish(self) -> None:
        if self.cuda:
            self.compute.wait_stream(self.side)

    def fetch(self, step: int, layer: int, bufs, chunks: int = 1,
              c: int = 0) -> None:
        """Chunk c of `chunks` of layer `layer`'s leaves into `bufs` (the
        whole layer at chunks == 1)."""
        nbytes = 0
        side = (torch.cuda.stream(self.side) if self.cuda
                else contextlib.nullcontext())
        with torch.no_grad(), side:
            for lf, buf in zip(self.leaves, bufs):
                if buf is None:
                    continue
                piece = _take_chunk(lf.src[layer], self.cd, chunks, c)
                regions = _regions(lf, buf, self.cd, chunks, c)
                parts = [piece] if lf.fsdp_dim is None else lf.gather(piece)
                for dst, part in zip(regions, parts):
                    dst.copy_(part, non_blocking=self.cuda)
                    nbytes += dst.numel() * dst.element_size()
        if self.record is not None:
            self.record.append((step, layer, None if chunks == 1 else c,
                                nbytes))

    def attach(self, layer: int, bufs, ws_like, whole=None):
        """The layer's weights for apply_fn: the buffers (joined to the
        resting leaves for autograd when a gradient is asked for), with
        `whole` (leaf index -> tensor) handed over as it is."""
        whole = whole or {}
        fetched = [i for i in range(len(self.leaves)) if i not in whole]
        outs = [bufs[i] for i in fetched]
        if self.grad and fetched:
            outs = _Gathered.apply(
                [self.leaves[i] for i in fetched], len(fetched), *outs,
                *(self.leaves[i].src[layer] for i in fetched))
        got = dict(zip(fetched, outs))
        got.update(whole)
        return _unflatten(ws_like, iter(got[i]
                                        for i in range(len(self.leaves))))


class _Gathered(torch.autograd.Function):
    """Joins a layer's fetched buffers to the resting leaves it was fetched
    from: forward hands the buffers on, backward brings each gradient back
    to its leaf's device and, for an FSDP shard, reduce-scatters it (sum)
    over the group."""

    @staticmethod
    def forward(ctx, leaves, n, *tensors):
        ctx.leaves = leaves
        return tuple(b.view_as(b) for b in tensors[:n])

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for lf, g in zip(ctx.leaves, grads):
            if g is None:
                out.append(None)
                continue
            g = g.to(lf.src.device)
            if lf.fsdp_dim is not None:
                g = lf.scatter(g)
            out.append(g)
        return (None, None, *([None] * len(ctx.leaves)), *out)


# ---------------------------------------------------------------------------
# the four modes
# ---------------------------------------------------------------------------

def stream_layers(apply_fn, carry_init, stacked_ws, num_layers: int, *,
                  settings: StreamSettings, mesh, shard_specs, full_specs,
                  record: "list | None" = None):
    """Run `carry = apply_fn(carry, w_l)` over L stacked layers with the
    selected fetch / compute schedule.

    stacked_ws   nested dicts / lists of tensors with leading dim L, each
                 the local FSDP shard per `shard_specs` (one spec a leaf for
                 ONE layer, without the L dim), resting on the compute
                 device or in host memory
    mesh         None (one device), a mapping of axis sizes, or a
                 DeviceMesh (its `settings.fsdp_axis` group gathers)
    record       when a list, gets (step, layer, chunk, bytes) for every
                 fetch issued, in issue order: step -1 is the prologue,
                 chunk None a whole layer
    """
    mode = settings.mode
    if mode == "resident":
        c = carry_init
        for i in range(num_layers):
            c = apply_fn(c, _layer(stacked_ws, i))
        return c

    dev = _device_of(carry_init)
    leaves = _leaves(stacked_ws, settings, mesh, shard_specs, full_specs)
    grad = torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad
        for _, x in _flatten(carry_init) + _flatten(stacked_ws))
    f = _Fetcher(leaves, dev, settings, record, grad)

    def gather(step: int, j: int):
        """Layer j whole, (buffers, {leaf index: tensor}): the leaves
        already whole here as they are, the others fetched into fresh
        buffers.  Returns with an event after the fetch."""
        whole = {i: lf.src[j] for i, lf in enumerate(leaves)
                 if lf.whole_here(dev)}
        bufs = f.buffers(skip=whole)
        f.begin_step()
        if len(whole) < len(leaves):
            f.fetch(step, j, bufs)
        return (bufs, whole), f.end_step()

    c = carry_init
    if mode == "insitu":
        for i in range(num_layers):
            (bufs, whole), ready = gather(i, i)
            f.wait(ready)
            c = apply_fn(c, f.attach(i, bufs, stacked_ws, whole))
        f.finish()
        return c

    if mode == "naive_pp":
        cur, ready = gather(-1, 0)
        for i in range(num_layers):
            # issue the next layer's (whole) fetch, then compute this one
            nxt, nxt_ready = gather(i, min(i + 1, num_layers - 1))
            f.wait(ready)
            bufs, whole = cur
            c = apply_fn(c, f.attach(i, bufs, stacked_ws, whole))
            cur, ready = nxt, nxt_ready
        f.finish()
        return c

    # ---- gpp ----
    G = max(2, min(settings.ring_depth, num_layers))
    chunks = max(1, G - 1)
    ring = [f.buffers() for _ in range(G)] if not grad else [None] * G
    holds = list(range(G))           # the (virtual) layer each slot is for

    def slot_for(v: int):
        """Slot v % G, given buffers of its own when layer v is new to it
        under autograd."""
        s = v % G
        if grad and (ring[s] is None or holds[s] != v):
            ring[s] = f.buffers()
        holds[s] = v
        return ring[s]

    # prologue: layers 0..G-2 whole into slots 0..G-2 (the pipeline fill)
    f.begin_step()
    for j in range(G - 1):
        f.fetch(-1, min(j, num_layers - 1), slot_for(j))
    ready = f.end_step()
    for i in range(num_layers):
        w_use = ring[i % G]
        f.begin_step()
        # chunk-fetch the window: layer i+k gets chunk (G-1-k), k = 1..G-1
        for k in range(1, G):
            ch = chunks - k if chunks > 1 else 0
            f.fetch(i, min(i + k, num_layers - 1), slot_for(i + k), chunks,
                    ch)
        nxt_ready = f.end_step()
        f.wait(ready)
        c = apply_fn(c, f.attach(i, w_use, stacked_ws))
        ready = nxt_ready
    f.finish()
    return c


def plan_for_layer(*, layer_bytes: float, layer_flops: float, mesh,
                   settings: StreamSettings, flops_per_s: float,
                   ici_bytes_per_s: float) -> StreamPlan:
    """The GPP plan for one layer on the mesh: the all-gather moves
    (n-1)/n of layer_bytes across the FSDP axis of n ranks.  The rates
    are the caller's (no default: the reference's are a TPU's)."""
    n = axis_sizes(mesh).get(settings.fsdp_axis, 1)
    gather_bytes = layer_bytes * max(0, n - 1) / max(1, n)
    return plan_stream(
        block_bytes=gather_bytes,
        compute_flops=layer_flops,
        flops_per_s=flops_per_s,
        transfer_bytes_per_s=ici_bytes_per_s,
        max_ring=8,
    )
