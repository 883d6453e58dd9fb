"""Roofline analysis with H100 constants (the port's copy of
`repro.launch.roofline`): three terms a (arch x shape x mesh) cell, from
one counted run of its step on the meta device.

    compute    = FLOPs a card / PEAK_FLOPS          [dense bf16]
    memory     = bytes a card / HBM_BW              [HBM]
    collective = collective bytes a card / NET_BW   [InfiniBand]

The reference reads its counts off the compiled HLO, with parsers that
make a collective or a dot inside the scan over layers count once a trip.
The port has no HLO: `count` runs the step once, eagerly, on meta tensors
(shapes and dtypes, no data) under a `TorchDispatchMode` that sees every
aten and c10d op the step issues, backward and recomputation included.
Eager execution runs every layer, so every count is loop-aware by nature;
the records keep the reference's `*_loop_aware` keys so that
`report.rows_from` reads the same fields.  Count on meta only: the CUDA
kernels' custom ops have no FLOP formula, so on the card the count would
miss them, while on meta `kernels.ops` routes every call to its plain
version.

Each term is also set beside the analytic `model_flops` (6·N·D for
training, 2·N·D for inference).
"""
from __future__ import annotations

import dataclasses
import re
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA's data sheet, dense
# rates without sparsity); a card set below 700 W runs slower under load.
PEAK_FLOPS = 989e12          # bf16 FLOP/s a card
HBM_BW = 3.35e12             # bytes/s a card
# One 400 Gb/s NDR InfiniBand port a GPU (the DGX H100 layout): 50e9 bytes/s
# a card.  At 256 and 512 cards every mesh axis of 16 spans more than one
# 8-GPU node, so every collective of those meshes crosses InfiniBand, not
# NVLink (900e9 B/s inside a node).
NET_BW = 50e9
# The "fits" limit: `torch.cuda.get_device_properties(0).total_memory` on
# an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (chip_smoke.py prints
# it beside the card's name).
HBM_BYTES = 85_017_493_504

_COLL_KINDS = (("all-gather", ("allgather", "all_gather")),
               ("reduce-scatter", ("reduce_scatter",)),
               ("all-reduce", ("allreduce", "all_reduce")),
               ("all-to-all", ("alltoall", "all_to_all")))
# an op whose name looks like a product but that has no FLOP formula
# lowers `dot_coverage` below 1: its FLOPs and dot bytes are missing
_DOT_LIKE = re.compile(r"mm|conv|attention|matmul|linear|dot|einsum")


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a nested tuple / list / dict."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _group_size(args) -> "int | None":
    """The size of the process group a c10d op runs over (None: unknown)."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject) and a._type().qualified_name(
                ).endswith(".ProcessGroup"):
            return dist.ProcessGroup.unbox(a).size()
    return None


def _coll_kind(func) -> "str | None":
    """The reference's kind of a c10d collective, another c10d op
    (broadcast, send / recv, a barrier) under its own name, None for any
    other op (the functional collectives' waits among them)."""
    if func.namespace not in ("c10d", "_c10d_functional"):
        return None
    name = func._schema.name.split("::")[-1]
    for kind, keys in _COLL_KINDS:
        if any(k in name for k in keys):
            return kind
    return name if func.namespace == "c10d" else None


class _Counter(TorchDispatchMode):
    """Counts every op dispatched inside it (see `count`)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.dot_bytes = 0
        self.out_bytes = 0
        self.dots = self.dots_counted = 0
        self.collectives: dict = {}
        self.live = self.peak = 0
        self._storages: set = set()

    def _free(self, key, n):
        self._storages.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _coll_kind(func)
        if kind is not None:
            if _group_size(args) == 1:
                return out                    # one rank moves no bytes
            # c10d ops write their first argument: the output tensors
            nbytes = tensor_bytes(args[0] if args else ())
            rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += nbytes
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            self.dot_bytes += tensor_bytes((args, kwargs, out))
            self.dots += 1
            self.dots_counted += 1
        elif _DOT_LIKE.search(func._schema.name.split("::")[-1]):
            self.dots += 1
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for ret, t in zip(func._schema.returns, outs):
            alias = ret.alias_info
            if not isinstance(t, torch.Tensor) or (alias is not None
                                                   and not alias.is_write):
                continue                      # a view writes nothing
            self.out_bytes += t.numel() * t.element_size()
            if alias is not None:
                continue                      # in place: no new storage
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            # the storage's Python object lives as long as its C++ storage
            # (autograd's saved tensors and views included)
            weakref.finalize(st, self._free, key, n)
        return out


def count(fn, *args, **kwargs) -> "tuple[object, dict]":
    """Run fn(*args, **kwargs) once and count what it issues: (its output,
    a dict of)

      flops          FLOPs of every op with a formula in
                     `torch.utils.flop_counter` (the table FlopCounterMode
                     reads): mm, addmm, bmm, baddbmm, convolutions and
                     SDPA, forward and backward
      dot_bytes      operand + output bytes of those ops (the reference's
                     `dot_stats_loop_aware` bytes: matmul traffic)
      dot_coverage   the share of product-like ops (by name) that have a
                     formula; below 1 the FLOPs miss some
      out_bytes      output bytes of every op but views (in-place ops
                     count the tensor they write): the upper bound of the
                     reference's `bytes_loop_aware`
      collectives    {kind: {"count", "bytes"}}: every collective over
                     more than one rank (all-gather, reduce-scatter,
                     all-reduce, all-to-all; any other c10d op under its
                     own name) and the bytes of the tensors it writes on
                     this rank.  Each collective `torch.distributed`
                     issues is a c10d dispatcher op, which the dispatch
                     mode sees, so none is missed whichever module calls
                     it
      peak_bytes     the peak of the bytes of the storages allocated
                     inside the call and still alive (outputs, autograd's
                     saved tensors, temporaries), above what was alive
                     before it

    Run it on meta tensors: nothing is computed, only shapes are read."""
    ctr = _Counter()
    with ctr:
        out = fn(*args, **kwargs)
    return out, {
        "flops": float(ctr.flops),
        "dot_bytes": float(ctr.dot_bytes),
        "dot_coverage": ctr.dots_counted / ctr.dots if ctr.dots else 1.0,
        "out_bytes": float(ctr.out_bytes),
        "collectives": ctr.collectives,
        "peak_bytes": ctr.peak,
    }


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float           # analytic 6*N*D (global)
    hlo_flops_global: float      # the counted FLOPs x chips
    useful_fraction: float       # model_flops / hlo_flops
    bottleneck: str

    @property
    def step_time_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute term / max term: 1.0 = compute-bound at peak."""
        return self.compute_s / self.step_time_s if self.step_time_s else 0.0


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs per step (global): 6*N_active*tokens for train,
    2*N_active*tokens for inference forward."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch * 1  # decode: one token
    return 2.0 * n_active * tokens


def mesh_chips(mesh: str) -> int:
    """Cards of a mesh named "16x16", "2x16x16", "1x1", ..."""
    n = 1
    for d in mesh.split("x"):
        n *= int(d)
    return n


def analyze_record(rec: dict, cfg, shape) -> Roofline:
    """The three terms of a dry-run record (`dryrun.run_cell`)."""
    chips = mesh_chips(rec["mesh"])
    flops_dev = rec["flops_per_device"]
    bytes_dev = rec["bytes_per_device"]
    coll_dev = sum(v["bytes"] for v in rec.get("collectives", {}).values())
    mf = model_flops(cfg, shape)
    hlo_global = flops_dev * chips
    r = Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        compute_s=flops_dev / PEAK_FLOPS,
        memory_s=bytes_dev / HBM_BW,
        collective_s=coll_dev / NET_BW,
        model_flops=mf,
        hlo_flops_global=hlo_global,
        useful_fraction=mf / hlo_global if hlo_global else 0.0,
        bottleneck="",
    )
    terms = {"compute": r.compute_s, "memory": r.memory_s,
             "collective": r.collective_s}
    r.bottleneck = max(terms, key=terms.get)
    return r
