"""Ranges around the calls into the program's layers, and the reduction of
a `torch.profiler` trace to per-range device time, the device's busy time
and the breakdown.

`Ranges.install()` replaces, by name in each model module that imported
them, the op entry points `kernels.ops.dense`, `dense_grouped` and
`paged_attn`, and the step functions `transformer.prefill_chunk`,
`decode_step_paged` and `optim.adamw.adamw_update`, with wrappers that open
a `torch.profiler.record_function` range named `bench.<name>` and, while
`recording` is on, keep each op call's shapes for its roofline bound.
Only the traced run installs them; `uninstall()` puts the originals back.
"""
from __future__ import annotations

import bisect
import importlib
import math
import re
from collections import defaultdict

import torch

from bench.lib import counts

# (module, attribute, range name) of every wrapped entry point
TARGETS = (
    ("repro_torch.models.attention", "dense", "dense"),
    ("repro_torch.models.attention", "paged_attn", "paged_attn"),
    ("repro_torch.models.layers", "dense", "dense"),
    ("repro_torch.models.moe", "dense", "dense"),
    ("repro_torch.models.moe", "dense_grouped", "dense_grouped"),
    ("repro_torch.models.transformer", "prefill_chunk", "prefill_chunk"),
    ("repro_torch.models.transformer", "decode_step_paged", "decode_step"),
    ("repro_torch.optim.adamw", "adamw_update", "adamw_update"),
)
PREFIX = "bench."


def _item(t) -> int:
    return t.element_size()


class Ranges:
    """The wrappers and what they saw while `recording`.

    An op call inside a prefill chunk or a decode step counts only the rows
    of that step that hold real work: the chunk's real tokens (which the
    caller gives `bounds`, from the engine's ledger) or the decode step's
    active lanes (its `active` argument), and for the grouped experts
    those tokens times the experts a token is routed to.  Calls outside a
    serving step (training) count the rows they are given."""

    def __init__(self):
        self.recording = False
        self.calls: "dict[str, list]" = defaultdict(list)
        self.prefill_starts: "list[int]" = []
        self.prefills: "list[dict]" = []       # prefill steps while recording
        self._step: "dict | None" = None
        self._saved = []

    # ------------------------------------------------------------ records
    def _note_dense(self, x, w, kw):
        cd = kw.get("contract_dims", 1)
        K = math.prod(w.shape[:cd])
        N = math.prod(w.shape[cd:])
        b = kw.get("bias")
        self.calls["dense"].append((
            x.numel() // K, K, N, _item(x), _item(w),
            0 if b is None else _item(b), self._step))

    def _note_grouped(self, x, w, kw):
        E, C, D = x.shape
        self.calls["dense_grouped"].append(
            (E, C, D, w.shape[2], _item(x), _item(w), self._step))

    def _note_attn(self, q, pool_a, pool_b, positions, kw):
        if kw.get("mla", False):
            dv = pool_a.shape[-1]
            per = (pool_a.shape[-1] + pool_b.shape[-1]) * _item(pool_a)
        else:
            dv = pool_b.shape[-1]
            per = (math.prod(pool_a.shape[2:]) + math.prod(pool_b.shape[2:])
                   ) * _item(pool_a)
        # the positions stay on the device until the slice ends
        self.calls["paged_attn"].append(
            (tuple(q.shape), dv, per, positions, kw.get("window"),
             _item(q), self._step))

    @staticmethod
    def _real(step) -> int:
        """Tokens of real work in a serving step."""
        return int(step["real"] if "real" in step
                   else step["active"].sum())

    def _rows(self, M: int, step) -> int:
        """Rows of a call's M that hold real work: per-token rows of the
        step scale to its real tokens; any other count (the prefill's one
        logits row) is its own."""
        if step is None or M % step["rows"]:
            return M
        return M // step["rows"] * self._real(step)

    def bounds(self, prefill_real=()) -> "dict[str, tuple[float, int]]":
        """(sum of the bounds in seconds, number of calls) per op.
        prefill_real: the real tokens of each prefill chunk run while
        recording, in order."""
        if len(prefill_real) != len(self.prefills):
            raise ValueError(f"{len(self.prefills)} prefill chunks ran while "
                             f"recording; {len(prefill_real)} counts given")
        for step, real in zip(self.prefills, prefill_real):
            step["real"] = int(real)
        out = {}
        rows = self.calls.get("dense", [])
        out["dense"] = (sum(
            counts.bound(*counts.dense_call(self._rows(M, st), K, N, xi,
                                            wi, xi, bi),
                         counts.peak_for(xi, wi))
            for M, K, N, xi, wi, bi, st in rows), len(rows))
        rows = self.calls.get("dense_grouped", [])
        total = 0.0
        for E, C, D, F, xi, wi, st in rows:
            R = E * C if st is None or not st["k"] \
                else self._real(st) * st["k"]
            total += counts.bound(*counts.grouped_call(E, R, D, F, xi, wi,
                                                       xi),
                                  counts.peak_for(xi, wi))
        out["dense_grouped"] = (total, len(rows))
        rows = self.calls.get("paged_attn", [])
        total = 0.0
        for shape, dv, per, positions, window, item, st in rows:
            B, S, H, dk = shape
            starts = positions.reshape(-1).tolist()
            if st is None:
                spans = [(p, S) for p in starts]
            elif "real" in st:
                spans = [(starts[0], self._real(st))]
            else:
                live = st["active"].reshape(-1).tolist()
                spans = [(p, S) for p, a in zip(starts, live) if a]
            f, b = counts.paged_attn_call(spans, H, dk, dv, per, window,
                                          item, item)
            total += counts.bound(f, b, counts.peak_for(item))
        out["paged_attn"] = (total, len(rows))
        return out

    # --------------------------------------------------------- wrappers
    def _wrap(self, fn, name: str):
        note = {"dense": lambda a, kw: self._note_dense(a[0], a[1], kw),
                "dense_grouped":
                    lambda a, kw: self._note_grouped(a[0], a[1], kw),
                "paged_attn":
                    lambda a, kw: self._note_attn(a[0], a[1], a[2], a[4],
                                                  kw)}.get(name)

        def wrapped(*args, **kw):
            if self.recording and note is not None:
                note(args, kw)
            if name == "prefill_chunk":
                self.prefill_starts.append(int(args[5]))
            if name in ("prefill_chunk", "decode_step"):
                return self._in_step(fn, name, args, kw)
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kw)
        wrapped.__wrapped__ = fn
        return wrapped

    def _in_step(self, fn, name: str, args, kw):
        """A serving step: (params, cfg, tokens, ...), its op calls noted
        against it."""
        step = None
        if self.recording:
            step = {"rows": args[2].numel(),
                    "k": getattr(args[1], "experts_per_token", 0) or 0}
            if name == "prefill_chunk":
                self.prefills.append(step)
            else:
                step["active"] = args[6]
        self._step = step
        try:
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kw)
        finally:
            self._step = None

    def install(self) -> None:
        for mod_name, attr, name in TARGETS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, name))

    def uninstall(self) -> None:
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

# host calls that put work on the device (the `cuda*` and `cu*` API calls)
LAUNCH = re.compile(r"^cu(da)?[A-Z]")


def _events(prof):
    """(host events, device operations) of a finished profiler as tuples
    (name, start_ns, end_ns, correlation id): the raw kineto events, whose
    device operations carry the correlation id of the runtime call that
    launched them.  User annotations mirrored onto the device are left
    out."""
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s = e.start_ns()
        row = (name, s, s + e.duration_ns(), e.correlation_id())
        if e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(row)
        elif not (e.is_user_annotation() or name.startswith(PREFIX)):
            dev.append(row)
    return host, dev


def _union(intervals) -> "list[tuple[float, float]]":
    out: "list[list[float]]" = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def attribute(host, dev) -> "dict[str, list[float]]":
    """Device seconds of each call of each `bench.*` range: every device
    operation counts for each range whose host interval holds the runtime
    call that launched it (matched by correlation id)."""
    launch_at = {c: s for n, s, _, c in host if LAUNCH.match(n)}
    calls: "dict[str, list[tuple[int, int]]]" = defaultdict(list)
    for n, s, e, _ in host:
        if n.startswith(PREFIX):
            calls[n[len(PREFIX):]].append((s, e))
    out = {}
    for name, spans in calls.items():
        spans.sort()
        starts = [s for s, _ in spans]
        acc = [0.0] * len(spans)
        for _, s, e, c in dev:
            t = launch_at.get(c)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                acc[i] += (e - s) / 1e9
        out[name] = acc
    return out


def reduce_events(prof) -> dict:
    """From a finished profiler: device seconds a call under each
    `bench.*` range, the busy seconds (the union of the device's
    operations), the device operations that took most time and the longest
    idle gaps named by the innermost host event that covered them."""
    host, dev = _events(prof)
    ranges = attribute(host, dev)
    spans = _union((s, e) for _, s, e, _ in dev)
    busy = sum(b - a for a, b in spans) / 1e9
    by_op: "dict[str, float]" = defaultdict(float)
    for n, s, e, _ in dev:
        by_op[n] += (e - s) / 1e9
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1])
                   for i in range(len(spans) - 1)), reverse=True)
    host.sort(key=lambda h: h[1])
    starts = [h[1] for h in host]
    by_host: "dict[str, float]" = defaultdict(float)
    for length, at in gaps[:200]:
        i = bisect.bisect_right(starts, at)
        best = None
        for h in host[max(0, i - 4000):i]:
            if h[2] >= at and (best is None or h[2] - h[1]
                               < best[2] - best[1]):
                best = h
        by_host[best[0] if best is not None else "none"] += length / 1e9
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"ranges": ranges, "busy_s": busy,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": [[n, s] for n, s in idle]}}
