#!/usr/bin/env python3
"""Which op of qwen1.5-0.5b's bf16 decode step makes a row's bits depend on
the batch it rides in.

    python3 scripts/decode_batch_rows.py [--positions 32768] [--layers 24]
                                         [--json-out PATH]

On one NVIDIA GPU: builds the kernels, then runs `transformer.decode_step`
at qwen1.5-0.5b's full width in bf16 at B = 12 over a random cache of
`--positions` positions (at its last position), and the same first two
rows (tokens and cache rows) at B = 2.  Every op of each run is recorded
in order: aten ops through a TorchDispatchMode (view ops and allocations
skipped), the port's kernels through their wrappers (`gpp_matmul`, which
also runs the f32 logits head, and `rmsnorm`), each output reduced on the
card to an exact digest of its bits in the rows the B = 2 run holds.  It
prints the first op whose rows 0-1 differ, with the largest gap there, how
many kernel calls got equal inputs and gave equal rows, and the logits'
gap.  Then a control: the same two runs with `attention._sdpa` taking one
row at a time, so that its f32 products run at one batch count in both;
if the logits' rows then agree bit for bit, nothing else on the path
depends on the batch.  Without CUDA it exits 2.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS, BATCH = 2, 12


def _digest(t):
    """An exact digest of t's bits (3 int64 sums, on t's device)."""
    import torch
    x = t.detach().contiguous().reshape(-1)
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    x = x.view(torch.uint8) if x.dtype == torch.bool \
        else x.view(ints[x.element_size()])
    out = torch.zeros(3, dtype=torch.int64, device=x.device)
    step = 1 << 26
    for lo in range(0, x.numel(), step):
        v = x[lo:lo + step].to(torch.int64)
        w = torch.arange(lo, lo + v.numel(), device=x.device) % 65521 + 1
        out += torch.stack([v.sum(), (v * w).sum(), (v ^ (w * 40503)).sum()])
    return out


def _rows(t, like):
    """The part of t (a B = 12 output) that the B = 2 run's output of
    shape `like` holds: the first rows along the one dim that scales with
    the batch (None: no such dim)."""
    if tuple(t.shape) == tuple(like):
        return t
    diff = [d for d, (a, b) in enumerate(zip(t.shape, like)) if a != b]
    if len(t.shape) != len(like) or len(diff) != 1:
        return None
    d = diff[0]
    if t.shape[d] * ROWS != like[d] * BATCH:
        return None
    return t.narrow(d, 0, like[d])


class Recorder:
    """The ops of one run: (name, shape, digest) an output, in order, and
    for each kernel call (op index, input digests, input shapes).  With
    `ref` (the B = 2 run's recorder) each tensor is first cut to the rows
    that run holds; with `keep`, the outputs at those op indices are
    kept."""

    def __init__(self, ref=None, keep=()):
        self.ops, self.ref, self.keep, self.kept = [], ref, keep, {}
        self.kernel_inputs = []
        self.inside = 0          # > 0 inside a kernel wrapper: its own
        #                          allocations and launches are the kernel

    def _part(self, t, like):
        return t if self.ref is None else (
            None if like is None else _rows(t, like))

    def add(self, name, t, inputs=None):
        import torch
        if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
            return
        i = len(self.ops)
        ref = self.ref.ops if self.ref is not None else ()
        part = self._part(t, ref[i][1] if i < len(ref) else None)
        self.ops.append((name, tuple(t.shape),
                         None if part is None else _digest(part)))
        if inputs is not None:
            j = len(self.kernel_inputs)
            likes = (self.ref.kernel_inputs[j][2] if self.ref is not None
                     and j < len(self.ref.kernel_inputs)
                     else [None] * len(inputs))
            parts = [self._part(x, like) for x, like in zip(inputs, likes)]
            self.kernel_inputs.append(
                (i, [None if p is None else _digest(p) for p in parts],
                 [tuple(x.shape) for x in inputs]))
        if i in self.keep and part is not None:
            self.kept[i] = part.detach().float().cpu()


def _hooks(rec):
    """Context: every aten op and kernel call of the block recorded."""
    import contextlib

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import ops, rmsnorm as rk

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = str(func)
            if not rec.inside and not getattr(func, "is_view", False) \
                    and "empty" not in name:
                for t in (out if isinstance(out, (tuple, list)) else (out,)):
                    rec.add(name, t)
            return out

    def wrap(fn, name):
        def call(x, w_or_scale, *a, **k):
            rec.inside += 1
            try:
                y = fn(x, w_or_scale, *a, **k)
            finally:
                rec.inside -= 1
            with torch.utils._python_dispatch._disable_current_modes():
                rec.add(name, y, inputs=(x, w_or_scale))
            return y
        return call

    @contextlib.contextmanager
    def ctx():
        saved = ops.gpp_matmul, rk.rmsnorm
        ops.gpp_matmul = wrap(saved[0], "kernel gpp_matmul")
        rk.rmsnorm = wrap(saved[1], "kernel rmsnorm")
        try:
            with Mode():
                yield
        finally:
            ops.gpp_matmul, rk.rmsnorm = saved
    return ctx()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--positions", type=int, default=32768)
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("decode_batch_rows: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models import attention, registry
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import map_specs, tree_leaves
    resolve_device("cuda")
    t0 = time.perf_counter()
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f}s", flush=True)

    cfg = registry.get_config("qwen1.5-0.5b").with_(
        dtype="bfloat16", num_layers=args.layers)
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    T, pos = args.positions, args.positions - 1
    gen = torch.Generator(device="cuda").manual_seed(9)
    tok12 = torch.randint(0, cfg.vocab_size, (BATCH, 1), generator=gen,
                          device="cuda")
    big = map_specs(lambda _, sp: torch.empty(sp.shape, dtype=sp.dtype,
                                               device="cuda"),
                    tf.cache_specs(cfg, BATCH, T))
    for leaf in tree_leaves(big):
        for layer in leaf:                          # (L, B, T, KVH, hd)
            layer.normal_(generator=gen)
    small = _slice_tree(big, ROWS)
    tok2 = tok12[:ROWS].clone()

    def decode(tok, caches, rec):
        with torch.no_grad(), _hooks(rec):
            logits, _ = tf.decode_step(params, cfg, tok, caches, pos,
                                       donate=True)
        torch.cuda.synchronize()
        return logits

    def pair(keep=()):
        """(B = 2 recorder, B = 12 recorder, logits 2, logits 12), the
        caches restored between runs (the step writes position `pos`)."""
        saved = {id(t): t[:, :, pos].clone() for t in tree_leaves(big)}
        r2 = Recorder(keep=keep)
        l2 = decode(tok2, small, r2)
        r12 = Recorder(ref=r2, keep=keep)
        l12 = decode(tok12, big, r12)
        for t in tree_leaves(big):
            t[:, :, pos].copy_(saved[id(t)])
        for t, b in zip(tree_leaves(small), tree_leaves(big)):
            t.copy_(b[:, :ROWS])
        return r2, r12, l2, l12

    out = {"positions": T, "layers": args.layers, "rows": ROWS,
           "batch": BATCH,
           "card": torch.cuda.get_device_name(0)}
    r2, r12, l2, l12 = pair()
    # the runs' op sequences agree up to `aligned` (by name); the first
    # op there whose rows' bits differ
    aligned = next((i for i, (a, b) in enumerate(zip(r2.ops, r12.ops))
                    if a[0] != b[0]), min(len(r2.ops), len(r12.ops)))
    check_len = aligned == len(r2.ops) == len(r12.ops)
    first = next((i for i, (a, b) in enumerate(zip(r2.ops[:aligned],
                                                   r12.ops))
                  if b[2] is not None and not torch.equal(a[2], b[2])),
                 None)
    calls = [j for j in range(min(len(r2.kernel_inputs),
                                  len(r12.kernel_inputs)))
             if r2.kernel_inputs[j][0] < aligned]
    by_kernel = {}
    for j in calls:
        i = r2.kernel_inputs[j][0]
        name = r2.ops[i][0]
        si = all(d is not None and torch.equal(a, d) for a, d in
                 zip(r2.kernel_inputs[j][1], r12.kernel_inputs[j][1]))
        so = r12.ops[i][2] is not None and torch.equal(r2.ops[i][2],
                                                        r12.ops[i][2])
        k = by_kernel.setdefault(name, {"calls": 0, "equal_inputs": 0,
                                        "equal_inputs_equal_rows": 0})
        k["calls"] += 1
        k["equal_inputs"] += si
        k["equal_inputs_equal_rows"] += si and so
    logits_gap = float((l2.float() - l12[:ROWS].float()).abs().max())
    out.update({"ops": len(r2.ops), "ops_b12": len(r12.ops),
                "ops_aligned": check_len, "aligned_to": aligned,
                "parted_at": None if check_len else [
                    r2.ops[aligned][0] if aligned < len(r2.ops) else None,
                    r12.ops[aligned][0] if aligned < len(r12.ops) else None],
                "unaligned_ops": sum(b[2] is None for b in r12.ops),
                "kernels": by_kernel, "logits_max_abs_gap": logits_gap,
                "logits_scale": float(l2.abs().max())})
    if first is not None:
        k2, k12, _, _ = pair(keep=(first,))
        gap = float((k2.kept[first] - k12.kept[first]).abs().max())
        out["first"] = {"index": first, "op": r2.ops[first][0],
                        "shape_b2": list(r2.ops[first][1]),
                        "shape_b12": list(r12.ops[first][1]),
                        "max_abs_gap": gap,
                        "scale": float(k2.kept[first].abs().max()),
                        "ops_before": [r2.ops[j][0] for j in
                                       range(max(0, first - 6), first)],
                        "in_layer": sum(name == "kernel rmsnorm" for name, *_
                                        in r2.ops[:first]) // 2}
    print(json.dumps(out, indent=1), flush=True)

    # control: _sdpa a row at a time (its cuBLAS products at one batch
    # count in both runs)
    plain = attention._sdpa

    def by_row(q, k, v, mask, scale):
        m = mask if mask.dim() == 2 else None
        return torch.cat([plain(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                m if m is not None else mask[b:b + 1],
                                scale) for b in range(q.shape[0])])
    attention._sdpa = by_row
    try:
        _, _, c2, c12 = pair()
    finally:
        attention._sdpa = plain
    out["control"] = {
        "logits_rows_equal": bool(torch.equal(c2, c12[:ROWS])),
        "logits_max_abs_gap": float((c2.float() - c12[:ROWS].float())
                                    .abs().max())}
    print(f"decode_batch_rows [{out['card']}]: qwen1.5-0.5b bf16, "
          f"{args.layers} layers, {T} positions: rows 0-{ROWS - 1} at B = "
          f"{BATCH} against B = {ROWS}: logits gap {logits_gap:.4g} of "
          f"{out['logits_scale']:.4g}; first op whose rows differ: "
          + (_first_line(out["first"]) if first is not None else "none")
          + f"; kernels {by_kernel}; control (_sdpa a row at a time): "
          f"logits rows equal {out['control']['logits_rows_equal']} (gap "
          f"{out['control']['logits_max_abs_gap']:.4g})", flush=True)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(out, indent=1))
    return 0


def _first_line(f: dict) -> str:
    return (f"#{f['index']} {f['op']} (layer {f['in_layer']}) "
            f"{f['shape_b2']} / {f['shape_b12']}, gap "
            f"{f['max_abs_gap']:.4g} of {f['scale']:.4g}")


def _slice_tree(tree, rows):
    """The first `rows` rows (dim 1 of each stacked (L, B, ...) leaf),
    copied."""
    from repro_torch.models.layers import tree_map
    return tree_map(lambda t: None if t is None else
                    t[:, :rows].clone(), tree)


if __name__ == "__main__":
    sys.exit(main())
