#!/usr/bin/env python3
"""Does a token's row depend on the step shape it rides in?  On one NVIDIA
GPU, for the port's bf16 serving path.

    python3 scripts/row_invariance_sweep.py [--arch deepseek-v2-lite-16b]
                                            [--layers 4] [--serve]
                                            [--json-out PATH] [--device cpu]

Greedy streams with speculation on and off are equal only if a token's
logits are the same bits whether its row runs in a decode step (one row a
lane) or in a verify step (draft_len + 1 rows a lane).  This script asks
where they part:

  1. gpp_matmul on the tensor cores at every bf16 projection shape of both
     serving paths: x of 32 rows against its first 20 and its first 4 (the
     prefill, verify and decode row counts) — are the first 4 output rows
     the same bits?
  2. RMSNorm at the paths' widths on bf16 rows: 4 lanes of one row
     against 4 lanes of 5 rows (decode against verify), 200 random draws —
     how often is a lane's first row's f32 mean (torch.mean), its bf16
     output from the plain version (`kernels.ref.rmsnorm_ref`, a torch.sum
     over the row), and its bf16 output from the model's route
     (`models.layers.rmsnorm`: the row-invariant `rmsnorm_kernel`) not the
     same bits?
  3. the model at full width (random weights from seed 0; `--layers` of
     its depth) runs one decode step and one verify step (5 tokens a lane)
     on copies of one paged cache, the verify step's first token in each
     lane the decode step's token, at two sets of lane positions: verify
     spans inside one KV block, and spans that cross into the next block.
     Every op of the two steps is recorded in call order — each projection
     (`kernels.ops.dense`), the attention read (`kernels.ops.paged_attn`),
     the MLA absorption einsums, each RMSNorm, the MoE layer's output, each
     block's output and the logits — and the decode rows are compared with
     the verify step's first row of each lane: bits equal, or the largest
     difference.  The first op that differs is where the streams can part.
  4. `--serve`: the arch at full depth serves 4 requests x 16 greedy
     tokens (prompts holding their own greedy continuation, as in
     chip_smoke.py) with speculation off and on, for three prompt seeds,
     twice: with the port's logits head, and with its rows padded to 32
     (decode and verify then run one matmul shape).  For each pair it
     prints whether the streams are equal and, where they first part, the
     gap between the two largest logits of that token in each run and the
     op-by-op comparison of the two steps' rows that computed it.

It prints the ops that differ and a JSON record (`--json-out`).  Without
CUDA, or outside a checkout of the repo, it exits 2.  `--device cpu` runs
parts 3 and 4 alone, on the arch's smoke config and the plain versions of
the kernels (a dry run of the script itself: no device number comes from
it).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (K, N) of every bf16 projection on the two serving paths
PROJ = {"qwen qkvo": (1024, 1024), "qwen gate_up": (1024, 2816),
        "qwen down": (2816, 1024), "ds q": (2048, 3072),
        "ds kv_down": (2048, 576), "ds o": (2048, 2048),
        "ds shared_gate_up": (2048, 2816), "ds shared_down": (2816, 2048),
        "ds dense_gate_up": (2048, 10944), "ds dense_down": (10944, 2048)}
SLOTS, DRAFT, MAX_LEN, BS = 4, 4, 128, 16
# each lane's decode position: verify spans (5 tokens) inside one 16-token
# block, and spans that cross into the next block
POSITIONS = {"inside a block": (5, 17, 40, 100),
             "across blocks": (13, 29, 46, 94)}


def gpp_rows(report):
    import torch
    from repro_torch.kernels import gpp_matmul as gm
    out = []
    for name, (K, N) in PROJ.items():
        g = torch.Generator(device="cuda").manual_seed(10)
        x = torch.randn(32, K, generator=g, device="cuda").bfloat16()
        w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).bfloat16()
        y4 = gm.gpp_matmul(x[:4], w)
        y20 = gm.gpp_matmul(x[:20], w)[:4]
        y32 = gm.gpp_matmul(x, w)[:4]
        row = {"shape": name, "K": K, "N": N,
               "equal_4_20": bool(torch.equal(y4, y20)),
               "equal_4_32": bool(torch.equal(y4, y32)),
               "max_diff_4_20": float((y4.float() - y20.float()).abs().max()),
               "max_diff_4_32": float((y4.float() - y32.float()).abs().max())}
        out.append(row)
        print(f"gpp_matmul tc {name} {K}x{N}: rows at 4 == at 20: "
              f"{row['equal_4_20']} (max diff {row['max_diff_4_20']:.3g}), "
              f"== at 32: {row['equal_4_32']} (max diff "
              f"{row['max_diff_4_32']:.3g})", flush=True)
    report["gpp_matmul_tc_rows"] = out


def norm_rows(report, draws: int = 200):
    import torch
    from repro_torch.kernels.ref import rmsnorm_ref
    from repro_torch.models.layers import rmsnorm
    out = []
    for width in (512, 1024, 2048):          # kv_norm, qwen, deepseek
        g = torch.Generator(device="cuda").manual_seed(12)
        p = {"scale": (1 + 0.1 * torch.randn(width, generator=g,
                                             device="cuda")).bfloat16()}
        var_diff = plain_diff = kernel_diff = 0
        for _ in range(draws):
            x = (torch.randn(4, 5, width, generator=g, device="cuda")
                 * 2).bfloat16()
            x1 = x[:, :1].contiguous()
            v5 = torch.mean(x.float() ** 2, dim=-1)[:, 0]
            v1 = torch.mean(x1.float() ** 2, dim=-1)[:, 0]
            var_diff += int((v5 != v1).sum())
            plain_diff += int((rmsnorm_ref(x, p["scale"])[:, 0]
                               != rmsnorm_ref(x1, p["scale"])[:, 0])
                              .any(-1).sum())
            kernel_diff += int((rmsnorm(p, x)[:, 0] != rmsnorm(p, x1)[:, 0])
                               .any(-1).sum())
        row = {"width": width, "rows": 4 * draws,
               "mean_differs": var_diff, "plain_output_differs": plain_diff,
               "kernel_output_differs": kernel_diff}
        out.append(row)
        print(f"rmsnorm width {width}: of {4 * draws} lane rows at 1 and 5 "
              f"rows a lane, torch.mean's f32 mean differs in {var_diff}, "
              f"the plain version's bf16 output in {plain_diff}, the "
              f"kernel's (the model's route) in {kernel_diff}", flush=True)
    report["rmsnorm_rows"] = out


@contextlib.contextmanager
def recording():
    """Wrap the model's ops while the block runs.  Yields the list of step
    calls: each decode / verify call of the step functions appends
    {"kind", "positions", "active", "nvalid", "ops": [(op, layer, out)]};
    ops outside those calls (prefill) are not kept."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as lay
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf

    calls, state, saved = [], {"ops": None, "layer": -1}, []

    def patch(module, attr, wrapper):
        fn = getattr(module, attr)
        saved.append((module, attr, fn))
        setattr(module, attr, wrapper(fn))

    def keep(op):
        def wrapper(fn):
            def wrapped(*args, **kw):
                out = fn(*args, **kw)
                if state["ops"] is not None:
                    t = out[0] if isinstance(out, tuple) else out
                    state["ops"].append((op, state["layer"],
                                         t.detach().clone()))
                return out
            return wrapped
        return wrapper

    def block(fn):
        def wrapped(*args, **kw):
            state["layer"] += 1
            out = fn(*args, **kw)
            if state["ops"] is not None:
                state["ops"].append(("block", state["layer"],
                                     out.detach().clone()))
            return out
        return wrapped

    def step(kind):
        def wrapper(fn):
            def wrapped(params, cfg, tokens, caches, tables, positions,
                        active, *rest):
                call = {"kind": kind, "positions": positions.tolist(),
                        "active": active.tolist(), "ops": [],
                        "nvalid": rest[0].tolist() if rest else None}
                calls.append(call)
                state["ops"], state["layer"] = call["ops"], -1
                try:
                    return fn(params, cfg, tokens, caches, tables,
                              positions, active, *rest)
                finally:
                    state["ops"] = None
            return wrapped
        return wrapper

    for module, attr, op in (
            (attn, "dense", "dense"), (lay, "dense", "dense"),
            (moe_mod, "dense", "dense"), (attn, "paged_attn", "paged_attn"),
            (attn, "rmsnorm", "rmsnorm"), (tf, "rmsnorm", "rmsnorm"),
            (moe_mod, "moe_apply", "moe"), (tf, "_logits_head", "logits"),
            (torch, "einsum", "einsum")):
        patch(module, attr, keep(op))
    patch(tf, "_block", block)
    patch(tf, "decode_step_paged", step("decode"))
    patch(tf, "verify_step_paged", step("verify"))
    try:
        yield calls
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


def row_of(t, S: int, lane: int, s: int):
    """Row (lane, s) of an op's output: (B, S, ...) -> [lane, s]; (B*S, ...)
    rows (the MoE's token-major views) -> [lane * S + s]; None for a tensor
    over the lanes' whole context (the plain MLA read's up-projection of
    the gathered latent rows, on the CPU)."""
    if t.dim() >= 2 and t.shape[0] == SLOTS and t.shape[1] == S:
        return t[lane, s]
    if t.shape[0] == SLOTS * S:
        return t[lane * S + s]
    return None


def compare(dec, ver, lanes, s_of):
    """Per op of a decode call and a verify call: are decode row (lane, 0)
    and verify row (lane, s_of(lane)) the same bits, for each lane?  Prints
    the ops that differ; returns (rows, first differing row)."""
    import torch
    S = DRAFT + 1
    if [o[:2] for o in dec["ops"]] != [o[:2] for o in ver["ops"]]:
        raise AssertionError("decode and verify ran different op sequences")
    rows, first = [], None
    for i, ((op, layer, a), (_, _, b)) in enumerate(zip(dec["ops"],
                                                       ver["ops"])):
        pairs = [(row_of(a, 1, ln, 0), row_of(b, S, ln, s_of(ln)))
                 for ln in lanes]
        if any(x is None or y is None for x, y in pairs):
            continue
        eq = all(bool(torch.equal(x, y)) for x, y in pairs)
        diff = max(float((x.float() - y.float()).abs().max())
                   for x, y in pairs)
        rows.append({"i": i, "op": op, "layer": layer, "equal": eq,
                     "max_diff": diff})
        if not eq:
            first = first or rows[-1]
            print(f"  op {i:3d} layer {layer:2d} {op:10s} differs: max "
                  f"diff {diff:.3g}", flush=True)
    print(f"  {len(rows)} ops compared, {sum(not r['equal'] for r in rows)} "
          f"differ; the first: {first}", flush=True)
    return rows, first


def step_rows(report, arch: str, layers: int, dev: str):
    import torch
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf

    cfg = registry.get_config(arch, smoke=dev == "cpu").with_(
        dtype="bfloat16", num_layers=layers)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.serving_params(tf.init_params(cfg, gen, dev), cfg)
    mb = MAX_LEN // BS
    nb = SLOTS * mb + 1
    caches = tf.init_paged_caches(tf.paged_cache_specs(cfg, nb, BS), dev)
    g = torch.Generator(device=dev).manual_seed(1)
    for leaf in _leaves(caches):           # a context already written
        leaf.copy_((torch.randn(leaf.shape, generator=g, device=dev)
                    * 0.5).to(leaf.dtype))
    tables = (torch.arange(1, nb, dtype=torch.int32, device=dev)
              .reshape(SLOTS, mb)).contiguous()
    active = torch.ones(SLOTS, dtype=torch.bool, device=dev)
    S = DRAFT + 1
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, S), generator=g,
                         device=dev)
    out = {}
    for where, positions in POSITIONS.items():
        pos = torch.tensor(positions, dtype=torch.int32, device=dev)
        with recording() as calls:
            tf.decode_step_paged(params, cfg, toks[:, :1], _clone(caches),
                                 tables, pos, active)
            tf.verify_step_paged(params, cfg, toks, _clone(caches), tables,
                                 pos, active,
                                 torch.full((SLOTS,), S, dtype=torch.int32,
                                            device=dev))
        print(f"{arch} ({layers} layers), positions {positions} (verify "
              f"spans {where}):")
        rows, first = compare(calls[0], calls[1], range(SLOTS),
                              lambda ln: 0)
        out[where] = {"positions": positions, "ops": rows,
                      "first_differing": first}
    report["step_rows"] = {"arch": arch, "layers": layers, **out}


def serve_witness(report, arch: str, dev: str):
    import numpy as np
    import torch
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import ServeConfig, make_engine

    cfg = registry.get_config(arch, smoke=dev == "cpu").with_(
        dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = tf.init_params(cfg, gen, dev)
    head = tf._logits_head

    def padded_head(params, cfg, x):
        B, S, D = x.shape
        rows = torch.zeros(1, 32, D, dtype=x.dtype, device=x.device)
        rows[0, :B * S] = x.reshape(B * S, D)
        return head(params, cfg, rows)[0, :B * S].reshape(B, S, -1)

    def run(prompts, speculation):
        engine = make_engine(cfg, params, ServeConfig(
            slots=SLOTS, max_len=MAX_LEN, block_size=BS, prefill_chunk=32,
            speculation=speculation, draft_len=DRAFT, device=dev))
        gaps = {}
        sample = engine._sample

        def recorded(row, req):
            top = np.sort(np.asarray(row, np.float64))[-2:]
            gaps[(req.rid, len(req.produced))] = float(top[1] - top[0])
            return sample(row, req)
        engine._sample = recorded
        rids = [engine.submit(p, max_new_tokens=16) for p in prompts]
        with recording() as calls:
            out = engine.run()
        return [out[r] for r in rids], gaps, rids, calls

    def call_for(calls, lane, pos):
        """The first step call in which lane `lane` computed position
        `pos`, and the row s that did."""
        for c in calls:
            p = c["positions"][lane]
            n = 1 if c["nvalid"] is None else c["nvalid"][lane]
            if c["active"][lane] and p <= pos < p + n:
                return c, pos - p
        return None, None

    rows = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        base = [rng.integers(0, cfg.vocab_size,
                             size=rng.integers(4, 13)).tolist()
                for _ in range(SLOTS)]
        for name in ("port head", "padded head"):
            tf._logits_head = head if name == "port head" else padded_head
            try:
                first, _, _, _ = run(base, False)
                prompts = [p + s + p[-3:] for p, s in zip(base, first)]
                off, g_off, r_off, c_off = run(prompts, False)
                on, g_on, r_on, c_on = run(prompts, True)
            finally:
                tf._logits_head = head
            part = None
            for lane, (a, b) in enumerate(zip(off, on)):
                i = next((j for j, (u, v) in enumerate(zip(a, b)) if u != v),
                         None)
                if i is not None:
                    part = {"lane": lane, "token": i,
                            "gap_off": g_off.get((r_off[lane], i)),
                            "gap_on": g_on.get((r_on[lane], i))}
                    break
            print(f"{arch} seed {seed} {name}: greedy streams spec on == "
                  f"off: {off == on}; first parting {part}; smallest top-2 "
                  f"gap (spec off) {min(g_off.values()):.3g}", flush=True)
            if part is not None and part["token"] > 0:
                # token i is sampled from the row at position
                # len(prompt) + i - 1 (token 0 comes from the prefill)
                lane = part["lane"]
                pos = len(prompts[lane]) + part["token"] - 1
                dec, _ = call_for(c_off, lane, pos)
                ver, s = call_for(c_on, lane, pos)
                part["position"] = pos
                if dec is not None and ver is not None:
                    part["spec_on_call"] = {
                        "kind": ver["kind"], "row": s,
                        "positions": ver["positions"],
                        "active": ver["active"], "nvalid": ver["nvalid"]}
                    print(f"  lane {lane} position {pos}: spec off "
                          f"{dec['kind']} call (positions "
                          f"{dec['positions']}, active {dec['active']}) "
                          f"against spec on {ver['kind']} call (positions "
                          f"{ver['positions']}, nvalid {ver['nvalid']}, "
                          f"active {ver['active']}), row {s}:", flush=True)
                    if dec["kind"] == "decode" and ver["kind"] == "verify":
                        _, part["first_differing_op"] = compare(
                            dec, ver, [lane], lambda ln: s)
            rows.append({"seed": seed, "head": name, "equal": off == on,
                         "first_parting": part,
                         "min_gap_off": min(g_off.values())})
            del c_off, c_on
            if dev == "cuda":
                torch.cuda.empty_cache()
    report["serve_witness"] = rows


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--serve", action="store_true")
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import torch
    report = {}
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("row_invariance_sweep: no CUDA device", file=sys.stderr)
            return 2
        if not (ROOT / "src" / "repro_torch").is_dir():
            print("row_invariance_sweep: run it from a checkout of the repo",
                  file=sys.stderr)
            return 2
        from repro_torch.device import resolve_device
        from repro_torch.kernels import build
        resolve_device("cuda")              # also turns TF32 off
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(report["card"])
        build.build_all()
        gpp_rows(report)
        norm_rows(report)
    step_rows(report, args.arch, args.layers, args.device)
    if args.serve:
        serve_witness(report, args.arch, args.device)
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
