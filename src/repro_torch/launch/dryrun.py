"""Multi-pod dry run (the port's copy of `repro.launch.dryrun`): run every
(arch x input-shape x mesh) cell's step once on the meta device and record
what one card of the mesh would hold and do.

    python -m repro_torch.launch.dryrun            # every cell, both meshes
    python -m repro_torch.launch.dryrun --arch kimi-k2-1t-a32b --shape train_4k
    python -m repro_torch.launch.dryrun --multi-pod-only   # the 512 cards
    python -m repro_torch.launch.dryrun --out results/dryrun.json

The reference compiles each cell for 512 forced host devices and reads the
compiled artifact.  Here one process is rank 0 of a fake process group of
256 or 512 ranks (`launch.mesh.fake_mesh`), builds the cell's step with
`launch.steps.make_step`, makes rank 0's arguments as meta tensors at
their local shapes, and runs the step once under `roofline.count`: FLOPs,
bytes and collectives as rank 0 issues them (every rank of these meshes
does the same work), backward and recomputation included.  The fake group
starts in this process and becomes its default group, so run the module
in a process of its own (it raises if a group is up already).  Then
`python -m repro_torch.launch.report OUT` prints the roofline table.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      cells_for)
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.dist import sharding as shd
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fake_mesh, production_layout
from repro_torch.launch.steps import make_step
from repro_torch.models import registry
from repro_torch.models import transformer as tf
from repro_torch.models.layers import map_specs
from repro_torch.optim import adafactor as adaf
from repro_torch.optim import adamw


def _meta(_, s):
    return torch.empty(s.shape, dtype=s.dtype, device="meta")


def _local(specs, arg_spec, mesh):
    """Rank 0's pieces, on meta, of the whole leaves that `specs` (a tree
    of `layers.Spec`) describes, cut as `arg_spec` says."""
    return shd.shard_tree(map_specs(_meta, specs), arg_spec, mesh)


def step_args(cfg: ModelConfig, shape: ShapeConfig, bundle, mesh) -> tuple:
    """The step's arguments for rank 0 of `mesh`, as meta tensors at their
    local shapes: the parameters' pieces; for a train step the optimizer
    state of `cfg.optimizer` (Adafactor's factors, AdamW's moments), the
    batch and step 0; for prefill the batch; for decode one token a row,
    the caches at `shape.seq_len` and the last position (and the encoder
    embeddings of a cross layer)."""
    specs = bundle.arg_specs
    cfg = bundle.meta.get("cfg", cfg)         # decode may switch MoE serving
    pspecs = tf.param_specs(cfg)
    params = _local(pspecs, specs[0], mesh)
    B, S = shape.global_batch, shape.seq_len
    batch = make_batch_specs(cfg, B, S, dtype=cfg.dtype)
    if shape.kind == "train":
        state = (adaf.adafactor_state_specs(pspecs)
                 if cfg.optimizer == "adafactor"
                 else adamw.adamw_state_specs(pspecs))
        return (params, _local(state, specs[1], mesh),
                _local(batch, specs[2], mesh), 0)
    if shape.kind == "prefill":
        batch.pop("labels")
        return params, _local(batch, specs[1], mesh)
    key = "tokens" if cfg.input_mode == "tokens" else "embeds"
    tok = batch[key]._replace(shape=(B, 1, *batch[key].shape[2:]))
    args = (params, _local(tok, specs[1], mesh),
            _local(tf.cache_specs(cfg, B, S), specs[2], mesh), S - 1)
    if cfg.encoder_tokens:
        args += (_local(batch["enc"], specs[4], mesh),)
    return args


def replaced_bytes(kind: str, out) -> int:
    """Bytes of the outputs that replace an input: the parameters and the
    optimizer state of a train step, the caches of a decode step."""
    if kind == "train":
        return rl.tensor_bytes(out[:2])
    if kind == "decode":
        return rl.tensor_bytes(out[1])
    return 0


def count_step(fn, args: tuple, kind: str) -> dict:
    """Run the `kind` step `fn(*args)` once under `roofline.count` and give
    the record's counts, a card's:

      argument_bytes  the arguments (read once)
      param_bytes     the parameters' pieces (every step's first argument)
      output_bytes    the outputs (written once)
      bytes_per_device  argument_bytes + output_bytes: the memory term's
                      lower bound (the reference's `cost_analysis` bytes)
      bytes_per_device_loop_aware  the output bytes of every op but views:
                      its upper bound
      dot_bytes_per_device_loop_aware  operand + output bytes of every
                      product (the report's memory term)
      alias_bytes     the outputs that replace an input
                      (`replaced_bytes`)
      temp_bytes      the peak of the bytes the step allocates, above the
                      arguments, less the outputs that replace none
                      (output_bytes - alias_bytes), so that the
                      reference's arguments + temp + output - alias is the
                      card's peak: the arguments, which the caller holds
                      throughout, plus the peak of what the step allocates
      hbm_bytes, fits  that peak, and whether it is at most
                      `roofline.HBM_BYTES`
    """
    out, c = rl.count(fn, *args)
    arg_b, out_b = rl.tensor_bytes(args), rl.tensor_bytes(out)
    alias_b = replaced_bytes(kind, out)
    temp_b = c["peak_bytes"] - (out_b - alias_b)
    hbm = arg_b + temp_b + out_b - alias_b
    colls = c["collectives"]
    coll_b = sum(v["bytes"] for v in colls.values())
    return dict(
        flops_per_device=c["flops"],
        flops_per_device_loop_aware=c["flops"],
        dot_coverage=round(c["dot_coverage"], 4),
        bytes_per_device=float(arg_b + out_b),
        bytes_per_device_loop_aware=c["out_bytes"],
        dot_bytes_per_device_loop_aware=c["dot_bytes"],
        argument_bytes=arg_b, param_bytes=rl.tensor_bytes(args[0]),
        output_bytes=out_b, temp_bytes=temp_b,
        alias_bytes=alias_b, hbm_bytes=hbm, fits=hbm <= rl.HBM_BYTES,
        collectives={k: dict(v) for k, v in colls.items()},
        collective_bytes_per_device=coll_b,
        collectives_loop_aware={k: dict(v) for k, v in colls.items()},
        collective_bytes_per_device_loop_aware=coll_b)


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             stream_mode: "str | None" = None, verbose: bool = True,
             cfg: "ModelConfig | None" = None,
             shape: "ShapeConfig | None" = None, layout=None) -> dict:
    """One cell's record (the reference's keys where their meaning
    carries, `count_step`'s fields, `count_s` in place of its lower /
    compile seconds).  A cell that raises is recorded with its error and
    traceback (ok False).  `cfg`, `shape` and `layout` (shape, dim names)
    stand in for the registry's config, `SHAPES[shape_name]` and the
    production mesh (the tests' small cells)."""
    cfg = cfg or registry.get_config(arch)
    if stream_mode:
        from repro_torch.core.streamer import StreamSettings
        cfg = cfg.with_(stream=StreamSettings(
            mode=stream_mode, ring_depth=cfg.stream.ring_depth))
    shape = shape or SHAPES[shape_name]
    dims, names = layout or production_layout(multi_pod)
    rec = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": "x".join(map(str, dims)),
        "stream_mode": cfg.stream.mode,
        "ok": False,
    }
    t0 = time.time()
    try:
        with fake_mesh(dims, names) as mesh:
            bundle = make_step(cfg, mesh, shape)
            args = step_args(cfg, shape, bundle, mesh)
            rec.update(count_step(bundle.fn, args, shape.kind))
        rec["ok"] = True
        rec["count_s"] = round(time.time() - t0, 2)
        if verbose:
            print(f"  ok  count={rec['count_s']:6.1f}s "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"hbm/dev={rec['hbm_bytes'] / 2**30:6.2f}GiB"
                  f"{'' if rec['fits'] else ' (does not fit)'} "
                  f"coll/dev={rec['collective_bytes_per_device'] / 2**30:7.3f}"
                  f"GiB", flush=True)
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["count_s"] = round(time.time() - t0, 2)
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"  FAIL {type(e).__name__}: {str(e)[:200]}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch (default: all)")
    ap.add_argument("--shape", default=None,
                    help="single shape (default: assigned)")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--stream-mode", default=None,
                    choices=["resident", "insitu", "naive_pp", "gpp"])
    ap.add_argument("--out", default="results/dryrun.json")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(registry.ARCH_NAMES)
    meshes = []
    if not args.multi_pod_only:
        meshes.append(False)
    if not args.single_pod_only:
        meshes.append(True)

    results = []
    for arch in archs:
        cfg = registry.get_config(arch)
        shapes = [args.shape] if args.shape else cells_for(cfg)
        for shape_name in shapes:
            for mp in meshes:
                mesh = "2x16x16" if mp else "16x16"
                mode = f" x {args.stream_mode}" if args.stream_mode else ""
                print(f"[{arch} x {shape_name} x {mesh}{mode}]", flush=True)
                results.append(run_cell(arch, shape_name, mp,
                                        stream_mode=args.stream_mode))

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    existing = []
    if os.environ.get("DRYRUN_APPEND") and os.path.exists(args.out):
        with open(args.out) as f:
            existing = json.load(f)
    with open(args.out, "w") as f:
        json.dump(existing + results, f, indent=1)
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} cells counted; results -> {args.out}")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
