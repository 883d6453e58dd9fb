"""End-to-end training on the PyTorch port: a ~100M-param dense LM trained
for a few hundred steps on the synthetic pipeline, with checkpoint /
resume and the layer streamer's mode selectable.

    PYTHONPATH=src python examples/torch_train_e2e.py --steps 300      # card
    PYTHONPATH=src python examples/torch_train_e2e.py --stream-mode gpp
    PYTHONPATH=src python examples/torch_train_e2e.py --device cpu \\
        --devices 8 --steps 20              # a 4x2 host mesh of gloo ranks

The loss should drop from ~ln(32000)=10.4 toward the synthetic corpus'
Zipfian entropy (~5.4) within a few hundred steps.

By default it trains at world size 1 on the card (the mesh-less train
step).  There, `--stream-mode insitu | naive_pp | gpp` keeps the 10 stacked
layers in pinned host memory and brings each to the card before it runs
(`core.streamer`): gpp through a ring of G buffers, 1/(G-1) of each of the
next G-1 layers a step.  The train step decides that residency
(`launch.steps.streams_from_host`, as in `repro_torch.launch.train`): it
moves the layers there when first handed them, updates them on the card
and writes them back, so every mode trains resident's losses bit for bit.
`--devices N --device cpu` trains on a (N/2, 2) ("data", "model") mesh of N
gloo ranks (more than one card: one NCCL rank a card), where the streamer
gathers the FSDP shards instead.

A checkpoint is labelled with the number of steps it has taken (every 100
steps, and at the end), so a resumed run starts at the first step not yet
taken.  The JAX example labels its mid-run checkpoints one step early.
"""
import argparse
import json
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.streamer import StreamSettings
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import axis_sizes, shard_tree
from repro_torch.launch.mesh import make_cuda_mesh, make_host_mesh, spawn_ranks
from repro_torch.launch.steps import make_train_step, streams_from_host
from repro_torch.models import transformer as tf
from repro_torch.models.layers import map_specs
from repro_torch.optim import adamw

# ~106M params: 10 x (attn 1.6M + mlp 4.9M) + 2 x 640*32000 embeddings
CONFIG_100M = ModelConfig(
    name="repro-100m",
    family="dense",
    d_model=640,
    num_layers=10,
    num_heads=8,
    num_kv_heads=4,
    d_ff=2560,
    vocab_size=32000,
    pattern=("dense",),
    rope_theta=1e4,
)
CKPT_EVERY = 100


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--stream-mode", default="resident",
                    choices=["resident", "insitu", "naive_pp", "gpp"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_e2e"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu only when asked for")
    ap.add_argument("--devices", type=int, default=0,
                    help="ranks to train on (0 or 1: world size 1 in this "
                         "process)")
    return ap.parse_args(argv)


def _train(args, cfg, rank: int, mesh) -> dict:
    """The loop on one rank (`mesh` None: the mesh-less step)."""
    dev = resolve_device(args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    shape = ShapeConfig("e2e", args.seq, args.batch, "train")
    sizes = []
    map_specs(lambda _, s: sizes.append(math.prod(s.shape)),
              tf.param_specs(cfg))
    host = mesh is None and streams_from_host(cfg, dev)
    where = (axis_sizes(mesh) if mesh is not None
             else f"none (world size 1, {dev}"
             + (", layers in pinned host memory)" if host else ")"))
    say(f"params: {sum(sizes)/1e6:.1f}M  mesh: {where}  "
        f"stream: {args.stream_mode}")

    optc = adamw.AdamWConfig()
    if mesh is None:
        bundle = make_train_step(cfg, optc=optc)
        specs = None
    else:
        bundle = make_train_step(cfg, mesh, shape, optc=optc)
        specs = {"p": bundle.arg_specs[0], "o": bundle.arg_specs[1]}
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    opt_state = adamw.adamw_init(params)
    if specs is not None:
        params = shard_tree(params, specs["p"], mesh)
        opt_state = shard_tree(opt_state, specs["o"], mesh)

    mgr = CheckpointManager(args.ckpt_dir)
    start = 0
    if mgr.latest_step() is not None:
        state, start = mgr.restore({"p": params, "o": opt_state},
                                   shardings=specs, mesh=mesh)
        params, opt_state = state["p"], state["o"]
        say(f"resumed at step {start}")

    pipe = TokenPipeline(cfg, DataConfig(batch=args.batch,
                                         seq_len=args.seq)).start(start)
    losses = []
    t0 = time.perf_counter()
    try:
        for step in range(start, args.steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(pipe).items()}
            if specs is not None:
                batch = shard_tree(batch, bundle.arg_specs[2], mesh)
            params, opt_state, metrics = bundle.fn(params, opt_state, batch,
                                                   step)
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % 20 == 0 or step == args.steps - 1:
                say(f"step {step:4d}  loss {loss:7.4f}")
            done = step + 1
            if done % CKPT_EVERY == 0 and done < args.steps:
                mgr.save(done, {"p": params, "o": opt_state}, blocking=False,
                         specs=specs, mesh=mesh)
    finally:
        pipe.stop()
        mgr.wait()
    seconds = time.perf_counter() - t0
    mgr.save(args.steps, {"p": params, "o": opt_state}, specs=specs,
             mesh=mesh)
    if not losses:
        raise SystemExit(f"nothing to train: resumed at step {start} of "
                         f"{args.steps}")
    say(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training must reduce loss"
    return {"params": sum(sizes), "start": start, "losses": losses,
            "seconds": seconds,
            "tok_s": len(losses) * args.batch * args.seq / seconds,
            "checkpoint": mgr.latest_step()}


def _rank(rank, world, args, cfg, out_path):
    mesh_shape = (max(1, world // 2), 2)
    mesh = (make_host_mesh(*mesh_shape) if args.device == "cpu"
            else make_cuda_mesh(*mesh_shape))
    res = _train(args, cfg, rank, mesh)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


def run(args: argparse.Namespace, cfg: ModelConfig = CONFIG_100M) -> dict:
    """Train as `args` say (`parse_args`); returns {"params", "start": the
    step it resumed at, "losses": one a step taken, "seconds" and "tok_s"
    of the loop, "checkpoint": the latest step saved}."""
    cfg = cfg.with_(stream=StreamSettings(
        mode=args.stream_mode, ring_depth=cfg.stream.ring_depth))
    if args.devices <= 1:
        return _train(args, cfg, 0, None)
    backend = "gloo" if args.device == "cpu" else "nccl"
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rank0.json")
        spawn_ranks(_rank, args.devices, args, cfg, out, backend=backend,
                    threads=1 if backend == "gloo" else 0)
        with open(out) as f:
            return json.load(f)


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
