"""Quickstart on the PyTorch port: train a tiny model for a few steps, then
generate from it.

    PYTHONPATH=src python examples/torch_quickstart.py                # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \\
        --devices 4                                     # 2x2 mesh, 4 ranks

qwen1.5-0.5b at its SMOKE widths trains 10 steps (8 x 64 tokens of the
synthetic pipeline), then decodes 8 tokens greedily from [1, 5, 42, 7].
By default it runs at world size 1 on the card (the mesh-less train step);
`--devices 4 --device cpu` runs the JAX example's 2x2 ("data", "model")
host mesh as 4 gloo ranks, and rank 0 generates from the parameters
gathered whole.  The train step updates the parameters and the optimizer
state in place (it donates them), so the loop rebinds them every step.
"""
import argparse
import json
import os
import tempfile

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import gather_tree, shard_tree
from repro_torch.launch.mesh import make_host_mesh, spawn_ranks
from repro_torch.launch.steps import make_train_step
from repro_torch.models import registry
from repro_torch.models import transformer as tf
from repro_torch.models.layers import tree_map
from repro_torch.optim import adamw

PROMPT = [1, 5, 42, 7]
SHAPE = ShapeConfig("quickstart", seq_len=64, global_batch=8, kind="train")


def _generate(params, cfg, dev) -> "tuple[list, list]":
    """8 greedy tokens after PROMPT, and each pick's lead over the runner-up
    logit."""
    toks, gaps = [], []

    def pick(logits):
        top = torch.topk(logits[0, -1].float(), 2)
        toks.append(int(top.indices[0]))
        gaps.append(float(top.values[0] - top.values[1]))

    with torch.no_grad():
        prompt = torch.tensor([PROMPT], dtype=torch.int32, device=dev)
        logits, caches = tf.prefill(params, cfg, {"tokens": prompt},
                                    max_len=32)
        pick(logits)
        for pos in range(len(PROMPT), len(PROMPT) + 8):
            tok = torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev)
            logits, caches = tf.decode_step(params, cfg, tok, caches, pos)
            pick(logits)
    return toks, gaps


def _train(cfg, dev, params, mesh=None, say=print) -> dict:
    """10 steps and the greedy tokens; on a mesh every rank calls it and
    rank 0's result counts."""
    if params is None:
        params = tf.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    else:                        # the step consumes what it is given
        params = tree_map(lambda t: t.to(dev, copy=True), params)
    opt_state = adamw.adamw_init(params)
    if mesh is None:
        bundle = make_train_step(cfg, optc=adamw.AdamWConfig())
    else:
        bundle = make_train_step(cfg, mesh, SHAPE, optc=adamw.AdamWConfig())
        params = shard_tree(params, bundle.arg_specs[0], mesh)
        opt_state = shard_tree(opt_state, bundle.arg_specs[1], mesh)
    pipe = TokenPipeline(cfg, DataConfig(batch=SHAPE.global_batch,
                                         seq_len=SHAPE.seq_len))
    losses = []
    for step in range(10):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(step).items()}
        if mesh is not None:
            batch = shard_tree(batch, bundle.arg_specs[2], mesh)
        params, opt_state, metrics = bundle.fn(params, opt_state, batch,
                                               step)
        losses.append(float(metrics["loss"]))
        say(f"step {step}: loss {losses[-1]:.4f}")

    # generate a few tokens greedily
    if mesh is not None:
        params = gather_tree(params, bundle.arg_specs[0], mesh)
    toks, gaps = _generate(params, cfg, dev)
    say("generated:", toks)
    return {"losses": losses, "generated": toks, "gaps": gaps}


def _rank(rank, world, params, out_path):
    cfg = registry.get_config("qwen1.5-0.5b", smoke=True)
    say = print if rank == 0 else (lambda *a, **k: None)
    res = _train(cfg, torch.device("cpu"), params, make_host_mesh(2, 2), say)
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


def run(device: str = "cuda", devices: int = 0, params=None) -> dict:
    """Train and generate; returns {"losses": the 10 losses, "generated":
    the greedy tokens, "gaps": each pick's lead over the runner-up logit}.
    `params`: starting parameters (a tree of tensors) in place of the
    seed-0 initialisation.  `devices` 4 (with device "cpu"): the 2x2 host
    mesh on 4 gloo ranks; 0 or 1: world size 1 in this process."""
    dev = resolve_device(device)
    cfg = registry.get_config("qwen1.5-0.5b", smoke=True)
    if devices in (0, 1):
        return _train(cfg, dev, params)
    if devices != 4 or dev.type != "cpu":
        raise ValueError("the quickstart's mesh is 2x2 host ranks: "
                         "--devices 4 --device cpu")
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rank0.json")
        spawn_ranks(_rank, 4, params, out)
        with open(out) as f:
            return json.load(f)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu only when asked for")
    ap.add_argument("--devices", type=int, default=0,
                    help="4: the 2x2 host mesh on gloo ranks (--device "
                         "cpu); 0: world size 1 in this process")
    args = ap.parse_args(argv)
    return run(args.device, args.devices)


if __name__ == "__main__":
    main()
