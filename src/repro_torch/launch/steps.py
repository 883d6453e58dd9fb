"""The train step (the port's copy of `repro.launch.steps.make_train_step`)
at world size 1, with no mesh; with `cfg.stream.mode` other than
"resident" its loss streams the superblocks through the layer streamer
(`stream_specs`, the reference's `_stream_pspecs`).  The reference's
shardings and its serve-step builders come with the sharded steps
(ROADMAP §1.8b).

    bundle = make_train_step(cfg, optc)
    params, opt_state, metrics = bundle.fn(params, opt_state, batch, step)

`batch` holds tensors on the parameters' device ("tokens" or "embeds",
"labels", and "enc" for cross layers); `metrics` holds 0-d tensors "loss",
"grad_norm" and "lr".  The step computes the loss and its gradient
(`transformer.loss_fn`, block remat as `cfg.remat` says), the learning
rate `cosine_lr(step, peak=optc.lr, warmup=200, total=10_000)`, and one
AdamW step, or one Adafactor step at `AdafactorConfig(lr=optc.lr)` when
`cfg.optimizer == "adafactor"`.  Like the reference's jitted step it
returns new trees; the caller drops the old ones.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import adafactor as adaf
from repro_torch.optim import adamw as opt


@dataclasses.dataclass
class StepBundle:
    fn: Any                      # (params, opt_state, batch, step) -> ...


def stream_specs(cfg: ModelConfig, mesh=None,
                 rules: "shd.ShardRules | None" = None):
    """(shard_specs, full_specs) for ONE superblock's leaves, the
    streamer's arguments (a shared block is not streamed)."""
    rules = rules or shd.ShardRules()
    one = {f"b{i}": tf.block_specs(cfg, k)
           for i, k in enumerate(cfg.pattern) if not tf._is_shared(k)}
    return (shd.sharded_pspecs_one_layer(one, mesh, rules),
            shd.gathered_pspecs(one, mesh, rules))


def value_and_grad(cfg: ModelConfig, params, batch, mesh=None,
                   shard_specs=None, full_specs=None):
    """(loss, grads): `transformer.loss_fn` and its gradient for every
    parameter leaf, in the tree's layout and each leaf's dtype; zeros for
    a leaf the loss does not read (a serving copy of the head's table,
    `transformer.serving_params`), as JAX gives.  The specs stream the
    superblocks as `cfg.stream` says."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = tf.loss_fn(live, cfg, batch, mesh, shard_specs, full_specs)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live),
                                     allow_unused=True))
    return loss.detach(), tree_map(
        lambda p: torch.zeros_like(p) if (g := next(grads)) is None else g,
        live)


def make_train_step(cfg: ModelConfig,
                    optc: "opt.AdamWConfig | None" = None) -> StepBundle:
    optc = optc or opt.AdamWConfig()
    adafactor = cfg.optimizer == "adafactor"

    specs = (stream_specs(cfg) if cfg.stream.mode != "resident"
             else (None, None))

    def train_step(params, opt_state, batch, step):
        loss, grads = value_and_grad(cfg, params, batch, None, *specs)
        lr = opt.cosine_lr(step, peak=optc.lr, warmup=200, total=10_000)
        if adafactor:
            params, opt_state, metrics = adaf.adafactor_update(
                adaf.AdafactorConfig(lr=optc.lr), grads, opt_state, params,
                lr=lr)
        else:
            params, opt_state, metrics = opt.adamw_update(
                optc, grads, opt_state, params, lr=lr)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return StepBundle(train_step)
