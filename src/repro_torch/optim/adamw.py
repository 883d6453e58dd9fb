"""AdamW with global-norm clipping and a cosine schedule (the port's copy of
`repro.optim.adamw`), on trees of tensors (nested dicts / lists).

The reference's choices are kept: moments are f32 whatever the parameter
dtype, `count` is an int32 scalar, the update runs in f32 and is cast to
the parameter's dtype, and weight decay applies to every leaf, norms and
biases included.  `compress="bf16"` rounds the gradients to bf16 first
(the reference does so before its gradient all-reduce; the port's steps
all-reduce after the update's input is made, so only the rounding
remains).  The train steps donate the parameters and the state to the
update (`donate=True`), which writes them in place; by default it copies
them first and leaves the ones it was given as they were.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.dist.collectives import all_reduce, current
from repro_torch.dist.sharding import leaf_axes
from repro_torch.models.layers import (Spec, map_specs, tree_leaves,
                                       tree_map)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress: "str | None" = None     # None | "bf16" gradient compression


def adamw_init(params):
    """Moment state (f32, on each parameter's device) shaped like params;
    count is an int32 scalar."""
    dev = tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_state_specs(param_specs):
    def f32(_, s: Spec):
        return Spec(s.shape, torch.float32)
    return {"mu": map_specs(f32, param_specs),
            "nu": map_specs(f32, param_specs),
            "count": Spec((), torch.int32)}


def global_norm(tree, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(leaf^2), in f32.  On the ambient
    mesh with `specs` (the leaves' pieces): each leaf's sum over its piece
    is all-reduced over the axes it is split on (`sharding.leaf_axes`) and
    nowhere else, so a replicated leaf counts once."""
    par = current()
    if specs is None or par is None:
        return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                              for leaf in tree_leaves(tree)))

    def one(leaf, spec):
        x = torch.sum(torch.square(leaf.float()))
        axes = leaf_axes(spec)
        return all_reduce(x, par, axes) if axes else x
    return torch.sqrt(sum(tree_leaves(tree_map(one, tree, specs))))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state, params, lr=None,
                 specs=None, donate: bool = False):
    """Returns (params, state, metrics {"grad_norm", "lr"}).  With `donate`
    the parameters and the state are consumed, as the reference's train
    step's `donate_argnums` consumes them: each leaf is updated in its own
    storage, one leaf at a time, and the trees given come back.  Without,
    they are copied first and left as they were.  The arithmetic is the
    reference's, written into the leaves op for op (no fused form), so both
    give the same bits.  `specs`: the leaves' pieces on the ambient mesh
    (`global_norm`)."""
    if not donate:
        params, state = tree_map(torch.clone, (params, state))
    if cfg.compress == "bf16":
        grads = tree_map(lambda g: g.to(torch.bfloat16), grads)

    gnorm = global_norm(grads, specs)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    count = state["count"].add_(1)
    b1c = 1.0 - torch.pow(cfg.b1, count.float())
    b2c = 1.0 - torch.pow(cfg.b2, count.float())
    lr_t = torch.as_tensor(cfg.lr if lr is None else lr,
                           dtype=torch.float32, device=count.device)

    def upd(p, m, v, g):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)          # b1 m + (1 - b1) g
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)      # b2 v + (1 - b2) g g
        pf = p.float()
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * pf
        p.copy_(pf - lr_t * step)

    tree_map(upd, params, state["mu"], state["nu"], grads)
    return params, state, {"grad_norm": gnorm, "lr": lr_t}


def cosine_lr(step, *, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> torch.Tensor:
    """Linear warm-up to `peak` over `warmup` steps, then a cosine down to
    floor_frac x peak at `total`, in f32 (a 0-d tensor on step's device,
    the CPU for a Python int)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak * s / max(1, warmup)
    prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = peak * (floor_frac + (1 - floor_frac) * 0.5
                  * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
