"""Train / prefill / decode steps, with or without a mesh (the port's copy of
`repro.launch.steps`).

    bundle = make_step(cfg, mesh, shape)          # or make_train_step ...
    params, opt_state, metrics = bundle.fn(params, opt_state, batch, step)
    logits, caches = bundle.fn(params, batch)                    # prefill
    logits, caches = bundle.fn(params, tokens, caches, pos)      # decode

The reference hands its jitted steps in / out shardings; here each rank
holds the local piece of every argument that the bundle's `arg_specs`
name (`dist.sharding.shard_tree` cuts them from whole trees, `gather_tree`
puts them back), and the step runs inside the ambient mesh
(`dist.collectives.on_mesh`) with the collectives written out: ZeRO-3
gathers of the layers, the tensor-parallel forms of the blocks, the MoE
shard maps, and, in the train step, the gradients all-reduced over each
dp axis a leaf is whole on (the loss of a rank's rows over dp, so the sum
is the mean), while an FSDP leaf's gradient comes back reduce-scattered
over its FSDP axes by its gather's backward.  The dp axes are "data", or
("pod", "data") on a multi-pod mesh, which also carries the kimi-scale
FSDP rule over both (`_rules_for`).  `mesh` is a DeviceMesh
(`launch.mesh`); `mesh=None` gives the mesh-less train step at world size
1, with no collectives at all.

The train step computes the loss and its gradient (`transformer.loss_fn`,
block remat as `cfg.remat` says), the learning rate `cosine_lr(step,
peak=optc.lr, warmup=200, total=10_000)`, and one AdamW step (its global
norm over the mesh, `optim.adamw.global_norm`), or one Adafactor step at
`AdafactorConfig(lr=optc.lr)` when `cfg.optimizer == "adafactor"` (on a
mesh its factors whole on every rank, as the reference's specs keep them,
and its means taken over the whole leaves, `optim.adafactor`).  `batch`
holds tensors on the parameters' device ("tokens" or "embeds", "labels",
and "enc" for cross layers); `metrics` holds 0-d tensors "loss" (the mean
over every rank's rows), "grad_norm" and "lr".  The prefill and decode
steps return the logits of the rank's rows and its pieces of the caches
(`cache_pspecs`).

A step consumes what the reference's jitted step donates
(`donate_argnums`): the train step updates the parameters and the
optimizer state in their own storage, and the decode step writes the
caches in theirs; each returns the trees it was given.  A caller that
still needs the old values keeps a copy (`layers.tree_map(torch.clone,
...)`) before the call.  The mesh-less train step with a streamed mode on
a CUDA device also moves the superblocks to pinned host memory and returns
them there (`streams_from_host`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import all_reduce, on_mesh, take
from repro_torch.launch.mesh import dp_axes
from repro_torch.models import transformer as tf
from repro_torch.models.layers import map_specs, tree_leaves, tree_map
from repro_torch.optim import adafactor as adaf
from repro_torch.optim import adamw as opt


@dataclasses.dataclass
class StepBundle:
    """A step function, the spec trees of its arguments and what else the
    builder knows.  `fn` consumes the arguments the reference donates (the
    train step's parameters and optimizer state, the decode step's
    caches): it updates them in place and returns them."""
    fn: Any                      # the step function
    arg_specs: tuple = ()        # spec trees of its arguments, in order
    meta: dict = dataclasses.field(default_factory=dict)


HBM_RESIDENT_BUDGET = 6e9  # bytes of TP-sharded weights we allow resident


def _rules_for(cfg: ModelConfig, mesh, serve: bool = False) -> shd.ShardRules:
    """The reference's rules: ZeRO-3 over ("pod", "data") only when the
    params cannot afford pod replication (1T-class models), else over
    "data"; serving keeps the weights resident (TP only) when they fit."""
    sizes = shd.axis_sizes(mesh)
    fsdp_axes = ("data",)
    tp = sizes.get("model", 1)
    if "pod" in sizes:
        per_dev_replicated = cfg.total_params() * 2 / (16 * tp)
        if per_dev_replicated > 4e9:
            fsdp_axes = ("pod", "data")
    fsdp = True
    if serve and cfg.total_params() * 2 / tp < HBM_RESIDENT_BUDGET:
        fsdp = False
    return shd.ShardRules(
        tp_axis="model",
        fsdp_axes=fsdp_axes,
        dp_axes=dp_axes(sizes),
        fsdp=fsdp,
        moe_ep_mode=cfg.moe_ep_mode if cfg.num_experts else "tp",
        moe_serve_resident=bool(serve and cfg.moe_serve_resident),
    )


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
                   shard_specs=None, full_specs=None, specs=None,
                   scale: float = 1.0):
    """(loss, grads): `transformer.loss_fn` and the gradient of loss x
    `scale` for every parameter leaf, in the tree's layout and each leaf's
    dtype; zeros for a leaf the loss does not read (a serving copy of the
    head's table, `transformer.serving_params`), as JAX gives.  The specs
    stream the superblocks as `cfg.stream` says, and `specs` runs the
    rank's pieces on the ambient mesh."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = tf.loss_fn(live, cfg, batch, mesh, shard_specs, full_specs,
                      specs)
    grads = iter(torch.autograd.grad(loss * scale if scale != 1.0 else loss,
                                     tree_leaves(live), allow_unused=True))
    return loss.detach(), tree_map(
        lambda p: torch.zeros_like(p) if (g := next(grads)) is None else g,
        live)


def _dp(mesh, rules: shd.ShardRules) -> "tuple[Any, int]":
    """(the dp spec entry, the dp size)."""
    sizes = shd.axis_sizes(mesh)
    n = 1
    for a in rules.dp_axes:
        n *= sizes.get(a, 1)
    return shd._axes_entry(rules.dp_axes) if rules.dp_axes else None, n


def _batch_pspecs(batch_specs: dict, bdim) -> dict:
    return {k: (bdim, *([None] * (len(v.shape) - 1)))
            for k, v in batch_specs.items()}


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

def make_train_step(cfg: ModelConfig, mesh=None,
                    shape: "ShapeConfig | None" = None,
                    optc: "opt.AdamWConfig | None" = None,
                    rules: "shd.ShardRules | None" = None) -> StepBundle:
    """The train step; `rules` (default `_rules_for`) places the leaves on
    the mesh."""
    optc = optc or opt.AdamWConfig()
    adafactor = cfg.optimizer == "adafactor"
    if mesh is None:
        return _train_step_one(cfg, optc, adafactor)
    rules = rules or _rules_for(cfg, mesh)
    pspecs = tf.param_specs(cfg)
    p_psp = shd.param_pspecs(pspecs, mesh, rules)
    if adafactor:
        opt_psp = {"factors": map_specs(
            lambda _, s: (None,) * len(s.shape),
            adaf.adafactor_state_specs(pspecs)["factors"]), "count": ()}
    else:
        opt_psp = {"mu": p_psp, "nu": p_psp, "count": ()}
    dp_entry, dp_size = _dp(mesh, rules)
    batch_specs = make_batch_specs(cfg, shape.global_batch, shape.seq_len,
                                   dtype=cfg.dtype)
    b_psp = _batch_pspecs(batch_specs, dp_entry)
    streamed = cfg.stream.mode != "resident"
    specs = stream_specs(cfg, mesh, rules) if streamed else (None, None)

    def loss_and_grads(params, batch):
        """(the mean loss over every rank's rows, the rank's pieces of the
        gradient), as the step computes them."""
        with on_mesh(mesh, rules) as par:
            axes = shd.entry_axes(par.dp_axis)
            loss, grads = value_and_grad(
                cfg, params, batch, mesh, *specs, specs=p_psp,
                scale=1.0 / par.dp)

            def dp_sum(g, s):
                # the rank-rows gradients summed over each dp axis the leaf
                # is whole on; over its FSDP axes they came back
                # reduce-scattered
                rest = tuple(a for a in axes if a not in shd.leaf_axes(s))
                return all_reduce(g, par, rest) if rest else g
            grads = tree_map(dp_sum, grads, p_psp)
            loss = all_reduce(loss, par, axes)
            return (loss / par.dp if par.dp > 1 else loss), grads

    def train_step(params, opt_state, batch, step):
        loss, grads = loss_and_grads(params, batch)
        with on_mesh(mesh, rules):
            lr = opt.cosine_lr(step, peak=optc.lr, warmup=200, total=10_000)
            if adafactor:
                params, opt_state, metrics = adaf.adafactor_update(
                    adaf.AdafactorConfig(lr=optc.lr), grads, opt_state,
                    params, lr=lr, specs=p_psp, donate=True)
            else:
                params, opt_state, metrics = opt.adamw_update(
                    optc, grads, opt_state, params, lr=lr, specs=p_psp,
                    donate=True)
            metrics["loss"] = loss
            return params, opt_state, metrics

    return StepBundle(train_step, (p_psp, opt_psp, b_psp, ()),
                      meta={"rules": rules, "param_pspecs": p_psp,
                            "dp_size": dp_size,
                            "loss_and_grads": loss_and_grads})


def streams_from_host(cfg: ModelConfig, device) -> bool:
    """Whether the mesh-less train step keeps the superblocks' stacked
    leaves in pinned host memory: a streamed mode on a CUDA device."""
    return (cfg.stream.mode != "resident"
            and torch.device(device).type == "cuda")


def _pinned(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)


def _train_step_one(cfg: ModelConfig, optc, adafactor: bool) -> StepBundle:
    """The mesh-less train step (world size 1, no collectives).  With a
    streamed mode on a CUDA device (`streams_from_host`) the superblocks'
    stacked leaves rest in pinned host memory, moved there the first time
    the step is handed them on the card: the streamer fetches each layer
    from there (`core.streamer`, "host memory"), and the optimizer updates
    them, with their gradients, on the card and writes them back, so the
    step gives resident's bits.  The optimizer state stays on the card."""
    streamed = cfg.stream.mode != "resident"
    specs = stream_specs(cfg) if streamed else (None, None)

    def train_step(params, opt_state, batch, step):
        dev = opt_state["count"].device
        host = None
        if streamed and streams_from_host(cfg, dev):
            if tree_leaves(params["blocks"])[0].is_cuda:
                params = {**params,
                          "blocks": tree_map(_pinned, params["blocks"])}
            host = params["blocks"]
        loss, grads = value_and_grad(cfg, params, batch, None, *specs)
        if host is not None:
            params = {**params, "blocks": tree_map(
                lambda t: t.to(dev, non_blocking=True), host)}
            grads = {**grads, "blocks": tree_map(lambda g: g.to(dev),
                                                 grads["blocks"])}
        lr = opt.cosine_lr(step, peak=optc.lr, warmup=200, total=10_000)
        if adafactor:
            params, opt_state, metrics = adaf.adafactor_update(
                adaf.AdafactorConfig(lr=optc.lr), grads, opt_state, params,
                lr=lr, donate=True)
        else:
            params, opt_state, metrics = opt.adamw_update(
                optc, grads, opt_state, params, lr=lr, donate=True)
        if host is not None:
            tree_map(lambda h, t: h.copy_(t), host, params["blocks"])
            params = {**params, "blocks": host}
        metrics["loss"] = loss
        return params, opt_state, metrics

    return StepBundle(train_step)


# ---------------------------------------------------------------------------
# serve steps (prefill / decode)
# ---------------------------------------------------------------------------

def _relayout(tree, have, want, par):
    """Each leaf of `tree` moved from its layout in `have` to `want`."""
    return shd.map_spec_tree(lambda w, h, t: take(t, h, w, par), want, have,
                             tree)


def make_prefill_step(cfg: ModelConfig, mesh, shape: ShapeConfig) -> StepBundle:
    """The prompt at once: (logits of the rank's rows (B_l, 1, vocab) f32,
    the rank's pieces of the caches).  The batch goes over dp when it
    divides it; otherwise every dp rank runs every row, and the caches are
    cut on their sequence dim (`cache_pspecs`)."""
    rules = _rules_for(cfg, mesh, serve=True)
    p_psp = shd.param_pspecs(tf.param_specs(cfg), mesh, rules)
    batch_specs = make_batch_specs(cfg, shape.global_batch, shape.seq_len,
                                   dtype=cfg.dtype)
    batch_specs.pop("labels")
    bsz = shape.global_batch
    dp_entry, dp_size = _dp(mesh, rules)
    bdim = dp_entry if bsz % dp_size == 0 else None
    b_psp = _batch_pspecs(batch_specs, bdim)
    cache_sp = tf.cache_specs(cfg, bsz, shape.seq_len)
    cache_psp = shd.cache_pspecs(cache_sp, mesh, rules, bsz)
    # what prefill gives: the rank's rows (or every row), every position
    got_psp = shd.cache_pspecs(cache_sp, mesh, rules,
                               bsz if bdim is not None else 1)
    if bdim is None:
        got_psp = shd.map_spec_tree(lambda s: (None,) * len(s), got_psp)

    def prefill_step(params, batch):
        with torch.no_grad(), on_mesh(mesh, rules,
                                      batch_split=bdim is not None) as par:
            logits, caches = tf.prefill(params, cfg, batch,
                                        max_len=shape.seq_len, mesh=mesh,
                                        specs=p_psp)
            return logits, _relayout(caches, got_psp, cache_psp, par)

    return StepBundle(prefill_step, (p_psp, b_psp),
                      meta={"rules": rules, "param_pspecs": p_psp,
                            "cache_pspecs": cache_psp})


def make_decode_step(cfg: ModelConfig, mesh, shape: ShapeConfig) -> StepBundle:
    """One-token decode with a seq_len cache (the decode_* cells):
    (logits of the rank's rows, the rank's cache pieces), the caches
    written in place (`transformer.decode_step(..., donate=True)`), as the
    reference's step donates them."""
    tp = shd.axis_sizes(mesh).get("model", 1)
    if cfg.num_experts and cfg.num_experts % tp == 0:
        # decode token counts are tiny: keep experts RESIDENT (E:model x
        # d_ff:data) instead of streaming the weights every token
        cfg = cfg.with_(moe_serve_resident=True)
    rules = _rules_for(cfg, mesh, serve=True)
    p_psp = shd.param_pspecs(tf.param_specs(cfg), mesh, rules)
    bsz = shape.global_batch
    cache_psp = shd.cache_pspecs(tf.cache_specs(cfg, bsz, shape.seq_len),
                                 mesh, rules, bsz)
    dp_entry, dp_size = _dp(mesh, rules)
    bdim = dp_entry if bsz % dp_size == 0 else None
    tok_psp = (bdim, None) if cfg.input_mode == "tokens" else \
        (bdim, None, None)

    def decode(params, toks, caches, pos, enc=None):
        with torch.no_grad(), on_mesh(mesh, rules,
                                      batch_split=bdim is not None):
            return tf.decode_step(params, cfg, toks, caches, pos, enc=enc,
                                  mesh=mesh, specs=p_psp,
                                  cache_specs=cache_psp, donate=True)

    arg_specs = (p_psp, tok_psp, cache_psp, ())
    if cfg.encoder_tokens:
        arg_specs += ((bdim, None, None),)
    return StepBundle(decode, arg_specs,
                      meta={"rules": rules, "param_pspecs": p_psp,
                            "cache_pspecs": cache_psp, "cfg": cfg})


def make_step(cfg: ModelConfig, mesh, shape: ShapeConfig) -> StepBundle:
    if shape.kind == "train":
        return make_train_step(cfg, mesh, shape)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, mesh, shape)
    if shape.kind == "decode":
        return make_decode_step(cfg, mesh, shape)
    raise ValueError(shape.kind)
