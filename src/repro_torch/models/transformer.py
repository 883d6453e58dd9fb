"""Backbone assembler: the reference's `repro.models.transformer` in torch —
attention (GQA / window / MLA), MoE, Mamba2, xLSTM and cross-attention
blocks composed into the ten architectures.

Parameters and caches keep the reference's tree layout: stacked superblock
leaves carry a leading (num_superblocks, ...) dim, so `w[i]` / `pool[i]` is
a contiguous view for the kernels, and the reference's `jax.lax.scan` over
superblocks is a Python loop here.  A "shared_attn" block (zamba2) has one
parameter set, `params["shared"]`, reused by every superblock; its KV cache
is still one a superblock (stacked under "blocks").

Entry points:
  param_specs / init_params(cfg, generator, device)
  forward(params, cfg, batch, mesh, shard_specs, full_specs)
                                       full-sequence logits; batch holds
                                       "tokens" or "embeds", and "enc"
                                       for cross layers
  hidden_states, loss_fn(params, cfg, batch, mesh, shard_specs, full_specs)
                                       the training forward (block remat)
                                       and its chunked cross entropy over
                                       batch["labels"]
  cache_specs, prefill, decode_step    the dense-cache step functions
                                       (every block kind)
  paged_cache_specs / init_paged_caches
  prefill_chunk, decode_step_paged, verify_step_paged
                                       the paged step functions
                                       (attention-cache token models)
The paged pools are updated in place (the reference returns new ones);
`prefill` returns new caches.  `decode_step(..., donate=True)` writes
every cache leaf in the storage it was given and returns the same tree, as
the reference's decode step does under `donate_argnums`; without `donate`
it writes into a copy and leaves the caches it was given as they were.
`forward` streams the superblocks through `core.streamer.stream_layers`
when `cfg.stream.mode` is not "resident" and per-superblock specs are
given (`launch.steps.stream_specs`), as the reference does; otherwise the
layers run resident.

On a mesh (`specs`, the parameter spec tree the rank's pieces follow, and
the ambient mesh of `dist.collectives.on_mesh`, which the step builders of
`launch.steps` enter): a layer that is not streamed has its FSDP dims
gathered one layer at a time before it computes (ZeRO-3, `dist.
collectives.take`, again in a block's remat), and the blocks run the
tensor-parallel forms of `layers`, `attention`, `moe`, `ssm` and `xlstm`
when the model axis is larger than one rank: every block kind has one (the
shared block takes GQA's, on its one parameter set).  A layer that is not
streamed is gathered over the FSDP axes first (`_zero`: "data", or the
kimi-scale ("pod", "data")).  A decode whose recurrent state is split over
the dp axes on a dim other than the batch (`cache_pspecs` at B < dp)
gathers the state, steps it, and copies the rank's piece of the new one
back (`_state_decode`); the attention caches are read in parts
(`attention.gqa_decode` / `mla_decode`).
"""
from __future__ import annotations

import contextlib
import itertools

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.streamer import stream_layers
from repro_torch.device import resolve_device
from repro_torch.dist.collectives import current, on_mesh, take
from repro_torch.dist.sharding import drop_axes, leaf_axes, piece, whole
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (Spec, cross_entropy_chunked, embed,
                                       embed_specs, head_logits,
                                       head_logits_tp,
                                       init_from_specs, map_specs,
                                       mlp, mlp_specs, rmsnorm,
                                       rmsnorm_specs, stack_specs,
                                       tree_leaves, tree_map, unembed)

PAGED_BLOCK_KINDS = ("dense", "moe")


def _attn_cfg(cfg: ModelConfig, kind: str) -> attn.AttnConfig:
    window = cfg.window_size if kind.endswith(":window") else None
    return attn.AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias, rope_theta=cfg.rope_theta, window=window,
        kv_lora_rank=cfg.kv_lora_rank, q_lora_rank=cfg.q_lora_rank,
        rope_head_dim=cfg.rope_head_dim, dtype=cfg.torch_dtype,
        dense_mode=cfg.dense_kernel, paged_mode=cfg.paged_attn_kernel)


def _moe_cfg(cfg: ModelConfig) -> moe_mod.MoeConfig:
    return moe_mod.MoeConfig(
        d_model=cfg.d_model, d_ff=cfg.moe_d_ff or cfg.d_ff,
        num_experts=cfg.num_experts, experts_per_token=cfg.experts_per_token,
        num_shared_experts=cfg.num_shared_experts,
        capacity_factor=cfg.moe_capacity_factor, act=cfg.act,
        dtype=cfg.torch_dtype, serve_resident=cfg.moe_serve_resident,
        dense_kernel=cfg.dense_kernel)


def _ssm_cfg(cfg: ModelConfig) -> ssm_mod.SsmConfig:
    return ssm_mod.SsmConfig(
        d_model=cfg.d_model, d_inner=cfg.ssm_expansion * cfg.d_model,
        d_state=cfg.ssm_state_dim, n_heads=cfg.num_heads,
        dtype=cfg.torch_dtype, dense_mode=cfg.dense_kernel)


def _xlstm_cfg(cfg: ModelConfig) -> xlstm_mod.XlstmConfig:
    return xlstm_mod.XlstmConfig(
        d_model=cfg.d_model, n_heads=cfg.num_heads, dtype=cfg.torch_dtype,
        dense_mode=cfg.dense_kernel)


def supports_paged(cfg: ModelConfig) -> bool:
    kinds = tuple(cfg.prefix_pattern) + tuple(cfg.pattern)
    return (cfg.input_mode == "tokens"
            and all(k.split(":")[0] in PAGED_BLOCK_KINDS for k in kinds))


def _check_supported(cfg: ModelConfig) -> None:
    """The paged step functions serve token models of attention-cache
    blocks; the others run on the dense-cache engine."""
    if not supports_paged(cfg):
        bad = [k for k in tuple(cfg.prefix_pattern) + tuple(cfg.pattern)
               if k.split(":")[0] not in PAGED_BLOCK_KINDS]
        raise ValueError(
            f"{cfg.name}: paged KV serves token models of attention-cache "
            f"blocks {PAGED_BLOCK_KINDS} only; unsupported kinds {bad} or "
            f"input {cfg.input_mode!r} (use the dense-cache engine)")


def block_specs(cfg: ModelConfig, kind: str) -> dict:
    d, dt = cfg.d_model, cfg.torch_dtype
    base = kind.split(":")[0]
    if base in ("dense", "shared_attn", "moe", "cross"):
        sp = {
            "ln1": rmsnorm_specs(d, dt),
            "attn": (attn.cross_attn_specs if base == "cross"
                     else attn.attn_specs)(_attn_cfg(cfg, kind)),
            "ln2": rmsnorm_specs(d, dt),
        }
        if base == "moe":
            sp["moe"] = moe_mod.moe_specs(_moe_cfg(cfg))
        else:
            sp["mlp"] = mlp_specs(d, cfg.d_ff, dt, cfg.act)
        return sp
    if base == "mamba":
        return {"ln": rmsnorm_specs(d, dt),
                "ssm": ssm_mod.ssm_specs(_ssm_cfg(cfg))}
    if base in ("mlstm", "slstm"):
        mix = (xlstm_mod.mlstm_specs if base == "mlstm"
               else xlstm_mod.slstm_specs)(_xlstm_cfg(cfg))
        sp = {"ln1": rmsnorm_specs(d, dt), "mix": mix}
        if cfg.d_ff:  # xlstm-1.3b has d_ff == 0: mixer-only blocks
            sp["ln2"] = rmsnorm_specs(d, dt)
            sp["mlp"] = mlp_specs(d, cfg.d_ff, dt, cfg.act)
        return sp
    raise ValueError(f"unknown block kind {kind!r}")


def _is_shared(kind: str) -> bool:
    return kind.startswith("shared_attn")


def param_specs(cfg: ModelConfig) -> dict:
    sp: dict = {}
    if cfg.input_mode == "tokens":
        sp["embed"] = embed_specs(cfg.vocab_size, cfg.d_model,
                                  cfg.torch_dtype)
    sp["prefix"] = [block_specs(cfg, k) for k in cfg.prefix_pattern]
    sp["blocks"] = {f"b{i}": stack_specs(block_specs(cfg, k),
                                         cfg.num_superblocks)
                    for i, k in enumerate(cfg.pattern) if not _is_shared(k)}
    if any(_is_shared(k) for k in cfg.pattern):
        sp["shared"] = block_specs(cfg, "shared_attn")
    sp["final_norm"] = rmsnorm_specs(cfg.d_model, cfg.torch_dtype)
    if not cfg.tie_embeddings:
        sp["lm_head"] = {"w_out": Spec((cfg.vocab_size, cfg.d_model),
                                       cfg.torch_dtype)}
    return sp


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters from `generator` (which must live on `device`)."""
    return init_from_specs(param_specs(cfg), generator,
                           resolve_device(device))


def serving_params(params: dict, cfg: ModelConfig) -> dict:
    """A shallow copy of `params` for serving: it carries one contiguous
    (d_model, vocab) copy of the logits head's table — the tied embedding
    (`embed.embedding_t`) or the untied `lm_head.w_out` (`w_out_t`) — in
    its stored dtype, made here once, which the f32 logits head reads every
    step (`layers.head_logits`)."""
    out = dict(params)
    key, name = (("embed", "embedding") if cfg.tie_embeddings
                 else ("lm_head", "w_out"))
    out[key] = dict(params[key])
    out[key][f"{name}_t"] = params[key][name].t().contiguous()
    return out


# ---------------------------------------------------------------------------
# layer groups (copies of the reference's pure helpers, :412-498)
# ---------------------------------------------------------------------------

def layer_reach(cfg: ModelConfig, kind: str) -> str:
    return "window" if (kind.endswith(":window") and cfg.window_size) \
        else "global"


def layer_group_keys(cfg: ModelConfig) -> "tuple[str, ...]":
    keys: "list[str]" = []
    for k in tuple(cfg.prefix_pattern) + tuple(cfg.pattern):
        r = layer_reach(cfg, k)
        if r not in keys:
            keys.append(r)
    return tuple(keys) or ("global",)


def layer_group_index(cfg: ModelConfig, kind: str) -> int:
    return layer_group_keys(cfg).index(layer_reach(cfg, kind))


def group_horizons(cfg: ModelConfig) -> "tuple[int | None, ...]":
    return tuple(cfg.window_size if k == "window" else None
                 for k in layer_group_keys(cfg))


def is_stacked_cache_path(path) -> bool:
    return "blocks" in path


def cache_path_group(cfg: ModelConfig, path) -> int:
    """Layer-group index of a paged-cache leaf from its path, e.g.
    ("blocks", "b0", "k") or ("prefix", 0, "k")."""
    for i, k in enumerate(path):
        if k == "prefix":
            return layer_group_index(cfg, cfg.prefix_pattern[path[i + 1]])
        if k == "blocks":
            return layer_group_index(cfg, cfg.pattern[int(path[i + 1][1:])])
    raise ValueError(f"not a paged-cache leaf path: {path}")


def _group_table(cfg: ModelConfig, kind: str, tables):
    if isinstance(tables, (tuple, list)):
        return tables[layer_group_index(cfg, kind)]
    return tables


def paged_cache_specs(cfg: ModelConfig, num_blocks: int,
                      block_size: int) -> dict:
    """Pool specs in the reference's tree layout: stacked superblock
    leaves (S, nb, bs, KVH, hd)."""
    _check_supported(cfg)
    return {
        "prefix": [attn.paged_cache_specs(_attn_cfg(cfg, k), num_blocks,
                                          block_size)
                   for k in cfg.prefix_pattern],
        "blocks": {f"b{i}": stack_specs(attn.paged_cache_specs(
            _attn_cfg(cfg, k), num_blocks, block_size), cfg.num_superblocks)
            for i, k in enumerate(cfg.pattern)},
    }


def init_paged_caches(specs: dict, device) -> dict:
    return map_specs(lambda _, s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=device), specs)


# ---------------------------------------------------------------------------
# paged step functions
# ---------------------------------------------------------------------------

def _index(tree, i: int):
    """Layer i of a stacked tree: views, no copies.  A spec (a tuple of
    entries) drops its stack dim's entry."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tree[1:]
    return tree[i]


def _tree_layers(tree: dict, cfg: ModelConfig):
    """(kind, layer) per layer of a params or pools tree: the prefix
    layers, then each superblock's pattern in order (the reference's scan
    order).  A shared block's parameters are `tree["shared"]` in every
    superblock; a layer with no cache (cross) yields None."""
    yield from zip(cfg.prefix_pattern, tree["prefix"])
    for s in range(cfg.num_superblocks):
        for i, kind in enumerate(cfg.pattern):
            if _is_shared(kind) and "shared" in tree:
                yield kind, tree["shared"]
            else:
                sub = tree["blocks"].get(f"b{i}")
                yield kind, None if sub is None else _index(sub, s)


def _layers(params: dict, caches: dict, cfg: ModelConfig):
    """(kind, params, pools or cache) per layer."""
    for (kind, p), (_, c) in zip(_tree_layers(params, cfg),
                                 _tree_layers(caches, cfg)):
        yield kind, p, c


def _sub(spec, key):
    return None if spec is None else spec.get(key)


def _ffn(cfg: ModelConfig, kind: str, p: dict, x, spec=None):
    """The second half of an attention block: norm, then MoE or MLP."""
    h = rmsnorm(p["ln2"], x, mode=cfg.dense_kernel)
    if kind.split(":")[0] == "moe":
        return x + moe_mod.moe_apply(p["moe"], _moe_cfg(cfg), h,
                                     spec=_sub(spec, "moe"))
    return x + mlp(p["mlp"], h, cfg.act, dense_mode=cfg.dense_kernel,
                   spec=_sub(spec, "mlp"))


def _block(cfg: ModelConfig, kind: str, p, x, attend, spec=None):
    """One attention block: attention (`attend(attn_cfg, params, h)` runs
    the step's GQA or MLA function, as the config says, and returns (h,
    cache)), then the MoE or the MLP.  Returns (x, cache)."""
    h, cache = attend(_attn_cfg(cfg, kind), p["attn"],
                      rmsnorm(p["ln1"], x, mode=cfg.dense_kernel))
    return _ffn(cfg, kind, p, x + h, spec), cache


def _zero(p, spec):
    """(p with its FSDP dims gathered over the ambient mesh's FSDP axes,
    the spec it then has): ZeRO-3 for a layer that is not streamed; over
    ("pod", "data") a gather over each axis in turn (`take`).  No mesh or
    no spec: (p, spec) as they are."""
    par = current()
    if par is None or spec is None:
        return p, spec
    full = drop_axes(spec, par.rules.fsdp_axes)
    # a gather whose backward reduce-scatters; no copy over "model", as
    # each model rank's work on a leaf whole there is the whole work
    return tree_map(lambda w, s, f: take(w, s, f, par, partial=False),
                    p, spec, full), full


def _embed_tokens(params, cfg: ModelConfig, tokens, spec=None):
    p, sp = _zero(params["embed"], _sub(spec, "embed"))
    x = embed(p, tokens, sp)
    if cfg.embed_scale:
        # the factor rounded to x's dtype first, as the reference does
        x = x * float(torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype))
    return x


def _head_table(params, cfg: ModelConfig, spec=None):
    """(the live logits table, its spec once gathered over FSDP)."""
    key, name = (("embed", "embedding") if cfg.tie_embeddings
                 else ("lm_head", "w_out"))
    p, sp = _zero({name: params[key][name]},
                  None if spec is None else {name: spec[key][name]})
    return p[name], None if sp is None else sp[name]


def _logits_head(params, cfg: ModelConfig, x, spec=None):
    x = rmsnorm(params["final_norm"], x, mode=cfg.dense_kernel)
    if spec is not None and current() is not None:
        table, tsp = _head_table(params, cfg, spec)
        return head_logits_tp(x, table, tsp, cfg.dense_kernel)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, cfg.dense_kernel)
    head = params["lm_head"]
    return head_logits(x, head["w_out"], head.get("w_out_t"),
                       cfg.dense_kernel)


# ---------------------------------------------------------------------------
# full-sequence forward and the dense-cache step functions (the reference's
# :162-261, :288-400, :730-801)
# ---------------------------------------------------------------------------

def _mix(cfg: ModelConfig, kind: str, p: dict, step: str, h, *state,
         spec=None):
    """The Mamba2 or xLSTM mixer of `kind` at `step` (forward / prefill /
    decode) on the normed input h."""
    base = kind.split(":")[0]
    if base == "mamba":
        return getattr(ssm_mod, f"ssm_{step}")(
            p["ssm"], _ssm_cfg(cfg), h, *state, spec=_sub(spec, "ssm"))
    return getattr(xlstm_mod, f"{base}_{step}")(
        p["mix"], _xlstm_cfg(cfg), h, *state, spec=_sub(spec, "mix"))


def _mixer_block(cfg: ModelConfig, kind: str, p: dict, x, step: str,
                 *state, spec=None):
    """A recurrent block: the mixer on the normed input, the residual, and
    for xLSTM the MLP when d_ff.  Returns (x, state) (None at forward)."""
    mamba = kind.split(":")[0] == "mamba"
    out = _mix(cfg, kind, p, step, rmsnorm(p["ln" if mamba else "ln1"], x,
                                           mode=cfg.dense_kernel), *state,
               spec=spec)
    y, st = (out, None) if step == "forward" else out
    x = x + y
    if not mamba and cfg.d_ff:
        x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, mode=cfg.dense_kernel),
                    cfg.act, dense_mode=cfg.dense_kernel,
                    spec=_sub(spec, "mlp"))
    return x, st


def _cross_block(cfg: ModelConfig, kind: str, p: dict, x, enc, spec=None):
    h = attn.cross_attn_forward(p["attn"], _attn_cfg(cfg, kind),
                                rmsnorm(p["ln1"], x, mode=cfg.dense_kernel),
                                enc, _sub(spec, "attn"))
    return _ffn(cfg, kind, p, x + h, spec)


def apply_block(cfg: ModelConfig, kind: str, p: dict, x, positions,
                enc=None, spec=None):
    """One block over a whole sequence: causal GQA / window or MLA
    self-attention then the MLP or the MoE; Mamba2 or xLSTM; or cross
    attention over `enc` then the MLP.  `spec`: the block's specs on a
    mesh (module docstring)."""
    base = kind.split(":")[0]
    if base in ("dense", "shared_attn", "moe"):
        return _block(cfg, kind, p, x, lambda ac, pa, h: (
            (attn.mla_forward if ac.is_mla else attn.gqa_forward)(
                pa, ac, h, positions, _sub(spec, "attn")), None), spec)[0]
    if base == "cross":
        return _cross_block(cfg, kind, p, x, enc, spec)
    return _mixer_block(cfg, kind, p, x, "forward", spec=spec)[0]


def _inputs(params, cfg: ModelConfig, batch: dict, specs=None):
    """The first layer's input and the encoder embeddings, in the model's
    dtype."""
    if cfg.input_mode == "tokens":
        x = _embed_tokens(params, cfg, batch["tokens"], specs)
    else:
        x = batch["embeds"].to(cfg.torch_dtype)
    enc = batch.get("enc")
    return x, None if enc is None else enc.to(cfg.torch_dtype)


def _backbone(params: dict, cfg: ModelConfig, batch: dict, mesh=None,
              shard_specs=None, full_specs=None, specs=None):
    """The layers over the whole sequence, before the final norm.  When
    autograd records (a parameter carries a gradient) and `cfg.remat` is
    "block", each superblock layer runs under `torch.utils.checkpoint`
    (non-reentrant): the backward recomputes it from its input, as the
    reference's `jax.checkpoint` around its scan body does (the prefix
    layers, outside the scan there, keep their activations here too).

    Streamed (`cfg.stream.mode` not "resident" and `shard_specs` given):
    the prefix layers and a shared block run resident, and the stacked
    `params["blocks"]` go through `stream_layers`, one superblock a step,
    remat around the whole superblock as the reference's.

    On a mesh (`specs`; module docstring) a layer that is not streamed is
    gathered over FSDP inside its remat, and streamed blocks get the
    gathered specs (`full_specs`)."""
    x, enc = _inputs(params, cfg, batch, specs)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    remat = (cfg.remat == "block" and torch.is_grad_enabled()
             and any(t.requires_grad for t in tree_leaves(params)))
    n_prefix = len(cfg.prefix_pattern)

    def run(kind, p, x, sp):
        p, sp = _zero(p, sp)
        return apply_block(cfg, kind, p, x, positions, enc, sp)

    if cfg.stream.mode == "resident" or shard_specs is None:
        for j, (kind, p, sp) in enumerate(_with_specs(
                _tree_layers(params, cfg), specs, cfg)):
            if specs is None:
                fn, args = apply_block, (cfg, kind, p, x, positions, enc)
            else:
                fn, args = run, (kind, p, x, sp)
            if remat and j >= n_prefix:
                x = checkpoint(fn, *args, use_reentrant=False)
            else:
                x = fn(*args)
        return x

    for j, (kind, p) in enumerate(zip(cfg.prefix_pattern, params["prefix"])):
        x = run(kind, p, x, None if specs is None else specs["prefix"][j])
    shared, shared_spec = params.get("shared"), None
    if shared is not None and specs is not None:
        shared, shared_spec = _zero(shared, specs["shared"])

    def superblock(x, ws):
        for i, kind in enumerate(cfg.pattern):
            if _is_shared(kind):
                p, sp = shared, shared_spec
            else:
                p = ws[f"b{i}"]
                sp = None if specs is None else full_specs[f"b{i}"]
            x = apply_block(cfg, kind, p, x, positions, enc, sp)
        return x

    def stream_apply(x, ws):
        if remat:
            return checkpoint(superblock, x, ws, use_reentrant=False)
        return superblock(x, ws)

    return stream_layers(stream_apply, x, params["blocks"],
                         cfg.num_superblocks, settings=cfg.stream, mesh=mesh,
                         shard_specs=shard_specs, full_specs=full_specs)


def forward(params: dict, cfg: ModelConfig, batch: dict, mesh=None,
            shard_specs=None, full_specs=None, specs=None):
    """Full-sequence forward to f32 logits (B, S, vocab).  batch:
    {"tokens": (B, S)} or {"embeds": (B, S, D)}, with "enc": (B, T, D) for
    cross layers.  Projections run `kernels.ops.dense`, MoE layers
    `dense_grouped`, norms the RMSNorm kernel and the head
    `layers.head_logits`, as the step functions do.  `mesh`,
    `shard_specs` and `full_specs` (one superblock's leaves, resting and
    gathered) stream the superblocks as `cfg.stream` says; `specs` runs
    the rank's pieces on the mesh (module docstring)."""
    with _ambient(mesh, specs):
        return _logits_head(params, cfg, _backbone(
            params, cfg, batch, mesh, shard_specs, full_specs, specs),
            specs)


def _ambient(mesh, specs):
    """The mesh made ambient for a call given `specs`, unless a step builder
    already made it so."""
    if specs is None or current() is not None:
        return contextlib.nullcontext()
    return on_mesh(mesh)


def hidden_states(params: dict, cfg: ModelConfig, batch: dict, mesh=None,
                  shard_specs=None, full_specs=None, specs=None):
    """The forward up to and including the final norm: no LM head."""
    with _ambient(mesh, specs):
        return rmsnorm(params["final_norm"],
                       _backbone(params, cfg, batch, mesh, shard_specs,
                                 full_specs, specs), mode=cfg.dense_kernel)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, mesh=None,
            shard_specs=None, full_specs=None, specs=None) -> torch.Tensor:
    """The training loss: mean token NLL of batch["labels"] (B, S) over
    `hidden_states`, in 512-position chunks (`cross_entropy_chunked`).
    The head reads the live table (`embed.embedding` tied, `lm_head.w_out`
    untied), never a serving copy, so its gradient reaches the table; a
    tied table gets its gradient through both the lookup and the head.  On
    a mesh the head takes its tensor-parallel form (`layers.
    head_logits_tp`)."""
    with _ambient(mesh, specs):
        x = hidden_states(params, cfg, batch, mesh, shard_specs, full_specs,
                          specs)
        table, tsp = _head_table(params, cfg, specs)
        return cross_entropy_chunked(
            lambda xc: head_logits_tp(xc, table, tsp, cfg.dense_kernel), x,
            batch["labels"], chunk=512)


def _block_cache_specs(cfg: ModelConfig, kind: str, batch: int,
                       max_len: int):
    base = kind.split(":")[0]
    if base in ("dense", "shared_attn", "moe"):
        return attn.cache_specs(_attn_cfg(cfg, kind), batch, max_len)
    if base == "mamba":
        return ssm_mod.ssm_state_specs(_ssm_cfg(cfg), batch)
    if base == "mlstm":
        return xlstm_mod.mlstm_state_specs(_xlstm_cfg(cfg), batch)
    if base == "slstm":
        return xlstm_mod.slstm_state_specs(_xlstm_cfg(cfg), batch)
    if base == "cross":
        return None   # K/V come from the encoder embeddings every call
    raise ValueError(kind)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Dense cache specs: per prefix layer a dict (None for cross), and
    per pattern position with a cache its leaves stacked over the
    superblocks, (S, batch, ...): a leaf under "blocks" has its lane axis
    at 1 (`is_stacked_cache_path`)."""
    blocks = {}
    for i, k in enumerate(cfg.pattern):
        cs = _block_cache_specs(cfg, k, batch, max_len)
        if cs is not None:
            blocks[f"b{i}"] = stack_specs(cs, cfg.num_superblocks)
    return {"prefix": [_block_cache_specs(cfg, k, batch, max_len)
                       for k in cfg.prefix_pattern],
            "blocks": blocks}


def _block_prefill(cfg: ModelConfig, kind: str, p: dict, x, positions,
                   enc, max_len: int, spec=None):
    """One block over the prompt.  Returns (x, cache or None)."""
    base = kind.split(":")[0]
    if spec is not None:
        p, spec = _zero(p, spec)
    if base in ("dense", "shared_attn", "moe"):
        return _block(cfg, kind, p, x, lambda ac, pa, h: (
            attn.mla_prefill if ac.is_mla else attn.gqa_prefill)(
                pa, ac, h, positions, max_len, _sub(spec, "attn")), spec)
    if base == "cross":
        return _cross_block(cfg, kind, p, x, enc, spec), None
    return _mixer_block(cfg, kind, p, x, "prefill", spec=spec)


def _state_decode(cfg: ModelConfig, kind: str, p: dict, x, cache,
                  spec, cache_spec):
    """A recurrent block's decode: the new state is copied into `cache`'s
    leaves.  Returns x.  A state split over the dp axes on a dim other
    than its batch (`cache_pspecs` at B < dp: the heads of `s`, `M`, `c`,
    ...) is gathered whole first and the rank's piece of the new state
    copied back (the state is O(1) in the sequence); a state split on its
    batch is the rank's rows, stepped as it is."""
    par = current()
    split = {n: (None, *sp[1:]) for n, sp in (cache_spec or {}).items()}
    if par is None or not any(map(leaf_axes, split.values())):
        x, new = _mixer_block(cfg, kind, p, x, "decode", cache, spec=spec)
    else:
        x, new = _mixer_block(cfg, kind, p, x, "decode", {
            n: whole(t, split[n], par.mesh) for n, t in cache.items()},
            spec=spec)
        new = {n: piece(t, split[n], par.mesh) for n, t in new.items()}
    for n, t in new.items():
        cache[n].copy_(t)
    return x


def _block_decode(cfg: ModelConfig, kind: str, p: dict, x, cache, pos: int,
                  enc, spec=None, cache_spec=None):
    """One block at one position, its cache (None for cross) written in
    place.  Returns x.  A cache split on its sequence dim (`cache_spec`)
    is read in parts by the attention decodes; a recurrent state split on
    its heads is gathered (`_state_decode`)."""
    base = kind.split(":")[0]
    if spec is not None:
        p, spec = _zero(p, spec)
    if base in ("dense", "shared_attn", "moe"):
        return _block(cfg, kind, p, x, lambda ac, pa, h: (
            attn.mla_decode if ac.is_mla else attn.gqa_decode)(
                pa, ac, h, cache, pos, _sub(spec, "attn"), cache_spec),
            spec)[0]
    if base == "cross":
        return _cross_block(cfg, kind, p, x, enc, spec)
    return _state_decode(cfg, kind, p, x, cache, spec, cache_spec)


def _stack(trees: list):
    """Per-superblock cache dicts -> one dict of stacked (S, ...) leaves."""
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _run_layers(cfg: ModelConfig, x, layers, step):
    """Run `step(kind, p, c, x)` -> (x, new cache) over `layers`, (kind,
    params, cache) in the reference's scan order.  Returns (x, the new
    caches in `cache_specs`' layout)."""
    n, per = len(cfg.prefix_pattern), {}
    prefix = []
    for j, item in enumerate(layers):
        x, new = step(*item, x)
        if j < n:
            prefix.append(new)
        elif new is not None:
            per.setdefault(f"b{(j - n) % len(cfg.pattern)}", []).append(new)
    return x, {"prefix": prefix,
               "blocks": {k: _stack(v) for k, v in per.items()}}


def _with_specs(items, specs, cfg: ModelConfig):
    """(*item, layer spec) for each layer's item (None without specs)."""
    if specs is None:
        return ((*it, None) for it in items)
    return ((*it, sp) for it, (_, sp) in zip(items,
                                            _tree_layers(specs, cfg)))


def prefill(params: dict, cfg: ModelConfig, batch: dict, max_len: int,
            mesh=None, specs=None):
    """The whole prompt at once.  batch: {"tokens": (B, S)} or {"embeds":
    (B, S, D)}, with "enc" for cross layers.  Returns (last-position
    logits (B, 1, vocab) f32, caches in `cache_specs`' layout at batch B,
    attention caches sized for max_len).  `specs`: the rank's pieces on
    the mesh (module docstring); the caches hold the rank's rows, every
    position."""
    with _ambient(mesh, specs):
        x, enc = _inputs(params, cfg, batch, specs)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        x, caches = _run_layers(
            cfg, x, _with_specs(((kind, p, None) for kind, p in
                                 _tree_layers(params, cfg)), specs, cfg),
            lambda kind, p, _, sp, x: _block_prefill(
                cfg, kind, p, x, positions, enc, max_len, sp))
        return _logits_head(params, cfg, x[:, -1:], specs), caches


def decode_step(params: dict, cfg: ModelConfig, tokens_or_embeds, caches,
                pos: int, enc=None, mesh=None, specs=None,
                cache_specs=None, donate: bool = False):
    """One decode step at the one absolute position `pos` of every row.
    tokens: (B, 1) ints, or (B, 1, D) embeddings for an embedding-input
    model; enc: (B, T, D) for cross layers.  Every row's KV is written at
    `pos` and every row's recurrent state advances: a caller whose rows sit
    at other positions keeps only the rows at `pos` (the dense-cache
    engine).  Returns (logits (B, 1, vocab) f32, caches).  With `donate`
    the caches are consumed, as the reference's `donate_argnums` consumes
    them: every leaf is written in the storage it was given (a stacked
    leaf through its layers' views) and `caches` itself comes back, so the
    step holds the cache once.  Without, the leaves are copied first and
    `caches` is left as it was.  `specs` / `cache_specs`: the rank's pieces
    of the parameters and of the caches on the mesh (module docstring)."""
    if not donate:
        caches = tree_map(lambda t: None if t is None else t.clone(), caches)
    with _ambient(mesh, specs):
        x, enc = _inputs(params, cfg, (
            {"tokens": tokens_or_embeds} if cfg.input_mode == "tokens"
            else {"embeds": tokens_or_embeds}) | (
            {} if enc is None else {"enc": enc}), specs)
        items = _with_specs(_layers(params, caches, cfg), specs, cfg)
        csps = (_tree_layers(cache_specs, cfg) if cache_specs is not None
                else itertools.repeat((None, None)))
        for (kind, p, c, sp), (_, csp) in zip(items, csps):
            x = _block_decode(cfg, kind, p, x, c, pos, enc, sp, csp)
        return _logits_head(params, cfg, x, specs), caches


def prefill_chunk(params: dict, cfg: ModelConfig, tokens, caches, table_row,
                  start_pos: int, last_idx: int):
    """One prompt chunk of one lane.  tokens: (1, chunk); table_row: the
    lane's (1, MB) table (or one per layer group); start_pos: absolute
    position of tokens[0] (any token index); last_idx: chunk-local index
    whose logits are returned.  Returns (logits (1, vocab), caches)."""
    x = _embed_tokens(params, cfg, tokens)
    for kind, p, c in _layers(params, caches, cfg):
        row = _group_table(cfg, kind, table_row)
        x, _ = _block(cfg, kind, p, x, lambda ac, pa, h, c=c, row=row: (
            attn.mla_prefill_paged if ac.is_mla else attn.gqa_prefill_paged)(
                pa, ac, h, c, row, start_pos))
    logits = _logits_head(params, cfg, x[:, last_idx:last_idx + 1])
    return logits[:, 0], caches


def decode_step_paged(params: dict, cfg: ModelConfig, tokens, caches,
                      tables, positions, active):
    """One batched decode step.  tokens: (slots, 1); tables: (slots, MB);
    positions: (slots,) per-lane; active: (slots,) bool — inactive lanes
    write the null block and their logits are ignored.
    Returns (logits (slots, 1, vocab), caches)."""
    x = _embed_tokens(params, cfg, tokens)
    for kind, p, c in _layers(params, caches, cfg):
        tb = _group_table(cfg, kind, tables)
        x, _ = _block(cfg, kind, p, x, lambda ac, pa, h, c=c, tb=tb: (
            attn.mla_decode_paged if ac.is_mla else attn.gqa_decode_paged)(
                pa, ac, h, c, tb, positions, active))
    return _logits_head(params, cfg, x), caches


def verify_step_paged(params: dict, cfg: ModelConfig, tokens, caches,
                      tables, positions, active, nvalid):
    """Batched speculative verify: tokens (slots, S) = [last token, drafts,
    pads]; positions are per-lane START positions; nvalid (slots,) real
    tokens per lane.  Returns (logits (slots, S, vocab), caches):
    logits[b, i] scores the token after tokens[b, i]."""
    x = _embed_tokens(params, cfg, tokens)
    for kind, p, c in _layers(params, caches, cfg):
        tb = _group_table(cfg, kind, tables)
        x, _ = _block(cfg, kind, p, x, lambda ac, pa, h, c=c, tb=tb: (
            attn.mla_verify_paged if ac.is_mla else attn.gqa_verify_paged)(
                pa, ac, h, c, tb, positions, active, nvalid))
    return _logits_head(params, cfg, x), caches
