"""Paged-KV serving engine: chunked prefill + continuous batching decode.

The port of `repro.serving.engine.ServingEngine` for the paged path.  It
composes `serving.cache.GroupedPagedCache` (fixed-size KV blocks shared
across lanes, one block table per layer group) with
`serving.scheduler.ChunkedPrefillScheduler` (FCFS, preemption by block
pressure, prefill split into fixed chunks interleaved with decode — the
generalized ping-pong schedule applied to the request stream).

Three step functions run the model, each at one input shape whatever the
prompt lengths, draft lengths and acceptance patterns:

  * `prefill_chunk`: (1, chunk) tokens of one lane's padded prompt;
  * `decode_step_paged`: (slots, 1) tokens with per-lane positions;
  * `verify_step_paged`: (slots, draft_len + 1) tokens — speculative
    decoding with drafts mined from the request's own history
    (`ngram_propose`) and the prefix index's stored sequences
    (`PrefixCache.suffix_lookup`), or rolled out by a small draft model
    over a fixed (1, 16) window (`transformer.forward`), scored in one
    batched pass; rejected drafts roll back by block-table truncation.
    Greedy streams are identical with speculation on or off.

With the prefix cache (`serving.prefix.PrefixCache`, a radix index over
token blocks) admission maps previously computed prompt blocks straight
into a lane's tables and prefill starts at the first unmatched token;
several lanes' tables then name the same physical blocks, read only.  A
partly matched block is forked copy-on-write: the cache queues
(group, src, dst) copies that the engine drains into the pools, one
indexed copy a pool leaf, before any model call of the step.
`defragment()` compacts each group's pool, permuting the pools one leaf at
a time in lockstep with the tables and the index.

With `obs` on, `engine.obs` carries a trace (request spans, phase spans,
modelled kernel lanes), TTFT / TPOT histograms and the host time of each
part of a step (`HOST_PHASES`), all read from the host clock: telemetry
adds no device synchronisation and no device read.

PyTorch runs eagerly, so nothing is traced; `trace_counts` counts the
distinct input shapes each step function has seen and stays
{prefill_chunk: 1, decode: 1, verify: <= 1}.  The device pools are updated
in place by the step functions.

Sampling is greedy at temperature 0.  Above it, every draw uses a
`torch.Generator` seeded from (ServeConfig.seed, request id, token index):
deterministic whatever the lane assignment or interleaving, but not the
reference's `jax.random` bits, so parity with the reference is greedy only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedule import (plan_serve_chunk, round_up,
                                       tokens_per_step_cov)
from repro_torch.device import resolve_device
from repro_torch.kernels.gpp_matmul import matmul_lane_events
from repro_torch.kernels.paged_attention import paged_lane_events
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Spec, map_specs
from repro_torch.obs import make_telemetry
from repro_torch.obs.ledger import BandwidthLedger
from repro_torch.obs.trace import (PID_KERNEL, PID_REQUESTS, PID_SERVING,
                                   TID_ENGINE, TID_LANE0,
                                   annotate_serving_tracks)
from repro_torch.serving.cache import GroupedPagedCache, PagedKVCache
from repro_torch.serving.prefix import PrefixCache, ngram_propose
from repro_torch.serving.scheduler import ChunkedPrefillScheduler, Request

# the parts of a step whose host time `obs` adds up (`engine.host_us`)
HOST_PHASES = ("schedule", "upload", "launch", "copy_back", "bookkeeping")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    slots: int = 4                 # concurrent decode lanes
    max_len: int = 256             # max tokens per sequence (table capacity)
    temperature: float = 0.0       # 0 => greedy
    eos_token: int | None = None
    dense_kernel: str | None = None      # override cfg.dense_kernel:
                                         # auto | ref | kernel
    paged_attn_kernel: str | None = None  # override cfg.paged_attn_kernel
    seed: int = 0                  # root of the temperature draws
    # paged-KV knobs (0 = derive from the ModelConfig serving defaults)
    block_size: int = 0            # tokens per KV block
    num_blocks: int = 0            # pool size per layer group incl. null
                                   # block 0; 0 = slots * max_len worth
    prefill_chunk: int = 0         # 0 = planned by plan_serve_chunk
    token_budget: int = 0          # flat per-step token target; 0 = cfg /
                                   # slots + 2 blocks
    # shared-prefix KV reuse (serving/prefix.py); None = cfg.prefix_cache /
    # cfg.prefix_cache_blocks (0 = no cap on the blocks the index holds)
    prefix_cache: "bool | None" = None
    prefix_cache_blocks: "int | None" = None
    # speculative decoding; None/0 = cfg.speculation / cfg.draft_len.
    # draft_source "self": prompt-lookup n-grams of the lane's history, then
    # the prefix index's stored sequences; "model": greedy rollout of the
    # draft model given to the engine (`draft_model=(cfg, params)`), "self"
    # when none was given
    speculation: "bool | None" = None
    draft_len: int = 0
    draft_source: str = "self"
    # telemetry (repro_torch.obs): trace spans, TTFT / TPOT histograms,
    # step wall times.  None = cfg.obs; trace_capacity 0 =
    # cfg.obs_trace_capacity; metrics_retention None = cfg (0 = unbounded)
    obs: "bool | None" = None
    trace_capacity: int = 0
    metrics_retention: "int | None" = None
    device: str = "cuda"           # "cpu" only when asked for


def sample_token(serve: ServeConfig, rid: int, token_idx: int,
                 logits_row) -> int:
    """Greedy at temperature 0; otherwise one categorical draw from a
    generator seeded by (serve.seed, rid, token_idx), so identical request
    streams give identical outputs whatever the batching."""
    row = torch.as_tensor(np.asarray(logits_row, np.float32))
    if serve.temperature <= 0.0:
        return int(torch.argmax(row))
    seed = hash((serve.seed, rid, token_idx)) & ((1 << 63) - 1)
    gen = torch.Generator().manual_seed(seed)
    probs = torch.softmax(row / serve.temperature, dim=-1)
    return int(torch.multinomial(probs, 1, generator=gen))


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _pool_leaves(tree, path=()):
    """(path, tensor) for every tensor of a cache tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _pool_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _pool_leaves(v, path + (i,))
    elif tree is not None:            # a cross layer's dense cache is None
        yield path, tree


class ServingEngine:
    """Paged-KV continuous-batching engine (see module docstring)."""

    def __init__(self, cfg: ModelConfig, params: dict, serve: ServeConfig,
                 draft_model: "tuple[ModelConfig, dict] | None" = None):
        if serve.dense_kernel is not None:
            cfg = cfg.with_(dense_kernel=serve.dense_kernel)
        if serve.paged_attn_kernel is not None:
            cfg = cfg.with_(paged_attn_kernel=serve.paged_attn_kernel)
        tf._check_supported(cfg)
        self.device = resolve_device(serve.device)
        self.cfg = cfg
        self.serve = serve
        self.params = tf.serving_params(_to_device(params, self.device), cfg)

        bs = serve.block_size or cfg.serve_block_size
        max_len = round_up(serve.max_len, bs)
        mb = max_len // bs
        budget = serve.token_budget or cfg.serve_token_budget \
            or (serve.slots + 2 * bs)
        chunk = serve.prefill_chunk or plan_serve_chunk(
            token_budget=budget, decode_lanes=serve.slots, block_size=bs)
        num_blocks = serve.num_blocks or serve.slots * mb + 1
        self.block_size = bs
        self.chunk = chunk
        self.token_budget = budget

        self.group_horizons = tf.group_horizons(cfg)
        self.kv = GroupedPagedCache(
            slots=serve.slots, num_blocks=num_blocks, block_size=bs,
            max_blocks_per_seq=mb, horizons=self.group_horizons)
        prefix_on = (serve.prefix_cache if serve.prefix_cache is not None
                     else cfg.prefix_cache)
        prefix_blocks = (serve.prefix_cache_blocks
                         if serve.prefix_cache_blocks is not None
                         else cfg.prefix_cache_blocks)
        self.prefix = (PrefixCache(self.kv, max_blocks=prefix_blocks)
                       if prefix_on else None)

        spec_on = (serve.speculation if serve.speculation is not None
                   else cfg.speculation)
        self.draft_len = (serve.draft_len or cfg.draft_len) if spec_on else 0
        self.draft_source = serve.draft_source
        self._draft_cfg = self._draft_params = None
        self.draft_forwards = 0          # draft-model forwards run
        if draft_model is not None and spec_on \
                and serve.draft_source == "model":
            self._draft_cfg = draft_model[0]
            self._draft_params = tf.serving_params(
                _to_device(draft_model[1], self.device), self._draft_cfg)
            self._draft_window = 16      # one (1, W) rollout shape

        obs_on = serve.obs if serve.obs is not None else cfg.obs
        self.obs = make_telemetry(
            obs_on,
            trace_capacity=serve.trace_capacity or cfg.obs_trace_capacity)
        annotate_serving_tracks(self.obs.trace, serve.slots)
        self._kv_lane_calls = 0
        self.host_us = dict.fromkeys(HOST_PHASES, 0.0)
        self._lap_t = 0.0

        self.scheduler = ChunkedPrefillScheduler(
            self.kv, slots=serve.slots, chunk=chunk, prefix=self.prefix,
            draft_len=self.draft_len,
            draft_fn=self._draft_for if self.draft_len else None,
            token_budget=budget, trace=self.obs.trace)
        specs = tf.paged_cache_specs(cfg, num_blocks, bs)
        self.caches = tf.init_paged_caches(specs, self.device)
        self._kv_token_bytes = self._kv_bytes_per_token(specs)
        self._group_token_bytes = self._kv_bytes_by_group(cfg, specs)
        self._param_bytes = cfg.active_params() * cfg.torch_dtype.itemsize
        self._reclaims = any(h is not None for h in self.group_horizons)

        # distinct input shapes per step function ("verify" stays empty
        # with speculation off)
        self._shapes = {"prefill_chunk": set(), "decode": set(),
                        "verify": set()}
        self._results: dict[int, list[int]] = {}
        self._next_id = 0
        self.metrics = BandwidthLedger(retention=(
            serve.metrics_retention if serve.metrics_retention is not None
            else cfg.metrics_retention))

    @property
    def trace_counts(self) -> "dict[str, int]":
        return {k: len(v) for k, v in self._shapes.items()}

    @staticmethod
    def _kv_bytes_per_token(specs) -> int:
        """Per-token KV bytes across every attention layer (stacked leaves
        carry a leading superblock dim before (nb, bs, ...))."""
        total = 0

        def leaf(path, s: Spec):
            nonlocal total
            stacked = tf.is_stacked_cache_path(path)
            per_slot = int(np.prod(s.shape[3:] if stacked else s.shape[2:]))
            layers = s.shape[0] if stacked else 1
            total += layers * per_slot * s.dtype.itemsize

        map_specs(leaf, specs)
        return total

    @staticmethod
    def _kv_bytes_by_group(cfg, specs) -> "list[int]":
        out = [0] * len(tf.layer_group_keys(cfg))

        def leaf(path, s: Spec):
            stacked = tf.is_stacked_cache_path(path)
            per_slot = int(np.prod(s.shape[3:] if stacked else s.shape[2:]))
            layers = s.shape[0] if stacked else 1
            out[tf.cache_path_group(cfg, path)] += \
                layers * per_slot * s.dtype.itemsize

        map_specs(leaf, specs)
        return out

    # ---------------------------------------------------------------- API
    def submit(self, prompt: "list[int]", max_new_tokens: int = 32) -> int:
        rid = self._next_id
        self._next_id += 1
        self.scheduler.submit(Request(
            rid=rid, prompt=np.asarray(prompt, np.int32),
            max_new=max_new_tokens))
        self.obs.requests.on_submit(rid)
        if self.obs.enabled:
            self.obs.trace.async_begin(
                f"req {rid}", rid, pid=PID_REQUESTS,
                args={"prompt_tokens": len(prompt),
                      "max_new": max_new_tokens})
        return rid

    def result(self, rid: int) -> "list[int] | None":
        return self._results.get(rid)

    @property
    def pending(self) -> int:
        return self.scheduler.pending

    def flatness_cov(self) -> float:
        """Coefficient of variation of tokens/step (lower = flatter)."""
        return tokens_per_step_cov([m["tokens"] for m in self.metrics])

    def prefix_hit_rate(self) -> float:
        return self.prefix.hit_rate() if self.prefix else 0.0

    def acceptance_rate(self) -> float:
        drafted = self.metrics.total("drafted_tokens")
        accepted = self.metrics.total("accepted_tokens")
        return accepted / drafted if drafted else 0.0

    # ------------------------------------------------------------ engine
    def _sample(self, logits_row, req: Request) -> int:
        return sample_token(self.serve, req.rid, len(req.produced), logits_row)

    def _draft_for(self, req: Request, cap: int) -> np.ndarray:
        """Scheduler hook: up to `cap` draft tokens for `req`.  "self"
        drafting mines tokens the system has already seen — the lane's own
        prompt + produced history (`ngram_propose`), then the prefix
        index's stored sequences (`PrefixCache.suffix_lookup`) — so no
        weights stream; "model" drafting rolls out the draft model."""
        if cap < 1:
            return np.zeros((0,), np.int32)
        hist = np.concatenate(
            [req.prompt, np.asarray(req.produced, np.int32)])
        if self._draft_params is not None:
            d = self._draft_with_model(hist, cap)
        else:
            d = ngram_propose(hist, cap)
            if len(d) == 0 and self.prefix is not None:
                d = self.prefix.suffix_lookup(hist, cap)
        d = np.asarray(d, np.int32)[:cap]
        if len(d):
            # a draft model with another vocabulary may propose ids the
            # target cannot embed: clamp (a wrong guess is just rejected)
            d = np.clip(d, 0, self.cfg.vocab_size - 1)
        return d

    def _draft_with_model(self, hist: np.ndarray, cap: int) -> np.ndarray:
        """Greedy draft-model rollout over a fixed (1, W) token window: one
        input shape whatever the context length."""
        W = self._draft_window
        seq = [int(t) for t in hist[-W:]]
        out: "list[int]" = []
        for _ in range(cap):
            window = seq[-W:]
            n = len(window)
            toks = np.zeros((1, W), np.int32)
            toks[0, :n] = window
            logits = tf.forward(self._draft_params, self._draft_cfg,
                                {"tokens": self._dev(toks)})
            self.draft_forwards += 1
            t = int(torch.argmax(logits[0, n - 1]))
            out.append(t)
            seq.append(t)
        return np.asarray(out, np.int32)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _tables(self, lane: "int | None" = None):
        """Per-group block tables on the device: the whole (slots, MB)
        table per group for decode/verify, or one lane's (1, MB) row per
        group for a prefill chunk."""
        if lane is None:
            return tuple(self._dev(g.tables) for g in self.kv.groups)
        return tuple(self._dev(g.tables[lane][None]) for g in self.kv.groups)

    def _seen(self, fn: str, *arrays) -> None:
        self._shapes[fn].add(tuple(tuple(a.shape) for a in arrays))

    def _lap(self, phase: str) -> None:
        """Add the host time since the last lap to `phase` (obs on)."""
        if self.obs.enabled:
            t = self.obs.now_us()
            self.host_us[phase] += t - self._lap_t
            self._lap_t = t

    def _apply_pending_copies(self) -> None:
        """Drain queued copy-on-write block copies into the device pools,
        BEFORE any model call of the step, so a forked block holds its
        source rows before the lane appends.  One indexed copy a pool leaf:
        the sources and destinations of one drain are disjoint (a fork
        takes a free block, and `free_lane` purges the copies into a freed
        lane's blocks), which is checked: an indexed copy with a repeated
        destination has no defined result on the card."""
        if not self.kv.pending_copies:
            return
        per_group: "dict[int, tuple[list[int], list[int]]]" = {}
        for gi, src, dst in self.kv.pending_copies:
            srcs, dsts = per_group.setdefault(gi, ([], []))
            srcs.append(src)
            dsts.append(dst)
        for gi, (srcs, dsts) in per_group.items():
            if len(set(dsts)) < len(dsts) or set(srcs) & set(dsts):
                raise RuntimeError(
                    f"group {gi}: copy-on-write copies {srcs} -> {dsts} "
                    "repeat a destination or overlap their sources")
        self.kv.pending_copies = []
        idx = {gi: (self._dev(np.asarray(a, np.int64)),
                    self._dev(np.asarray(b, np.int64)))
               for gi, (a, b) in per_group.items()}
        for path, pool in _pool_leaves(self.caches):
            gi = tf.cache_path_group(self.cfg, path)
            if gi not in idx:
                continue
            src, dst = idx[gi]
            if tf.is_stacked_cache_path(path):
                pool[:, dst] = pool[:, src]
            else:
                pool[dst] = pool[src]

    def _prefix_insert(self, lane: int, tokens: np.ndarray) -> None:
        """Index `tokens` (every position's KV is written for this lane)
        into the radix tree, adopting the lane's novel blocks: at prefill's
        end (the context becomes shareable while the lane decodes) and at
        finish (context + generated tokens, for multi-turn reuse)."""
        if self.prefix is None or len(tokens) == 0:
            return
        n = -(-len(tokens) // self.block_size)
        self.prefix.insert(np.asarray(tokens, np.int32),
                           self.kv.table_snapshot(lane, n))

    def _maybe_finish(self, lane: int, tok: int) -> None:
        req = self.scheduler.request_at(lane)
        done = req.remaining <= 0 or (
            self.serve.eos_token is not None and tok == self.serve.eos_token)
        if done:
            if self.prefix is not None:
                # KV exists for every fed token: prompt + produced[:-1]
                fed = np.concatenate(
                    [req.prompt, np.asarray(req.produced[:-1], np.int32)])
                self._prefix_insert(lane, fed)
            self._results[req.rid] = list(req.produced)
            self.obs.requests.on_finish(req.rid, len(req.produced))
            if self.obs.enabled:
                self.obs.trace.async_end(
                    f"req {req.rid}", req.rid, pid=PID_REQUESTS,
                    args={"tokens": len(req.produced),
                          "preemptions": req.preemptions})
            self.scheduler.finish(lane)
            if self.prefix is not None:
                # the lane's refs just dropped: the block cap can now bite
                self.prefix.enforce_cap()

    # ------------------------------------------------------ trace helpers
    # Modelled kernel lanes for every KV_LANE_STRIDE-th batched call: they
    # replay a fixed chunk schedule, so consecutive steps give near-equal
    # lanes, and emitting all of them would dominate the telemetry's cost.
    KV_LANE_STRIDE = 8

    def _kv_lane_events(self, t0: float, t1: float, lanes) -> None:
        self._kv_lane_calls += 1
        if (self._kv_lane_calls - 1) % self.KV_LANE_STRIDE:
            return
        g0 = self.kv.groups[0]
        counts = [len(g0.blocks_for(l)) if l in lanes else 0
                  for l in range(self.serve.slots)]
        paged_lane_events(
            self.obs.trace, counts, self.kv.cfg.max_blocks_per_seq,
            block_bytes=self.block_size * sum(self._group_token_bytes),
            t0_us=t0, dur_us=t1 - t0, pid=PID_KERNEL)

    def _trace_prefill(self, w, req, t0: float) -> None:
        """Prefill-chunk span on the lane's track, and modelled lanes of the
        chunk's weight-streaming matmul (the port's sm_90 plan)."""
        t1 = self.obs.now_us()
        self.obs.trace.complete(
            "prefill_chunk", t0, t1 - t0, pid=PID_SERVING,
            tid=TID_LANE0 + w.lane, cat="phase",
            args={"rid": req.rid, "tokens": len(w.tokens),
                  "real_tokens": w.real_tokens, "start_pos": w.start_pos,
                  "final": w.final})
        matmul_lane_events(
            self.obs.trace, len(w.tokens), self.cfg.d_model,
            self.cfg.d_model, itemsize=self.cfg.torch_dtype.itemsize,
            t0_us=t0, dur_us=t1 - t0, pid=PID_KERNEL)

    def _trace_batched(self, name: str, lanes, t0: float,
                       tokens: int) -> None:
        """Decode / verify span on the engine track, and modelled KV-ring
        lanes of the batched paged-attention read."""
        t1 = self.obs.now_us()
        self.obs.trace.complete(
            name, t0, t1 - t0, pid=PID_SERVING, tid=TID_ENGINE, cat="phase",
            args={"lanes": len(lanes), "tokens": tokens})
        self._kv_lane_events(t0, t1, lanes)

    @torch.no_grad()
    def step(self) -> bool:
        """One engine step: at most one prefill chunk + one batched decode
        (or verify) call over every decode-phase lane."""
        obs = self.obs
        step_t0 = self._lap_t = obs.now_us() if obs.enabled else 0.0
        plan = self.scheduler.schedule()
        if plan is None:
            if self.scheduler.pending:
                raise RuntimeError(
                    "paged pool cannot back even the oldest request "
                    f"({self.kv.cfg.num_blocks} blocks of {self.block_size}); "
                    "raise ServeConfig.num_blocks")
            return False
        self._lap("schedule")
        # copy-on-write forks queued by admission: copy pool rows before any
        # write of this step
        self._apply_pending_copies()
        prefill_tokens = decode_tokens = 0
        verify_tokens = drafted_tokens = accepted_tokens = 0
        read_tokens = 0
        attn_bytes_gather = attn_bytes_stream = 0
        mb_rows = self.kv.cfg.max_blocks_per_seq * self.block_size
        slots = self.serve.slots

        def _stream_bytes(lane: int) -> int:
            return sum(
                len(g.blocks_for(lane)) * self.block_size * gb
                for g, gb in zip(self.kv.groups, self._group_token_bytes))

        if plan.prefill:
            w = plan.prefill
            req = self.scheduler.request_at(w.lane)
            # shared blocks arrive through the tables read-only; the write
            # span must be the lane's own (fork_block saw to it)
            self.kv.assert_writable(w.lane, w.start_pos,
                                    w.start_pos + len(w.tokens))
            toks = w.tokens[None]
            self._seen("prefill_chunk", toks)
            dev_toks, tables = self._dev(toks), self._tables(w.lane)
            self._lap("upload")
            t0 = self._lap_t
            logits, self.caches = tf.prefill_chunk(
                self.params, self.cfg, dev_toks, self.caches, tables,
                w.start_pos, w.last_idx)
            self._lap("launch")
            if obs.enabled:
                self._trace_prefill(w, req, t0)
            prefill_tokens = len(w.tokens)
            read_tokens += w.start_pos + len(w.tokens)
            attn_bytes_gather += mb_rows * self._kv_token_bytes
            attn_bytes_stream += _stream_bytes(w.lane)
            if self._reclaims and w.real_tokens:
                self.kv.release_expired(
                    w.lane, w.start_pos + w.real_tokens - 1)
            if w.final:
                row = logits[0].float().cpu().numpy()
                self._lap("copy_back")
                tok = self._sample(row, req)
                req.produced.append(tok)
                obs.requests.on_first_token(req.rid)
                # the lane's whole context is written: publish it for
                # sharing while the lane decodes
                self._prefix_insert(w.lane, req.context)
                self.scheduler.to_decode(w.lane)
                self._maybe_finish(w.lane, tok)
            self._lap("bookkeeping")

        if plan.decode_lanes:
            toks = np.zeros((slots, 1), np.int32)
            positions = np.zeros((slots,), np.int32)
            active = np.zeros((slots,), bool)
            for lane in plan.decode_lanes:
                req = self.scheduler.request_at(lane)
                toks[lane, 0] = req.produced[-1]
                positions[lane] = req.decode_pos
                active[lane] = True
                read_tokens += req.decode_pos + 1
                self.kv.assert_writable(lane, req.decode_pos,
                                        req.decode_pos + 1)
            self._seen("decode", toks, positions, active)
            self._lap("bookkeeping")
            args = (self._dev(toks), self.caches, self._tables(),
                    self._dev(positions), self._dev(active))
            self._lap("upload")
            t0 = self._lap_t
            logits, self.caches = tf.decode_step_paged(
                self.params, self.cfg, *args)
            self._lap("launch")
            attn_bytes_gather += slots * mb_rows * self._kv_token_bytes
            attn_bytes_stream += sum(_stream_bytes(l) for l in range(slots))
            logits_np = logits.float().cpu().numpy()
            self._lap("copy_back")
            if obs.enabled:
                self._trace_batched("decode", plan.decode_lanes, t0,
                                    len(plan.decode_lanes))
            for lane in plan.decode_lanes:
                req = self.scheduler.request_at(lane)
                req.decode_pos += 1
                tok = self._sample(logits_np[lane, 0], req)
                req.produced.append(tok)
                if self._reclaims:
                    self.kv.release_expired(lane, req.decode_pos)
                self._maybe_finish(lane, tok)
            decode_tokens = len(plan.decode_lanes)
            self._lap("bookkeeping")

        if plan.verify:
            v = plan.verify
            S = self.draft_len + 1
            toks = np.zeros((slots, S), np.int32)
            positions = np.zeros((slots,), np.int32)
            active = np.zeros((slots,), bool)
            nvalid = np.zeros((slots,), np.int32)
            for lane, draft in zip(v.lanes, v.drafts):
                req = self.scheduler.request_at(lane)
                toks[lane, 0] = req.produced[-1]
                toks[lane, 1: 1 + len(draft)] = draft
                positions[lane] = req.decode_pos
                active[lane] = True
                nvalid[lane] = 1 + len(draft)
                read_tokens += req.decode_pos + 1 + len(draft)
                self.kv.assert_writable(lane, req.decode_pos,
                                        req.decode_pos + 1 + len(draft))
            self._seen("verify", toks, positions, active, nvalid)
            self._lap("bookkeeping")
            args = (self._dev(toks), self.caches, self._tables(),
                    self._dev(positions), self._dev(active),
                    self._dev(nvalid))
            self._lap("upload")
            t0 = self._lap_t
            logits, self.caches = tf.verify_step_paged(
                self.params, self.cfg, *args)
            self._lap("launch")
            attn_bytes_gather += slots * mb_rows * self._kv_token_bytes
            attn_bytes_stream += sum(_stream_bytes(l) for l in range(slots))
            logits_np = logits.float().cpu().numpy()
            self._lap("copy_back")
            if obs.enabled:
                self._trace_batched("verify", v.lanes, t0,
                                    int(np.sum(nvalid)))
            for lane, draft in zip(v.lanes, v.drafts):
                req = self.scheduler.request_at(lane)
                nd = len(draft)
                drafted_tokens += nd
                verify_tokens += nd + 1
                # greedy-exact acceptance: each emitted token is sampled from
                # the target logits at its own token index, so the stream is
                # the one plain decode gives; draft d_{i+1} survives only if
                # it equals the sampled token
                tok = -1
                for i in range(nd + 1):
                    tok = self._sample(logits_np[lane, i], req)
                    req.decode_pos += 1
                    req.produced.append(tok)
                    done = req.remaining <= 0 or (
                        self.serve.eos_token is not None
                        and tok == self.serve.eos_token)
                    matched = i < nd and tok == draft[i]
                    if matched:
                        accepted_tokens += 1
                    if done or not matched:
                        break
                # rollback: drop table entries past the accepted point;
                # stale rows inside kept blocks are masked and overwritten
                self.kv.truncate_blocks(
                    lane, -(-req.decode_pos // self.block_size))
                if self._reclaims:
                    self.kv.release_expired(lane, req.decode_pos)
                self._maybe_finish(lane, tok)
            self._lap("bookkeeping")

        tokens = prefill_tokens + decode_tokens + verify_tokens
        self._lap("bookkeeping")        # the laps now cover the step's wall
        row = self.metrics.record(
            tokens=tokens,
            prefill_tokens=prefill_tokens,
            prefill_real_tokens=(plan.prefill.real_tokens
                                 if plan.prefill else 0),
            decode_tokens=decode_tokens,
            verify_tokens=verify_tokens,
            drafted_tokens=drafted_tokens,
            accepted_tokens=accepted_tokens,
            blocks_in_use=self.kv.blocks_in_use,
            free_blocks=self.kv.num_free,
            queue_depth=self.scheduler.queue_depth,
            preempted=len(plan.preempted),
            prefix_hit_tokens=plan.prefix_hit_tokens,
            blocks_shared=self.kv.blocks_shared,
            param_bytes=self._param_bytes,
            kv_write_bytes=tokens * self._kv_token_bytes,
            kv_read_bytes=read_tokens * self._kv_token_bytes,
            # KV the prefix index served this step: prefill bytes that
            # never crossed HBM
            prefix_saved_bytes=plan.prefix_hit_tokens * self._kv_token_bytes,
            attn_bytes_gather=attn_bytes_gather,
            attn_bytes_stream=attn_bytes_stream,
            step_wall_us=(self._lap_t - step_t0) if obs.enabled else 0.0,
        )
        if obs.enabled:
            obs.trace.complete(
                "step", step_t0, row["step_wall_us"], pid=PID_SERVING,
                tid=TID_ENGINE, cat="step",
                args={"step": row["step"], "tokens": tokens,
                      "hbm_bytes": row["hbm_bytes"]})
            obs.trace.counter(
                "hbm bytes/step",
                {"total": row["hbm_bytes"], "stream": attn_bytes_stream},
                ts_us=step_t0, pid=PID_SERVING)
        return True

    @torch.no_grad()
    def defragment(self) -> None:
        """Compact each group's physical pool.  The pools are permuted in
        lockstep with the tables, one leaf at a time (the extra memory is
        one leaf's copy), and every holder of a moved shared block — other
        lanes' tables and the prefix index — is rewritten through the same
        old -> new map."""
        self._apply_pending_copies()      # copies name pre-permutation ids
        perms = self.kv.defragment()
        moved = {gi: self._dev(np.asarray(p, np.int64))
                 for gi, p in enumerate(perms)
                 if not np.array_equal(p, np.arange(len(p)))}
        for path, pool in _pool_leaves(self.caches):
            perm = moved.get(tf.cache_path_group(self.cfg, path))
            if perm is None:
                continue
            pool.copy_(pool[:, perm] if tf.is_stacked_cache_path(path)
                       else pool[perm])
        if self.prefix is not None:
            self.prefix.remap(tuple(PagedKVCache.old_to_new(p)
                                    for p in perms))

    def run(self, max_steps: int = 10_000):
        steps = 0
        while self.pending and steps < max_steps:
            self.step()
            steps += 1
        return self._results


def make_engine(cfg: ModelConfig, params: dict, serve: ServeConfig,
                draft_model: "tuple[ModelConfig, dict] | None" = None):
    """The paged engine when the architecture supports it, else the
    dense-cache engine (recurrent blocks; no speculation there)."""
    if tf.supports_paged(cfg if serve.dense_kernel is None
                         else cfg.with_(dense_kernel=serve.dense_kernel)):
        return ServingEngine(cfg, params, serve, draft_model=draft_model)
    from repro_torch.serving.dense_engine import DenseServingEngine
    return DenseServingEngine(cfg, params, serve)
