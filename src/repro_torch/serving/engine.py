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
    (`ngram_propose`), scored in one batched pass; rejected drafts roll back
    by block-table truncation.  Greedy streams are identical with
    speculation on or off.

PyTorch runs eagerly, so nothing is traced; `trace_counts` counts the
distinct input shapes each step function has seen and stays
{prefill_chunk: 1, decode: 1, verify: <= 1}.  The device pools are updated
in place by the step functions.

Sampling is greedy at temperature 0.  Above it, every draw uses a
`torch.Generator` seeded from (ServeConfig.seed, request id, token index):
deterministic whatever the lane assignment or interleaving, but not the
reference's `jax.random` bits, so parity with the reference is greedy only.

Not in this slice (raise if asked for): the prefix cache with copy-on-write
and `defragment`, the telemetry facade (`obs`), and draft-model drafting.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedule import (plan_serve_chunk, round_up,
                                       tokens_per_step_cov)
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import Spec, map_specs
from repro_torch.obs.ledger import BandwidthLedger
from repro_torch.serving.cache import GroupedPagedCache
from repro_torch.serving.prefix import ngram_propose
from repro_torch.serving.scheduler import ChunkedPrefillScheduler, Request


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
    # shared-prefix KV reuse: a later slice (None/False only)
    prefix_cache: "bool | None" = None
    # speculative decoding; None/0 = cfg.speculation / cfg.draft_len.
    # draft_source "self" only: prompt-lookup n-grams of the lane's history
    speculation: "bool | None" = None
    draft_len: int = 0
    draft_source: str = "self"
    # telemetry facade: a later slice (None/False only)
    obs: "bool | None" = None
    metrics_retention: "int | None" = None   # ledger rows kept; None = cfg
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


class ServingEngine:
    """Paged-KV continuous-batching engine (see module docstring)."""

    def __init__(self, cfg: ModelConfig, params: dict, serve: ServeConfig):
        if serve.prefix_cache or (serve.prefix_cache is None
                                  and cfg.prefix_cache):
            raise NotImplementedError(
                "the prefix cache (with copy-on-write) is not ported yet")
        if serve.obs or (serve.obs is None and cfg.obs):
            raise NotImplementedError(
                "the telemetry facade (obs) is not ported yet")
        if serve.draft_source != "self":
            raise NotImplementedError(
                "only draft_source='self' (n-gram self-drafting) is ported")
        if serve.dense_kernel is not None:
            cfg = cfg.with_(dense_kernel=serve.dense_kernel)
        if serve.paged_attn_kernel is not None:
            cfg = cfg.with_(paged_attn_kernel=serve.paged_attn_kernel)
        if not tf.supports_paged(cfg):
            raise ValueError(f"{cfg.name}: paged serving of these blocks is "
                             "not ported yet")
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
        self.prefix = None

        spec_on = (serve.speculation if serve.speculation is not None
                   else cfg.speculation)
        self.draft_len = (serve.draft_len or cfg.draft_len) if spec_on else 0
        self.draft_source = serve.draft_source

        self.scheduler = ChunkedPrefillScheduler(
            self.kv, slots=serve.slots, chunk=chunk, prefix=None,
            draft_len=self.draft_len,
            draft_fn=self._draft_for if self.draft_len else None,
            token_budget=budget)
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
        return rid

    def result(self, rid: int) -> "list[int] | None":
        return self._results.get(rid)

    @property
    def pending(self) -> int:
        return self.scheduler.pending

    def flatness_cov(self) -> float:
        """Coefficient of variation of tokens/step (lower = flatter)."""
        return tokens_per_step_cov([m["tokens"] for m in self.metrics])

    def acceptance_rate(self) -> float:
        drafted = self.metrics.total("drafted_tokens")
        accepted = self.metrics.total("accepted_tokens")
        return accepted / drafted if drafted else 0.0

    # ------------------------------------------------------------ engine
    def _sample(self, logits_row, req: Request) -> int:
        return sample_token(self.serve, req.rid, len(req.produced), logits_row)

    def _draft_for(self, req: Request, cap: int) -> np.ndarray:
        """Scheduler hook: up to `cap` draft tokens for `req`, mined from
        the lane's own prompt + produced history (no weights streamed)."""
        if cap < 1:
            return np.zeros((0,), np.int32)
        hist = np.concatenate(
            [req.prompt, np.asarray(req.produced, np.int32)])
        d = np.asarray(ngram_propose(hist, cap), np.int32)[:cap]
        if len(d):
            d = np.clip(d, 0, self.cfg.vocab_size - 1)
        return d

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

    def _maybe_finish(self, lane: int, tok: int) -> None:
        req = self.scheduler.request_at(lane)
        done = req.remaining <= 0 or (
            self.serve.eos_token is not None and tok == self.serve.eos_token)
        if done:
            self._results[req.rid] = list(req.produced)
            self.scheduler.finish(lane)

    @torch.no_grad()
    def step(self) -> bool:
        """One engine step: at most one prefill chunk + one batched decode
        (or verify) call over every decode-phase lane."""
        plan = self.scheduler.schedule()
        if plan is None:
            if self.scheduler.pending:
                raise RuntimeError(
                    "paged pool cannot back even the oldest request "
                    f"({self.kv.cfg.num_blocks} blocks of {self.block_size}); "
                    "raise ServeConfig.num_blocks")
            return False
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
            self.kv.assert_writable(w.lane, w.start_pos,
                                    w.start_pos + len(w.tokens))
            toks = w.tokens[None]
            self._seen("prefill_chunk", toks)
            logits, self.caches = tf.prefill_chunk(
                self.params, self.cfg, self._dev(toks), self.caches,
                self._tables(w.lane), w.start_pos, w.last_idx)
            prefill_tokens = len(w.tokens)
            read_tokens += w.start_pos + len(w.tokens)
            attn_bytes_gather += mb_rows * self._kv_token_bytes
            attn_bytes_stream += _stream_bytes(w.lane)
            if self._reclaims and w.real_tokens:
                self.kv.release_expired(
                    w.lane, w.start_pos + w.real_tokens - 1)
            if w.final:
                tok = self._sample(logits[0].float().cpu().numpy(), req)
                req.produced.append(tok)
                self.scheduler.to_decode(w.lane)
                self._maybe_finish(w.lane, tok)

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
            logits, self.caches = tf.decode_step_paged(
                self.params, self.cfg, self._dev(toks), self.caches,
                self._tables(), self._dev(positions), self._dev(active))
            attn_bytes_gather += slots * mb_rows * self._kv_token_bytes
            attn_bytes_stream += sum(_stream_bytes(l) for l in range(slots))
            logits_np = logits.float().cpu().numpy()
            for lane in plan.decode_lanes:
                req = self.scheduler.request_at(lane)
                req.decode_pos += 1
                tok = self._sample(logits_np[lane, 0], req)
                req.produced.append(tok)
                if self._reclaims:
                    self.kv.release_expired(lane, req.decode_pos)
                self._maybe_finish(lane, tok)
            decode_tokens = len(plan.decode_lanes)

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
            logits, self.caches = tf.verify_step_paged(
                self.params, self.cfg, self._dev(toks), self.caches,
                self._tables(), self._dev(positions), self._dev(active),
                self._dev(nvalid))
            attn_bytes_gather += slots * mb_rows * self._kv_token_bytes
            attn_bytes_stream += sum(_stream_bytes(l) for l in range(slots))
            logits_np = logits.float().cpu().numpy()
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

        tokens = prefill_tokens + decode_tokens + verify_tokens
        self.metrics.record(
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
            attn_bytes_gather=attn_bytes_gather,
            attn_bytes_stream=attn_bytes_stream,
        )
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while self.pending and steps < max_steps:
            self.step()
            steps += 1
        return self._results


def make_engine(cfg: ModelConfig, params: dict, serve: ServeConfig):
    """The paged engine; architectures it cannot serve raise (the reference's
    dense-cache fallback engine is not ported yet)."""
    return ServingEngine(cfg, params, serve)
