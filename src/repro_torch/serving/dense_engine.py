"""Dense-cache serving engine: the port of
`repro.serving.dense_engine.DenseServingEngine`, kept as

  * the engine of the recurrent architectures (mamba / xLSTM blocks carry
    O(1) state, not paged KV: chunked prefill of a padded prompt would push
    pad tokens through their state update);
  * the baseline the paged engine is compared against.

Design (the reference's): `slots` decode lanes over one dense
(slots, max_len) cache.  An idle lane is refilled from the queue by a
whole-prompt `transformer.prefill` (one input shape a distinct prompt
length), and decode runs one `transformer.decode_step` a distinct lane
position.  A decode call writes position `pos` of every row and advances
every row's recurrent state, so only the rows of the group at `pos` are
copied back into the engine's cache (one indexed copy a leaf); the other
lanes' rows stay as they were.

Like the reference, the engine passes the model token ids and nothing
else: a model of embedding inputs (musicgen) or of cross layers over
encoder embeddings (llama-3.2-vision) is refused at construction.  Those
run through `transformer.prefill` / `decode_step` with `embeds` / `enc`.

Each step records one row of the paged engine's ledger schema
(`obs.ledger.STEP_SCHEMA`): the weights streamed once a step, the cache
bytes each processed token writes and each participant's context reads,
with the bytes a token measured from the first prefill's cache.  With
`obs` on, request, prefill, decode and step spans go to `engine.obs`.
PyTorch runs eagerly, so `trace_counts` counts the distinct input shapes
each step function has seen: one prefill a prompt length, one decode.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.schedule import tokens_per_step_cov
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.obs import make_telemetry
from repro_torch.obs.ledger import BandwidthLedger
from repro_torch.obs.trace import (PID_REQUESTS, PID_SERVING, TID_ENGINE,
                                   TID_LANE0, annotate_serving_tracks)
from repro_torch.serving.engine import (ServeConfig, _pool_leaves, _to_device,
                                        sample_token)


@dataclasses.dataclass
class _Lane:
    request_id: "int | None" = None
    pos: int = 0
    remaining: int = 0
    tokens: list = dataclasses.field(default_factory=list)


def _leaf_at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _lane_dim(path) -> int:
    """The lane axis of a cache leaf: 1 under "blocks", else 0."""
    return 1 if tf.is_stacked_cache_path(path) else 0


class DenseServingEngine:
    """Dense-cache continuous-batching engine (see module docstring)."""

    def __init__(self, cfg: ModelConfig, params: dict, serve: ServeConfig):
        if serve.dense_kernel is not None:
            cfg = cfg.with_(dense_kernel=serve.dense_kernel)
        if cfg.input_mode != "tokens":
            needs = f"{cfg.input_mode} inputs"
        elif any(k.split(":")[0] == "cross"
                 for k in tuple(cfg.prefix_pattern) + tuple(cfg.pattern)):
            needs = "encoder embeddings for its cross layers"
        else:
            needs = None
        if needs:
            raise ValueError(
                f"{cfg.name}: the dense-cache engine passes token ids only, "
                f"and this model needs {needs} (run transformer.prefill / "
                "decode_step with embeds / enc)")
        self.device = resolve_device(serve.device)
        self.cfg = cfg
        self.serve = serve
        self.params = tf.serving_params(_to_device(params, self.device), cfg)
        self.lanes = [_Lane() for _ in range(serve.slots)]
        self._queue: "list[tuple[int, np.ndarray, int]]" = []
        self._results: "dict[int, list[int]]" = {}
        self._next_id = 0
        obs_on = serve.obs if serve.obs is not None else cfg.obs
        self.obs = make_telemetry(
            obs_on,
            trace_capacity=serve.trace_capacity or cfg.obs_trace_capacity)
        annotate_serving_tracks(self.obs.trace, serve.slots)
        self.metrics = BandwidthLedger(retention=(
            serve.metrics_retention if serve.metrics_retention is not None
            else cfg.metrics_retention))
        self._param_bytes = cfg.active_params() * cfg.torch_dtype.itemsize
        self._kv_token_bytes = 0   # from the first prefill's cache
        self._shapes = {"prefill": set(), "decode": set()}
        self.caches = None

    @property
    def trace_counts(self) -> "dict[str, int]":
        return {k: len(v) for k, v in self._shapes.items()}

    def _prefill(self, tokens: torch.Tensor):
        self._shapes["prefill"].add(tuple(tokens.shape))
        return tf.prefill(self.params, self.cfg, {"tokens": tokens},
                          max_len=self.serve.max_len)

    def _decode(self, tokens: torch.Tensor, pos: int):
        self._shapes["decode"].add(tuple(tokens.shape))
        return tf.decode_step(self.params, self.cfg, tokens, self.caches,
                              pos)

    # ---------------------------------------------------------------- API
    def submit(self, prompt: "list[int]", max_new_tokens: int = 32) -> int:
        rid = self._next_id
        self._next_id += 1
        self._queue.append((rid, np.asarray(prompt, np.int32),
                            max_new_tokens))
        self.obs.requests.on_submit(rid)
        if self.obs.enabled:
            self.obs.trace.async_begin(
                f"req {rid}", rid, pid=PID_REQUESTS,
                args={"prompt_tokens": len(prompt),
                      "max_new": max_new_tokens})
        return rid

    def _finish(self, rid: int, tokens: "list[int]") -> None:
        self._results[rid] = tokens
        self.obs.requests.on_finish(rid, len(tokens))
        if self.obs.enabled:
            self.obs.trace.async_end(f"req {rid}", rid, pid=PID_REQUESTS,
                                     args={"tokens": len(tokens)})

    def result(self, rid: int) -> "list[int] | None":
        return self._results.get(rid)

    @property
    def pending(self) -> int:
        return len(self._queue) + sum(
            1 for lane in self.lanes if lane.request_id is not None)

    def flatness_cov(self) -> float:
        """Coefficient of variation of tokens/step (prefill bursts make
        this engine's high; the paged engine's is the flat comparison)."""
        return tokens_per_step_cov([m["tokens"] for m in self.metrics])

    # ------------------------------------------------------------ engine
    def _admit(self) -> int:
        """Fill idle lanes from the queue.  Returns the prefill tokens
        processed (whole prompts)."""
        prefill_tokens = 0
        for i, lane in enumerate(self.lanes):
            if lane.request_id is not None or not self._queue:
                continue
            rid, prompt, max_new = self._queue.pop(0)
            t0 = self.obs.now_us() if self.obs.enabled else 0.0
            logits, caches = self._prefill(
                torch.from_numpy(prompt[None, :]).to(self.device))
            first = sample_token(self.serve, rid, 0,
                                 logits[0, -1].cpu().numpy())
            if self.obs.enabled:
                self.obs.trace.complete(
                    "prefill", t0, self.obs.now_us() - t0, pid=PID_SERVING,
                    tid=TID_LANE0 + i, cat="phase",
                    args={"rid": rid, "tokens": len(prompt)})
            prefill_tokens += len(prompt)
            self.obs.requests.on_first_token(rid)
            if max_new <= 1 or (self.serve.eos_token is not None
                                and first == self.serve.eos_token):
                # finished on the prefill-sampled token: never takes a lane
                self._finish(rid, [first])
                continue
            if self.caches is None:
                # an empty cache of `slots` lanes shaped like this one
                self.caches = _map_leaves(
                    lambda path, c: c.new_zeros(
                        c.shape[:_lane_dim(path)] + (self.serve.slots,)
                        + c.shape[_lane_dim(path) + 1:]), caches)
                # cache bytes a token (recurrent state amortized over the
                # max_len the cache was sized for)
                self._kv_token_bytes = sum(
                    c.numel() * c.element_size()
                    for _, c in _pool_leaves(caches)) // self.serve.max_len
            for path, pool in _pool_leaves(self.caches):
                d = _lane_dim(path)
                pool.select(d, i).copy_(_leaf_at(caches, path).select(d, 0))
            lane.request_id = rid
            lane.pos = len(prompt)
            lane.remaining = max_new - 1
            lane.tokens = [first]
        return prefill_tokens

    def _record_step(self, step_t0: float, prefill_tokens: int,
                     decode_tokens: int, read_tokens: int) -> None:
        """One ledger row of the shared schema; the paged-only fields stay
        at their zero defaults (no KV sharing, no speculation, no pool)."""
        tokens = prefill_tokens + decode_tokens
        row = self.metrics.record(
            tokens=tokens,
            prefill_tokens=prefill_tokens,
            prefill_real_tokens=prefill_tokens,   # never padded
            decode_tokens=decode_tokens,
            queue_depth=len(self._queue),
            param_bytes=self._param_bytes,
            kv_write_bytes=tokens * self._kv_token_bytes,
            kv_read_bytes=read_tokens * self._kv_token_bytes,
            step_wall_us=(self.obs.now_us() - step_t0
                          if self.obs.enabled else 0.0),
        )
        if self.obs.enabled:
            self.obs.trace.complete(
                "step", step_t0, row["step_wall_us"], pid=PID_SERVING,
                tid=TID_ENGINE, cat="step",
                args={"step": row["step"], "tokens": tokens,
                      "hbm_bytes": row["hbm_bytes"]})

    def _merge(self, new_caches, lanes_at: "list[int]") -> None:
        """Copy the rows of `lanes_at` from a decode's caches into the
        engine's; every other lane keeps its rows."""
        if len(lanes_at) == self.serve.slots:
            self.caches = new_caches
            return
        idx = torch.tensor(lanes_at, dtype=torch.long, device=self.device)
        for path, pool in _pool_leaves(self.caches):
            d = _lane_dim(path)
            pool.index_copy_(d, idx,
                             _leaf_at(new_caches, path).index_select(d, idx))

    def step(self) -> bool:
        """Admit, then one decode call a distinct lane position."""
        obs = self.obs
        step_t0 = obs.now_us() if obs.enabled else 0.0
        prefill_tokens = self._admit()
        if not any(lane.request_id is not None for lane in self.lanes):
            if prefill_tokens:
                # every admitted request finished on its first token: the
                # burst is still a step
                self._record_step(step_t0, prefill_tokens, 0, prefill_tokens)
                return True
            return False
        toks = np.zeros((self.serve.slots, 1), np.int32)
        groups: "dict[int, list[int]]" = {}
        for i, lane in enumerate(self.lanes):
            if lane.request_id is not None:
                toks[i, 0] = lane.tokens[-1]
                groups.setdefault(lane.pos, []).append(i)
        toks_dev = torch.from_numpy(toks).to(self.device)
        decode_tokens = 0
        read_tokens = prefill_tokens     # prefill attends its own context
        for pos, lanes_at in groups.items():
            t0 = obs.now_us() if obs.enabled else 0.0
            logits, new_caches = self._decode(toks_dev, pos)
            self._merge(new_caches, lanes_at)
            rows = logits[lanes_at, -1].cpu().numpy()
            if obs.enabled:
                obs.trace.complete(
                    "decode", t0, obs.now_us() - t0, pid=PID_SERVING,
                    tid=TID_ENGINE, cat="phase",
                    args={"pos": pos, "lanes": len(lanes_at)})
            for row, i in zip(rows, lanes_at):
                lane = self.lanes[i]
                nxt = sample_token(self.serve, lane.request_id,
                                   len(lane.tokens), row)
                lane.tokens.append(nxt)
                lane.pos += 1
                lane.remaining -= 1
                decode_tokens += 1
                read_tokens += lane.pos
                if lane.remaining <= 0 or (
                        self.serve.eos_token is not None
                        and nxt == self.serve.eos_token):
                    self._finish(lane.request_id, lane.tokens)
                    self.lanes[i] = _Lane()
        self._record_step(step_t0, prefill_tokens, decode_tokens,
                          read_tokens)
        return True

    def run(self, max_steps: int = 10_000):
        steps = 0
        while self.pending and steps < max_steps:
            self.step()
            steps += 1
        return self._results


def _map_leaves(fn, tree, path=()):
    """fn(path, leaf) over a cache tree of dicts / lists / None."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return None if tree is None else fn(path, tree)
