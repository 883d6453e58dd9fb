"""Token-budget continuous-batching scheduler with GPP-style chunked prefill
(a copy of `repro.serving.scheduler`; pure host-side Python).

The paper's problem: a bursty off-chip phase (weight rewrite) alternating
with compute starves the bus, so GPP splits the burst into chunks and issues
one chunk per compute slot — traffic goes flat.  Serving has the same
anti-pattern on the *request* axis: whole-prompt prefill is the burst, decode
steps are the compute slots.  This scheduler applies the same move:

  * prefill is split into fixed-size chunks (a multiple of the KV block
    size) and AT MOST ONE chunk runs per engine step, interleaved with the
    batched decode of every decode-phase lane — per-step token count (and
    hence per-step HBM traffic: weights stream once per step, KV writes are
    proportional to tokens) stays flat at ~`chunk + decode_lanes` instead of
    alternating `len(prompt)` spikes with single-token trickles;
  * one chunk size means ONE compiled prefill shape and one decode shape —
    the engine never re-jits per prompt length.

Shared-prefix reuse (serving/prefix.py): when a `PrefixCache` is attached,
admission probes it with the request's context and maps the matched blocks
straight into the lane's table — prefill then STARTS at the matched token
count (`Request.cached_tokens`), skipping those chunks entirely, so the
per-step budget they would have burned goes to decode and other prefills
instead.  A partially-filled matched tail block is mapped copy-on-write
(`fork_block` per layer group; the engine copies the pool rows before any
write).  Preemption resume re-probes: a victim's shares are dropped with its
blocks at preemption and the fresh admission path runs the probe again, so
a stale hit can never outlive the blocks it pointed at.

Policies:
  * FCFS admission: the waiting queue is served strictly in submission
    order; a free lane always takes the queue head.
  * Block pressure: when the shared pool runs dry the prefix index first
    LRU-evicts zero-lane-ref cached prefixes; only when nothing cold is
    left does the YOUNGEST running request get preempted (recompute-style:
    its blocks are freed and it re-queues at the front with its generated
    tokens carried, to be re-prefilled — possibly from cache — on resume).
    Victims are strictly younger than the requester, so the oldest request
    always makes progress — no starvation.

Pure host-side logic (no jax): unit-testable without a model.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core.schedule import plan_verify_budget, round_up
from repro_torch.obs.trace import NULL_TRACE, PID_SERVING, TID_LANE0
from repro_torch.serving.cache import GroupedPagedCache, PagedKVCache  # noqa: F401


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (plen,) int32
    max_new: int
    # mutable progress state -------------------------------------------------
    produced: list = dataclasses.field(default_factory=list)  # generated ids
    lane: int = -1
    context: "np.ndarray | None" = None  # tokens being (re-)prefilled
    prefill_pos: int = 0                 # next un-prefilled position
    decode_pos: int = -1                 # next KV write position in decode
    preemptions: int = 0
    cached_tokens: int = 0               # context tokens served by the prefix
                                         # cache at the LAST admission (their
                                         # prefill chunks are skipped)

    @property
    def plen(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def remaining(self) -> int:
        return self.max_new - len(self.produced)


@dataclasses.dataclass(frozen=True)
class PrefillWork:
    lane: int
    rid: int
    tokens: np.ndarray   # (chunk,) int32, zero-padded past the context
    start_pos: int
    last_idx: int        # chunk-local index of the context's last real token
    final: bool
    real_tokens: int     # non-pad tokens in this chunk


@dataclasses.dataclass(frozen=True)
class VerifyWork:
    """One batched speculative-verify call: every decode-phase lane rides
    it (draftless lanes with an empty draft — their row degenerates to
    plain decode), so across a mixed workload the engine still traces ONE
    verify shape and ONE decode shape."""
    lanes: "tuple[int, ...]"              # decode-phase lanes, rid order
    drafts: "tuple[tuple[int, ...], ...]"  # per lane, possibly ()

    @property
    def draft_tokens(self) -> int:
        return sum(len(d) for d in self.drafts)


@dataclasses.dataclass(frozen=True)
class StepPlan:
    prefill: Optional[PrefillWork]
    decode_lanes: "tuple[int, ...]"
    preempted: "tuple[int, ...]"      # rids preempted while planning
    prefix_hit_tokens: int = 0        # context tokens served from the prefix
                                      # cache by admissions in this plan
    verify: "VerifyWork | None" = None  # replaces decode_lanes when set

    @property
    def scheduled_tokens(self) -> int:
        """Tokens this step carries (pads included: they occupy the same
        compute/HBM footprint — this is the flatness quantity)."""
        v = (sum(1 + len(d) for d in self.verify.drafts)
             if self.verify else 0)
        return (len(self.prefill.tokens) if self.prefill else 0) \
            + len(self.decode_lanes) + v


class ChunkedPrefillScheduler:
    PREFILL = "prefill"
    DECODE = "decode"

    def __init__(self, cache, *, slots: int, chunk: int, prefix=None,
                 draft_len: int = 0, draft_fn=None, token_budget: int = 0,
                 trace=None):
        bs = cache.cfg.block_size
        if chunk < 1 or chunk % bs:
            raise ValueError(f"chunk {chunk} must be a positive multiple of "
                             f"the block size {bs}")
        if prefix is not None and not isinstance(cache, GroupedPagedCache):
            raise ValueError("prefix caching needs a GroupedPagedCache "
                             "(per-group tables + refcounted shares)")
        if draft_len < 0:
            raise ValueError("draft_len >= 0")
        self.cache = cache
        self.slots = slots
        self.chunk = chunk
        self.prefix = prefix
        # speculative decoding: draft_fn(req, cap) -> up-to-cap int tokens
        # the engine guesses will follow req's stream; verify scores them
        # in one batched call.  token_budget bounds drafts to the step's
        # flatness slack (plan_verify_budget).
        self.draft_len = draft_len
        self.draft_fn = draft_fn
        self.token_budget = token_budget
        # scheduling-decision instants (admit/resume/preempt, with prefix-
        # hit annotations) land on the owning lane's trace track; the
        # default NULL_TRACE makes every emit a no-op
        self.trace = trace if trace is not None else NULL_TRACE
        self.waiting: "deque[Request]" = deque()
        self.running: "dict[int, Request]" = {}     # lane -> Request
        self.phase: "dict[int, str]" = {}           # lane -> PREFILL|DECODE
        self.max_len = cache.cfg.max_len

    # ---------------------------------------------------------------- API
    def submit(self, req: Request) -> None:
        # worst-case resume context is prompt + (max_new - 1) generated
        # tokens, padded up to a chunk multiple — must fit the block table
        if round_up(req.plen + req.max_new, self.chunk) > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {req.plen} + max_new "
                f"{req.max_new} cannot fit the {self.max_len}-token table "
                f"(chunk {self.chunk})")
        if req.max_new < 1:
            raise ValueError("max_new >= 1")
        self.waiting.append(req)

    @property
    def pending(self) -> int:
        return len(self.waiting) + len(self.running)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    def request_at(self, lane: int) -> Request:
        return self.running[lane]

    def to_decode(self, lane: int) -> None:
        """Engine signal: final chunk done, first token sampled."""
        req = self.running[lane]
        self.phase[lane] = self.DECODE
        req.decode_pos = len(req.context)

    def finish(self, lane: int) -> Request:
        req = self.running.pop(lane)
        self.phase.pop(lane)
        self.cache.free_lane(lane)
        req.lane = -1
        return req

    # ---------------------------------------------------------- planning
    def _free_lanes(self) -> "list[int]":
        return [l for l in range(self.slots) if l not in self.running]

    def _probe_prefix(self, req: Request) -> int:
        """Map the longest reusable cached prefix of `req.context` into the
        lane's tables.  Fully-matched blocks are shared read-only; a
        partially-matched tail block is shared then immediately forked
        (copy-on-write) per layer group, since the lane will append into it.
        Returns the cached token count (prefill starts there)."""
        hit = self.prefix.match(req.context, max_len=self.max_len,
                                chunk=self.chunk)
        C = hit.tokens
        if not C:
            return 0
        bs = self.cache.cfg.block_size
        nfull = C // bs
        self.cache.share_blocks(
            req.lane, tuple(list(b) for b in hit.blocks))
        if hit.tail is not None:
            self.cache.share_blocks(
                req.lane, tuple([t] for t in hit.tail))
            if not self.cache.fork_tail(req.lane, nfull):
                # pool too dry to copy the tail block (admission never
                # preempts).  `match` validated window-null feasibility at
                # the ORIGINAL C only, so on a model with windowed groups
                # the block-aligned truncation could pull expired null
                # coverage into the live window — drop the whole share
                # there; global-only models keep the always-feasible floor.
                self.cache.drop_last_shared(req.lane)
                if any(h is not None for h in self.cache.horizons):
                    self.cache.free_lane(req.lane)
                    return 0
                C = nfull * bs
        return C

    def _admit(self) -> int:
        hit_tokens = 0
        for lane in self._free_lanes():
            if not self.waiting:
                break
            req = self.waiting.popleft()
            req.lane = lane
            req.context = np.concatenate(
                [req.prompt, np.asarray(req.produced, np.int32)])
            req.decode_pos = -1
            req.cached_tokens = (self._probe_prefix(req)
                                 if self.prefix is not None else 0)
            req.prefill_pos = req.cached_tokens
            hit_tokens += req.cached_tokens
            self.running[lane] = req
            self.phase[lane] = self.PREFILL
            if self.trace.enabled:
                self.trace.instant(
                    "resume" if req.preemptions else "admit",
                    pid=PID_SERVING, tid=TID_LANE0 + lane, cat="sched",
                    args={"rid": req.rid, "context_tokens": len(req.context),
                          "prefix_hit_tokens": req.cached_tokens,
                          "preemptions": req.preemptions})
        return hit_tokens

    def _preempt_youngest(self, than_rid: int) -> "Request | None":
        """Free the youngest running request strictly younger than
        `than_rid`; re-queue it at the FRONT (it stays ahead of never-
        admitted requests, preserving FCFS).  The victim's prefix-cache
        shares are dropped with its blocks; the fresh admission on resume
        RE-PROBES the index, so no stale hit survives preemption."""
        victims = [r for r in self.running.values() if r.rid > than_rid]
        if not victims:
            return None
        victim = max(victims, key=lambda r: r.rid)
        lane = victim.lane
        self.cache.free_lane(lane)
        self.running.pop(lane)
        self.phase.pop(lane)
        victim.lane = -1
        victim.context = None
        victim.prefill_pos = 0
        victim.decode_pos = -1
        victim.cached_tokens = 0
        victim.preemptions += 1
        self.waiting.appendleft(victim)
        if self.trace.enabled:
            self.trace.instant(
                "preempt", pid=PID_SERVING, tid=TID_LANE0 + lane,
                cat="sched",
                args={"rid": victim.rid, "for_rid": than_rid,
                      "produced": len(victim.produced)})
        return victim

    def _ensure_blocks(self, req: Request, upto_pos: int,
                       preempted: "list[int]") -> bool:
        while not self.cache.ensure(req.lane, upto_pos):
            if self.prefix is not None and self.prefix.evict(
                    self.cache.blocks_needed(req.lane, upto_pos)):
                continue                   # cold cached prefixes go first
            victim = self._preempt_youngest(req.rid)
            if victim is None:
                return False
            preempted.append(victim.rid)
        return True

    def schedule(self) -> "StepPlan | None":
        """Plan one engine step: at most one prefill chunk + every decode
        lane whose next block is (made) available.  Requests are visited
        oldest-first, so preemption victims (always younger) are never
        already in the plan.  Returns None when nothing is runnable."""
        hit_tokens = self._admit()
        if not self.running:
            return None
        preempted: "list[int]" = []
        prefill: "PrefillWork | None" = None
        decode: "list[int]" = []
        for req in sorted(self.running.values(), key=lambda r: r.rid):
            if req.lane not in self.running or self.running[req.lane] is not req:
                continue                       # preempted while planning
            if self.phase[req.lane] == self.DECODE:
                if self._ensure_blocks(req, req.decode_pos, preempted):
                    decode.append(req.lane)
                continue
            if prefill is not None:
                continue                       # one chunk per step (one shape)
            ctx = req.context
            start = req.prefill_pos            # cached_tokens on chunk one —
            #                                    may be ANY token index; the
            #                                    paged write path scatters at
            #                                    token granularity
            if not self._ensure_blocks(req, start + self.chunk - 1, preempted):
                continue
            toks = np.zeros(self.chunk, np.int32)
            real = ctx[start : min(len(ctx), start + self.chunk)]
            toks[: len(real)] = real
            final = start + self.chunk >= len(ctx)
            prefill = PrefillWork(
                lane=req.lane, rid=req.rid, tokens=toks, start_pos=start,
                last_idx=(len(ctx) - 1 - start) if final else 0,
                final=final, real_tokens=len(real))
            req.prefill_pos = start + self.chunk
        if prefill is None and not decode:
            return None
        verify = self._plan_verify(prefill, decode)
        if verify is not None:
            decode = []                    # those lanes ride the verify call
        # no victim re-filter needed: requests are visited oldest-first and
        # victims are strictly younger than the requester, so a lane already
        # planned can never have been preempted while planning
        return StepPlan(prefill=prefill, decode_lanes=tuple(decode),
                        preempted=tuple(preempted),
                        prefix_hit_tokens=hit_tokens, verify=verify)

    def _plan_verify(self, prefill: "PrefillWork | None",
                     decode: "list[int]") -> "VerifyWork | None":
        """Attach speculative drafts to this step's decode lanes, bounded by
        the flatness slack `plan_verify_budget` leaves after the prefill
        chunk and the decode tokens (drafts mostly ride decode-only steps —
        a prefill-carrying step's chunk already fills the budget).  Drafts
        NEVER preempt or evict: a lane's draft shrinks until its blocks fit
        the free pool (speculative tokens are the lowest-priority bytes in
        the system).  Returns None when no lane drafted anything — the step
        then uses the plain decode shape."""
        if self.draft_len < 1 or self.draft_fn is None or not decode:
            return None
        avail = plan_verify_budget(
            token_budget=self.token_budget,
            prefill_tokens=len(prefill.tokens) if prefill else 0,
            decode_lanes=len(decode))
        drafts: "list[tuple[int, ...]]" = []
        for lane in decode:                # rid order: oldest drafts first
            req = self.running[lane]
            # remaining-1: the verify emits >= 1 token, so at most
            # remaining-1 drafts can ever be accepted — also keeps the
            # write span inside the submit()-validated table extent
            cap = min(self.draft_len, req.remaining - 1, avail)
            d = (np.asarray(self.draft_fn(req, cap), np.int32)[:cap]
                 if cap > 0 else np.zeros((0,), np.int32))
            while len(d) and self.cache.blocks_needed(
                    lane, req.decode_pos + len(d)) > self.cache.num_free:
                d = d[:-1]
            if len(d) and not self.cache.ensure(lane,
                                                req.decode_pos + len(d)):
                d = d[:0]                  # unreachable: fit checked above
            avail -= len(d)
            drafts.append(tuple(int(t) for t in d))
        if not any(drafts):
            return None
        return VerifyWork(lanes=tuple(decode), drafts=tuple(drafts))
