"""Radix-tree shared-prefix KV index over the paged block pools.

The generalized ping-pong lens: the scarce serving resource is off-chip
bytes per step, and the single largest source of REDUNDANT bytes is
re-prefilling identical prompt prefixes — every re-prefilled token re-reads
the full weight stream and re-writes its KV.  This index makes previously
computed prefix KV addressable by token content, so an admitted request maps
the matched blocks straight into its table and prefills only the novel
suffix: the bytes that must move are the ones that carry new information.

Structure
---------
A radix tree (path-compressed trie) over token sequences at KV-BLOCK
granularity: each edge/node covers a whole number of `block_size`-token
blocks, child edges are keyed by their first block's token tuple (two
sequences diverging INSIDE a block get sibling edges — blocks are the unit
of sharing, so a mid-block split has nothing to share).  A node owns, per
LAYER GROUP (`GroupedPagedCache`), one physical block id per covered block;
id 0 marks expired sliding-window coverage (reads land on the masked null
block).  A leaf may additionally carry a partially-filled TAIL block — the
last `k < block_size` tokens of an inserted sequence — which a matching
request adopts via copy-on-write (`fork_block`): the fork copies the block,
the new lane overwrites rows past the matched point, and nobody aliases.

Ownership
---------
Every non-null block a node references holds exactly one prefix-index
reference (`PagedKVCache.index_acquire`); lanes mapping the same block hold
their own references.  Blocks therefore survive the lanes that computed
them and return to the allocator only when evicted here AND unmapped
everywhere.  Eviction is LRU over ZERO-LANE-REF leaves (blocks held by the
index alone), wired into the scheduler's block-pressure path ahead of
preemption: cold cached prefixes are reclaimed before any running request
loses its KV.

Correctness at the window boundary
----------------------------------
A match of C tokens is only usable if every key position a future query can
still see is backed: for a layer group with sliding window W, positions
[C - W + 1, C) must map non-null blocks (older nulls are invisible to every
query at position >= C and harmless); for a global group any null coverage
ends the match.  `match` enforces both, and additionally caps C so the
request's padded prefill extent still fits the block table.

Pure host-side bookkeeping (numpy token compares + python dicts); device
pool copies for COW forks ride the cache's `pending_copies` queue.

This is a copy of `repro.serving.prefix` with one deliberate difference: a
miss is `PrefixHit(0, ((),) * groups)`, one empty block tuple per layer
group, so `blocks` keeps its documented shape on a miss too (the
reference returns `PrefixHit(0, ())`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.schedule import round_up
from repro_torch.serving.cache import GroupedPagedCache


@dataclasses.dataclass(frozen=True)
class PrefixHit:
    """One index probe result.

    tokens   matched token count C (0 = miss).  The caller skips prefilling
             [0, C) entirely; C is capped at len(query) - 1 so at least one
             token is computed to produce logits.
    blocks   per-group physical ids for the C // block_size fully-matched
             blocks (0 entries = expired window coverage, reads masked).
    tail     per-group physical ids of the partially-matched block backing
             tokens [C // bs * bs, C) when C is not block-aligned — the
             caller must map it copy-on-write (fork) before appending.
    """

    tokens: int
    blocks: "tuple[tuple[int, ...], ...]"
    tail: "tuple[int, ...] | None" = None


_NO_DRAFT = np.zeros((0,), np.int32)


def ngram_propose(tokens, k: int, *, max_ngram: int = 3,
                  min_ngram: int = 1) -> np.ndarray:
    """Prompt-lookup self-drafting: find the LATEST earlier occurrence of
    the sequence's own trailing n-gram and propose the up-to-`k` tokens
    that followed it (longest n tried first).  Pure token statistics — no
    weights are streamed to produce the draft, so every accepted token is
    a free amortization of the verify pass's weight read (the GPP
    bytes-per-useful-token argument).  Returns (d,) int32 with
    0 <= d <= k; empty = no draftable repetition."""
    toks = np.asarray(tokens, np.int32)
    L = int(toks.shape[0])
    if k < 1 or L < min_ngram + 1:
        return _NO_DRAFT
    for n in range(min(max_ngram, L - 1), min_ngram - 1, -1):
        pattern = toks[L - n:]
        # windows over toks[:L-1]: every occurrence has a continuation,
        # and the trailing n-gram itself (start L-n) is excluded
        windows = np.lib.stride_tricks.sliding_window_view(toks[: L - 1], n)
        hits = np.nonzero((windows == pattern).all(axis=1))[0]
        if len(hits):
            i = int(hits[-1])             # last occurrence: recency wins
            return toks[i + n : i + n + k].copy()
    return _NO_DRAFT


class _Node:
    __slots__ = ("tokens", "blocks", "tail_tokens", "tail_blocks",
                 "children", "parent", "last_used")

    def __init__(self, tokens: np.ndarray, blocks: "list[list[int]]",
                 parent: "_Node | None"):
        self.tokens = tokens              # (n*bs,) int32 — full blocks only
        self.blocks = blocks              # per-group, len n each
        self.tail_tokens: "np.ndarray | None" = None   # (k,), 1 <= k < bs
        self.tail_blocks: "list[int] | None" = None    # per-group
        self.children: "dict[tuple, _Node]" = {}
        self.parent = parent
        self.last_used = 0

    @property
    def nblocks(self) -> int:
        return len(self.blocks[0]) if self.blocks else 0


def _block_key(tokens: np.ndarray, off_blk: int, bs: int) -> tuple:
    return tuple(int(t) for t in tokens[off_blk * bs : (off_blk + 1) * bs])


class PrefixCache:
    """Radix-tree prefix index over a `GroupedPagedCache` (module docstring).

    max_blocks  cap on block references the index may hold (0 = unbounded);
                LRU leaves are evicted past it, and under pool pressure the
                scheduler calls `evict` regardless of the cap.
    """

    def __init__(self, cache: GroupedPagedCache, *, max_blocks: int = 0):
        self.cache = cache
        self.bs = cache.cfg.block_size
        self.G = cache.num_groups
        self.max_blocks = max_blocks
        self._miss = PrefixHit(0, ((),) * self.G)   # a miss: no blocks
        self.root = _Node(np.zeros((0,), np.int32),
                          [[] for _ in range(self.G)], None)
        self._tick = 0
        self.blocks_held = 0
        # stats
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0

    # ------------------------------------------------------------- helpers
    def _touch(self, node: "_Node") -> None:
        self._tick += 1
        while node is not None:
            node.last_used = self._tick
            node = node.parent

    def _acquire(self, gi: int, block: int) -> None:
        self.cache.groups[gi].index_acquire(block)
        self.blocks_held += 1
        self.inserted_blocks += 1

    def _release(self, gi: int, block: int) -> int:
        freed = self.cache.groups[gi].index_release(block)
        self.blocks_held -= 1
        return freed

    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    # --------------------------------------------------------------- match
    def match(self, tokens: np.ndarray, *, max_len: "int | None" = None,
              chunk: "int | None" = None) -> PrefixHit:
        """Longest reusable prefix of `tokens` (see module docstring for the
        window-coverage and at-least-one-computed-token caps).

        max_len / chunk: when given, C is further capped so the remaining
        context padded to chunk multiples — C + round_up(len - C, chunk) —
        fits a max_len-token block table (the prefill extent the scheduler
        will actually drive)."""
        bs = self.bs
        L = int(len(tokens))
        self.lookups += 1
        cap = L - 1
        if cap < 1:
            return self._miss

        blocks: "list[list[int]]" = [[] for _ in range(self.G)]
        null_flags: "list[list[bool]]" = [[] for _ in range(self.G)]
        node = self.root
        off = 0                       # fully matched blocks
        at_edge = True                # standing at a node boundary?
        div_j = 0                     # in-node stop index when not at_edge
        while (off + 1) * bs <= cap:
            child = node.children.get(_block_key(tokens, off, bs))
            if child is None:
                break
            j, cn = 0, child.nblocks
            stop_global = False
            while j < cn and (off + 1) * bs <= cap and np.array_equal(
                    child.tokens[j * bs : (j + 1) * bs],
                    tokens[off * bs : (off + 1) * bs]):
                ids = [child.blocks[gi][j] for gi in range(self.G)]
                if any(b == 0 and self.cache.horizons[gi] is None
                       for gi, b in enumerate(ids)):
                    stop_global = True   # global reach cannot tolerate holes
                    break
                for gi, b in enumerate(ids):
                    blocks[gi].append(b)
                    null_flags[gi].append(b == 0)
                off += 1
                j += 1
            self._touch(child)
            node = child
            at_edge = j == cn
            div_j = j
            if not at_edge or stop_global:
                break

        # partially-matching block at the stop point — the copy-on-write
        # candidate.  Sources: a stored partial tail, the first block of any
        # child whose tokens diverge mid-block, or the in-node block where
        # the walk stopped (divergence or the computed-token cap).  Whatever
        # matches the most leading tokens wins; the fork's stale rows past
        # the match are overwritten by the lane's own prefill.
        k2 = 0
        tail: "tuple[int, ...] | None" = None
        limit = cap - off * bs

        def consider(block_tokens, ids) -> None:
            nonlocal k2, tail
            if not all(ids):
                return               # cannot fork a null source block
            kk, lim = 0, min(len(block_tokens), limit)
            while kk < lim and int(block_tokens[kk]) == int(
                    tokens[off * bs + kk]):
                kk += 1
            if kk > k2:
                k2, tail = kk, tuple(ids)

        if limit > 0:
            if not at_edge:
                consider(node.tokens[div_j * bs : (div_j + 1) * bs],
                         [node.blocks[gi][div_j] for gi in range(self.G)])
            else:
                if node.tail_tokens is not None:
                    consider(node.tail_tokens, node.tail_blocks)
                for ch in node.children.values():
                    consider(ch.tokens[:bs],
                             [ch.blocks[gi][0] for gi in range(self.G)])

        C = off * bs + k2

        # cap to the block-table extent the scheduler will drive
        if max_len is not None and chunk is not None:
            while C and C + round_up(L - C, chunk) > max_len:
                C -= 1

        def build(C: int) -> PrefixHit:
            if C <= 0:
                return self._miss
            nfull, k = divmod(C, bs)
            t: "tuple[int, ...] | None" = None
            if k:
                if nfull < off:
                    # C was capped into the fully-matched region: fork the
                    # full block covering [nfull*bs, C) — its first k rows
                    # match, the rest is overwritten after the fork.
                    ids = [blocks[gi][nfull] for gi in range(self.G)]
                    if not all(ids):
                        return build(nfull * bs)   # can't fork a null block
                    t = tuple(ids)
                elif tail is not None and k <= k2:
                    t = tail
                else:
                    return build(nfull * bs)
            # window feasibility: every group with horizon W needs non-null
            # coverage of [C - W + 1, C)
            for gi, W in enumerate(self.cache.horizons):
                if W is None or C == 0:
                    continue
                nulls = null_flags[gi][:nfull + (1 if k else 0)]
                null_end = 0
                for j, isnull in enumerate(nulls):
                    if isnull:
                        null_end = (j + 1) * bs
                if null_end > max(0, C - (W - 1)):
                    return self._miss        # holes inside the live window
            return PrefixHit(
                C, tuple(tuple(blocks[gi][:nfull]) for gi in range(self.G)),
                t)

        hit = build(C)
        if hit.tokens:
            self.hits += 1
            self.hit_tokens += hit.tokens
        return hit

    # -------------------------------------------------------------- insert
    def insert(self, tokens: np.ndarray,
               blocks_by_group: "tuple[list[int], ...]") -> int:
        """Index `tokens` (every position's KV must be written) backed by
        the given per-group physical blocks (len ceil(len(tokens)/bs) each;
        0 entries = expired window coverage).

        Walks the tree adopting only NOVEL suffix blocks (+1 index ref
        each); spans already present keep the tree's canonical blocks, and a
        real block UPGRADES a null entry left by an earlier window-expired
        insert.  Returns the number of block references adopted.
        """
        bs = self.bs
        L = int(len(tokens))
        if L == 0:
            return 0
        nfull, k = divmod(L, bs)
        if any(len(b) != nfull + (1 if k else 0) for b in blocks_by_group) \
                or len(blocks_by_group) != self.G:
            raise ValueError(
                f"need {self.G} block lists of {nfull + (1 if k else 0)} "
                f"entries for {L} tokens")
        adopted = 0
        node = self.root
        off = 0
        while off < nfull:
            key = _block_key(tokens, off, bs)
            child = node.children.get(key)
            if child is None:
                adopted += self._add_child(node, tokens[off * bs : nfull * bs],
                                           [list(b[off:nfull])
                                            for b in blocks_by_group])
                off = nfull
                break
            m, cn = 1, child.nblocks             # key matched => block 0 does
            while m < cn and off + m < nfull and np.array_equal(
                    child.tokens[m * bs : (m + 1) * bs],
                    tokens[(off + m) * bs : (off + m + 1) * bs]):
                m += 1
            for gi in range(self.G):             # upgrade null coverage
                for j in range(m):
                    if child.blocks[gi][j] == 0 and blocks_by_group[gi][off + j]:
                        child.blocks[gi][j] = blocks_by_group[gi][off + j]
                        self._acquire(gi, child.blocks[gi][j])
                        adopted += 1
            if m < cn:
                child = self._split(child, m)
            self._touch(child)
            node = child
            off += m
        # locate the node ending exactly at block nfull for tail attachment
        target = self._descend_exact(tokens, nfull)
        if target is None:
            return adopted
        if k:
            adopted += self._attach_tail(
                target, tokens[nfull * bs :],
                [b[nfull] for b in blocks_by_group])
        self._touch(target)
        self.enforce_cap()
        return adopted

    def _add_child(self, node: "_Node", tokens: np.ndarray,
                   blocks: "list[list[int]]") -> int:
        """Create a child of `node` covering `tokens`, adopting its blocks.
        Drops a tail on `node` that aliases the child's first block (a
        re-insert of the same lane's now-full former tail).  Returns refs
        adopted."""
        if node.tail_blocks is not None and any(
                t and t == blocks[gi][0]
                for gi, t in enumerate(node.tail_blocks)):
            self._drop_tail(node)
        child = _Node(np.asarray(tokens, np.int32), blocks, node)
        adopted = 0
        for gi in range(self.G):
            for b in blocks[gi]:
                if b:
                    self._acquire(gi, b)
                    adopted += 1
        node.children[_block_key(tokens, 0, self.bs)] = child
        self._touch(child)
        return adopted

    def _split(self, child: "_Node", m: int) -> "_Node":
        """Split `child` at block boundary m: a new upper node keeps blocks
        [0, m); `child` keeps the rest (and its tail) underneath it.
        Returns the upper node."""
        bs = self.bs
        parent = child.parent
        upper = _Node(child.tokens[: m * bs],
                      [b[:m] for b in child.blocks], parent)
        upper.last_used = child.last_used
        parent.children[_block_key(upper.tokens, 0, bs)] = upper
        child.tokens = child.tokens[m * bs :]
        child.blocks = [b[m:] for b in child.blocks]
        child.parent = upper
        upper.children[_block_key(child.tokens, 0, bs)] = child
        return upper

    def _descend_exact(self, tokens: np.ndarray, nfull: int) -> "_Node | None":
        """The node whose covered span ends exactly at block `nfull` on the
        path spelled by `tokens` (root for nfull == 0)."""
        bs = self.bs
        node, off = self.root, 0
        while off < nfull:
            child = node.children.get(_block_key(tokens, off, bs))
            if child is None or off + child.nblocks > nfull:
                return None
            node = child
            off += child.nblocks
        return node

    def _attach_tail(self, node: "_Node", tail_tokens: np.ndarray,
                     tail_blocks: "list[int]") -> int:
        """Adopt a partial tail block at `node`.  Keep-longest policy: an
        existing tail survives unless the new one strictly extends it.  A
        tail is only useful if every group's block is real (forking needs
        source rows)."""
        if not all(tail_blocks):
            return 0
        if node.tail_tokens is not None:
            old = node.tail_tokens
            if not (len(tail_tokens) > len(old)
                    and np.array_equal(old, tail_tokens[: len(old)])):
                return 0
            self._drop_tail(node)
        # a child keyed by this span's block may already own the same
        # physical block (full-block re-insert arrived first): skip
        for child in node.children.values():
            if any(child.blocks[gi][0] == b
                   for gi, b in enumerate(tail_blocks) if b):
                return 0
        node.tail_tokens = np.asarray(tail_tokens, np.int32)
        node.tail_blocks = list(tail_blocks)
        for gi, b in enumerate(tail_blocks):
            self._acquire(gi, b)
        return len(tail_blocks)

    def _drop_tail(self, node: "_Node") -> int:
        freed = 0
        if node.tail_blocks is not None:
            for gi, b in enumerate(node.tail_blocks):
                if b:
                    freed += self._release(gi, b)
                    self.evicted_blocks += 1
        node.tail_tokens = None
        node.tail_blocks = None
        return freed

    # ------------------------------------------------------------ eviction
    def _leaves(self) -> "list[_Node]":
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and not n.children:
                out.append(n)
        return out

    def _evictable(self, node: "_Node") -> bool:
        """Zero-lane-ref: every real block is held by the index alone."""
        ids = [(gi, b) for gi in range(self.G) for b in node.blocks[gi] if b]
        if node.tail_blocks is not None:
            ids += [(gi, b) for gi, b in enumerate(node.tail_blocks) if b]
        return all(self.cache.groups[gi].ref_count[b] == 1 for gi, b in ids)

    def _release_node(self, node: "_Node") -> int:
        freed = self._drop_tail(node)
        for gi in range(self.G):
            for b in node.blocks[gi]:
                if b:
                    freed += self._release(gi, b)
                    self.evicted_blocks += 1
        parent = node.parent
        for key, ch in list(parent.children.items()):
            if ch is node:
                del parent.children[key]
        return freed

    def evict(self, min_blocks: int = 1) -> int:
        """LRU-evict zero-lane-ref leaves until at least `min_blocks` went
        back to the allocator (or nothing evictable remains).  Returns the
        number of blocks actually freed — the scheduler's block-pressure
        path calls this BEFORE preempting a running request."""
        freed = 0
        while freed < min_blocks:
            cands = [n for n in self._leaves() if self._evictable(n)]
            if not cands:
                # tails on interior nodes are individually reclaimable
                for n in self._walk():
                    if n.tail_blocks is not None and all(
                            self.cache.groups[gi].ref_count[b] == 1
                            for gi, b in enumerate(n.tail_blocks) if b):
                        freed += self._drop_tail(n)
                        if freed >= min_blocks:
                            return freed
                break
            victim = min(cands, key=lambda n: n.last_used)
            freed += self._release_node(victim)
        return freed

    def enforce_cap(self) -> None:
        """Evict LRU leaves down to `max_blocks` held references.  Called
        after every insert, and again by the engine whenever a lane is
        freed — blocks still mapped by a running lane are not evictable, so
        the cap can only take hold once the lane lets go."""
        while self.max_blocks and self.blocks_held > self.max_blocks:
            before = self.blocks_held
            self.evict(1)
            if self.blocks_held >= before:   # nothing evictable
                break

    # ----------------------------------------------------------- remapping
    def _walk(self) -> "list[_Node]":
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    def remap(self, old_to_new_by_group: "tuple[np.ndarray, ...]") -> None:
        """Rewrite every referenced block id after a pool defragmentation —
        MUST be called with `PagedKVCache.old_to_new(perm)` for each group
        whenever the cache defragments, or the index dangles."""
        for node in self._walk():
            for gi, o2n in enumerate(old_to_new_by_group):
                node.blocks[gi] = [int(o2n[b]) if b else 0
                                   for b in node.blocks[gi]]
                if node.tail_blocks is not None and node.tail_blocks[gi]:
                    node.tail_blocks[gi] = int(o2n[node.tail_blocks[gi]])

    # ------------------------------------------------------------ drafting
    def _stored_sequences(self) -> "list[np.ndarray]":
        """Token sequences stored in the tree — one per leaf or
        tail-carrying node, reconstructed root-to-node by ascending
        parents — most recently used first.  These are the token streams
        the index has KV for; as a side effect of being a radix tree over
        past traffic they double as the cross-request corpus for
        prompt-lookup drafting (`suffix_lookup`)."""
        seqs: "list[tuple[int, np.ndarray]]" = []
        for node in self._walk():
            if node is self.root and node.tail_tokens is None:
                continue
            if node.children and node.tail_tokens is None:
                continue                   # interior span: a longer stored
                #                            sequence covers it already
            parts = []
            n = node
            while n is not None:
                parts.append(n.tokens)
                n = n.parent
            toks = np.concatenate(parts[::-1])
            if node.tail_tokens is not None:
                toks = np.concatenate([toks, node.tail_tokens])
            if len(toks):
                seqs.append((node.last_used, toks))
        seqs.sort(key=lambda t: -t[0])
        return [t for _, t in seqs]

    def suffix_lookup(self, context, k: int, *, max_ngram: int = 3,
                      min_ngram: int = 1) -> np.ndarray:
        """Cross-request prompt-lookup: search the stored sequences for the
        trailing n-gram of `context` and return the up-to-`k` tokens that
        followed it (longest n first; most-recently-used sequence first;
        within a sequence the last occurrence wins).  Complements
        `ngram_propose`'s lane-local search when the repetition lives in
        ANOTHER request's history (multi-turn traffic).  Returns (d,)
        int32, empty on no match."""
        ctx = np.asarray(context, np.int32)
        L = int(ctx.shape[0])
        if k < 1 or L < min_ngram:
            return _NO_DRAFT
        for n in range(min(max_ngram, L), min_ngram - 1, -1):
            pattern = ctx[L - n:]
            for seq in self._stored_sequences():
                if len(seq) <= n:
                    continue
                windows = np.lib.stride_tricks.sliding_window_view(
                    seq[: len(seq) - 1], n)
                hits = np.nonzero((windows == pattern).all(axis=1))[0]
                if len(hits):
                    i = int(hits[-1])
                    return seq[i + n : i + n + k].astype(np.int32).copy()
        return _NO_DRAFT

    # ----------------------------------------------------------- test hooks
    def held_blocks(self) -> "tuple[dict[int, int], ...]":
        """Per-group {block id: refs held by the index} (each 1 by
        invariant) — cross-checked by `PagedKVCache.check_invariants`."""
        held: "tuple[dict[int, int], ...]" = tuple({} for _ in range(self.G))
        for node in self._walk():
            for gi in range(self.G):
                for b in node.blocks[gi]:
                    if b:
                        held[gi][b] = held[gi].get(b, 0) + 1
                if node.tail_blocks is not None and node.tail_blocks[gi]:
                    b = node.tail_blocks[gi]
                    held[gi][b] = held[gi].get(b, 0) + 1
        return held
