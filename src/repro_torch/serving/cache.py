"""Paged KV cache: fixed-size blocks + per-lane block tables over shared pools
(a copy of `repro.serving.cache`; pure numpy bookkeeping).

The serving analogue of the paper's macro pool: physical KV blocks are the
"macros", a lane's block table is its schedule slot assignment, and capacity
is `num_blocks * block_size` tokens shared across every lane — not
`slots * max_len` reserved per lane as in the dense seed cache.  A lane
holding a 6-token prompt pins one 16-token block, not a whole `max_len` row.

Physical blocks are REFCOUNTED: a block may be
mapped by several lanes at once (shared prompt prefix) and/or held by the
radix prefix index (`serving.prefix.PrefixCache`).  The sharing contract:

  * every mapping source holds one reference — each lane table entry is one
    ref, and the prefix index holds at most one ref per block
    (`index_acquire`/`index_release`, tracked separately in `index_ref` so
    write-aliasing checks can distinguish "shared with the index" — safe to
    append past the index's claimed tokens — from "shared with another
    lane" — never writable);
  * a block returns to the allocator only when its last reference drops;
  * a lane may only WRITE a block it holds exclusively (modulo the index);
    appending into a partially-filled shared block goes through `fork_block`
    (copy-on-write: remap the table entry to a fresh block, the engine
    copies the pool rows).

Layout contract (consumed by `models.attention` paged read/write and
`models.transformer.prefill_chunk` / `decode_step_paged`):

  * physical block 0 is RESERVED as a null/scratch block: unmapped table
    entries read it (masked out by the causal mask) and inactive decode
    lanes write into it, so the jitted step functions never branch on
    occupancy.
  * a lane's logical block `b` holds absolute positions
    `[b*block_size, (b+1)*block_size)`; table entry `tables[lane, b]` is the
    physical block id (0 while unmapped, released, or shared-as-null).

`GroupedPagedCache` stacks one `PagedKVCache` per LAYER GROUP — layers
bucketed by attention reach (`models.transformer.layer_group_keys`): global
layers in one group, sliding-window layers in another.  Each group has its
own block-id space, tables, and allocator, so `release_expired` frees a
windowed group's blocks even while a global group in the same model pins
full history (the gemma3 limitation the shared-table design had).

This module is pure host-side bookkeeping (numpy tables + free lists); the
device-side pools live in the engine's cache pytree, are permuted by the
engine when `defragment` hands back a physical-block permutation, and
receive copy-on-write block copies via the `pending_copies` queue the
engine drains each step before any model call.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class BlockAllocator:
    """Free-list allocator over physical blocks 1..num_blocks-1 (0 reserved).

    Allocation is all-or-nothing: a request for `n` blocks either returns
    `n` ids or None, so callers can fall back to preemption atomically.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the reserved null block)")
        self.num_blocks = num_blocks
        # LIFO free list: recently-freed blocks are re-used first (warm)
        self._free: list[int] = list(range(num_blocks - 1, 0, -1))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def capacity(self) -> int:
        """Allocatable blocks (excludes the reserved null block)."""
        return self.num_blocks - 1

    def allocate(self, n: int) -> "list[int] | None":
        if n < 0:
            raise ValueError("n >= 0")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        return out

    def free(self, blocks: "list[int]") -> None:
        for b in blocks:
            if not 1 <= b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
            if b in self._free:
                raise ValueError(f"double free of block {b}")
        self._free.extend(blocks)

    def reset_free(self, free: "list[int]") -> None:
        """Replace the free list (defragment rebuilds it compactly)."""
        self._free = list(free)


@dataclasses.dataclass(frozen=True)
class PagedCacheConfig:
    num_blocks: int          # physical blocks INCLUDING reserved block 0
    block_size: int          # tokens per block
    max_blocks_per_seq: int  # block-table width: max_len // block_size

    @property
    def max_len(self) -> int:
        return self.max_blocks_per_seq * self.block_size

    @property
    def token_capacity(self) -> int:
        """Tokens the pool can hold across all lanes (null block excluded)."""
        return (self.num_blocks - 1) * self.block_size


class PagedKVCache:
    """Refcounted block tables + allocator for `slots` lanes over one pool.

    Pools themselves (one per attention layer) live in the engine's cache
    pytree; this object owns which physical block backs which (lane,
    logical-block) coordinate and how many mappings each block has.
    """

    def __init__(self, *, slots: int, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int):
        self.cfg = PagedCacheConfig(num_blocks, block_size, max_blocks_per_seq)
        self.slots = slots
        self.allocator = BlockAllocator(num_blocks)
        self.tables = np.zeros((slots, max_blocks_per_seq), np.int32)
        self.num_mapped = np.zeros((slots,), np.int64)  # logical blocks mapped
        # logical blocks [0, released) were freed back after sliding-window
        # expiry (release_expired); their table entries read the null block
        self.released = np.zeros((slots,), np.int64)
        # reference counts: lane table entries + the prefix index each hold
        # one ref; a block is allocator-free iff ref_count == 0.  index_ref
        # flags the (at most one) prefix-index reference separately.
        self.ref_count = np.zeros((num_blocks,), np.int64)
        self.index_ref = np.zeros((num_blocks,), bool)

    # ------------------------------------------------------------ queries
    @property
    def blocks_in_use(self) -> int:
        return self.allocator.capacity - self.allocator.num_free

    @property
    def num_free(self) -> int:
        return self.allocator.num_free

    @property
    def blocks_shared(self) -> int:
        """Physical blocks currently mapped by more than one holder."""
        return int((self.ref_count >= 2).sum())

    def blocks_for(self, lane: int) -> "list[int]":
        """Physical blocks the lane still maps (released/null entries
        excluded; shared blocks included)."""
        return [int(b) for b in self.tables[lane, : self.num_mapped[lane]] if b]

    def table_snapshot(self, lane: int, nblocks: "int | None" = None) -> "list[int]":
        """The lane's first `nblocks` table entries INCLUDING zeros (released
        window entries / shared-null holes) — the prefix index adopts these
        verbatim so null coverage is visible to future matches."""
        n = int(self.num_mapped[lane]) if nblocks is None else nblocks
        if n > int(self.num_mapped[lane]):
            raise ValueError(
                f"lane {lane}: snapshot of {n} blocks but only "
                f"{int(self.num_mapped[lane])} mapped")
        return [int(b) for b in self.tables[lane, :n]]

    def blocks_needed(self, lane: int, upto_pos: int) -> int:
        """Additional blocks lane needs so position `upto_pos` is backed."""
        want = upto_pos // self.cfg.block_size + 1
        return max(0, want - int(self.num_mapped[lane]))

    # ------------------------------------------------------ ref accounting
    def _release(self, blocks: "list[int]") -> int:
        """Drop one (lane) reference per block; free those reaching zero.
        Returns the number of blocks returned to the allocator."""
        freed = []
        for b in blocks:
            if self.ref_count[b] <= 0:
                raise ValueError(f"release of unreferenced block {b}")
            self.ref_count[b] -= 1
            if self.ref_count[b] == 0:
                freed.append(b)
        if freed:
            self.allocator.free(freed)
        return len(freed)

    def index_acquire(self, block: int) -> None:
        """The prefix index adopts `block` (one ref; at most one per block)."""
        if not 1 <= block < self.cfg.num_blocks:
            raise ValueError(f"bad block id {block}")
        if self.index_ref[block]:
            raise ValueError(f"block {block} already index-held")
        if self.ref_count[block] <= 0:
            raise ValueError(f"index adoption of free block {block}")
        self.index_ref[block] = True
        self.ref_count[block] += 1

    def index_release(self, block: int) -> int:
        """Drop the prefix index's reference.  Returns 1 if the block went
        back to the allocator, else 0."""
        if not self.index_ref[block]:
            raise ValueError(f"block {block} not index-held")
        self.index_ref[block] = False
        return self._release([block])

    # --------------------------------------------------------- mutations
    def ensure(self, lane: int, upto_pos: int) -> bool:
        """Map blocks so `upto_pos` is writable.  False if the pool is out
        of free blocks (caller decides whether to evict/preempt)."""
        need = self.blocks_needed(lane, upto_pos)
        if need == 0:
            return True
        have = int(self.num_mapped[lane])
        if have + need > self.cfg.max_blocks_per_seq:
            raise ValueError(
                f"lane {lane}: position {upto_pos} exceeds the "
                f"{self.cfg.max_len}-token block table")
        blocks = self.allocator.allocate(need)
        if blocks is None:
            return False
        self.tables[lane, have : have + need] = blocks
        self.ref_count[blocks] = 1
        self.num_mapped[lane] = have + need
        return True

    def share_blocks(self, lane: int, blocks: "list[int]") -> None:
        """Map existing physical blocks (from the prefix index) into the
        lane's table, appending at the current high-water mark.  Zero
        entries map the null block (expired window coverage — reads are
        masked).  Each non-zero block gains one lane reference; the lane
        must treat shared blocks as READ-ONLY (append via `fork_block`)."""
        have = int(self.num_mapped[lane])
        if have + len(blocks) > self.cfg.max_blocks_per_seq:
            raise ValueError(
                f"lane {lane}: sharing {len(blocks)} blocks exceeds the "
                f"{self.cfg.max_blocks_per_seq}-entry table")
        for b in blocks:
            if b and self.ref_count[b] <= 0:
                raise ValueError(f"cannot share free block {b}")
        self.tables[lane, have : have + len(blocks)] = blocks
        for b in blocks:
            if b:
                self.ref_count[b] += 1
        self.num_mapped[lane] = have + len(blocks)

    def fork_block(self, lane: int, logical: int) -> "int | None":
        """Copy-on-write: make the lane's mapping of logical block `logical`
        exclusive so it can append into it.

        Returns the physical id now backing the entry: the ORIGINAL id when
        the lane already held it exclusively (no copy needed), a FRESH id
        when the block was shared (the caller must copy the pool rows old ->
        new before any write), or None when the pool has no free block for
        the copy (caller evicts/preempts and retries — already-forked
        entries are then exclusive, so the retry is idempotent)."""
        old = int(self.tables[lane, logical])
        if not old:
            raise ValueError(f"lane {lane}: logical block {logical} unmapped")
        if self.ref_count[old] == 1:
            # truly exclusive (a mapped entry's ref includes this lane, so
            # ref 1 implies no index claim either).  NOTE: an index-co-held
            # block (lane + index) is still COPIED — the index's tail claim
            # covers rows this fork may overwrite below the lane's append
            # point, so only a ref-1 block is handed back uncopied.
            return old
        got = self.allocator.allocate(1)
        if got is None:
            return None
        new = got[0]
        self.tables[lane, logical] = new
        self.ref_count[new] = 1
        self._release([old])
        return new

    def drop_last_shared(self, lane: int) -> None:
        """Undo the most recent single-block mapping (rollback of a failed
        multi-group tail fork at admission)."""
        have = int(self.num_mapped[lane])
        if have <= 0:
            raise ValueError(f"lane {lane}: nothing mapped")
        b = int(self.tables[lane, have - 1])
        if b:
            self._release([b])
        self.tables[lane, have - 1] = 0
        self.num_mapped[lane] = have - 1

    def free_lane(self, lane: int) -> None:
        n = int(self.num_mapped[lane])
        if n:
            # skip entries already zeroed by release_expired / null shares
            live = [int(b) for b in self.tables[lane, :n] if b]
            if live:
                self._release(live)
        self.tables[lane, :] = 0
        self.num_mapped[lane] = 0
        self.released[lane] = 0

    def release_expired(self, lane: int, pos: int, horizon: int) -> int:
        """Drop the lane's references on blocks that fell wholly behind the
        sliding-window horizon: with the next query at position `pos`, the
        oldest visible position is pos - horizon + 1, so logical block b is
        dead once (b+1)*block_size <= pos - horizon + 1 — for this query and
        every later one (positions only grow).  Table entries are zeroed
        (reads land on the null block, already hidden by the window mask);
        a block returns to the allocator only when no other lane and not the
        prefix index still holds it.  Returns the number of blocks freed.
        """
        if horizon < 1:
            raise ValueError("horizon >= 1")
        bs = self.cfg.block_size
        expire_end = min(max(0, pos - horizon + 1) // bs,
                         int(self.num_mapped[lane]))
        start = int(self.released[lane])
        if expire_end <= start:
            return 0
        blocks = [int(b) for b in self.tables[lane, start:expire_end] if b]
        freed = self._release(blocks) if blocks else 0
        self.tables[lane, start:expire_end] = 0
        self.released[lane] = expire_end
        return freed

    def truncate_blocks(self, lane: int, keep_blocks: int) -> int:
        """Roll back the lane's TAIL mappings so only the first
        `keep_blocks` logical blocks stay mapped (speculative-decode
        rollback: blocks ensured for rejected draft positions go straight
        back to the allocator).  Stale KV rows inside kept blocks need no
        scrubbing — the position-exact masks hide every row at or beyond
        the lane's next query position, and later writes overwrite them in
        place (the same argument that covers prefill-chunk pad rows).
        Returns the number of blocks freed."""
        if keep_blocks < 0:
            raise ValueError("keep_blocks >= 0")
        have = int(self.num_mapped[lane])
        if keep_blocks >= have:
            return 0
        blocks = [int(b) for b in self.tables[lane, keep_blocks:have] if b]
        freed = self._release(blocks) if blocks else 0
        self.tables[lane, keep_blocks:have] = 0
        self.num_mapped[lane] = keep_blocks
        return freed

    def assert_writable(self, lane: int, start_pos: int, end_pos: int) -> None:
        """No-write-aliasing guard: every mapped block covering token span
        [start_pos, end_pos) must be held by this lane alone (the prefix
        index's co-reference is allowed — it only claims tokens below the
        lane's write positions).  The paged-attention kernel and gather path
        only READ pools through tables; all writes funnel through the
        engine, which calls this before each prefill chunk / decode write.
        """
        bs = self.cfg.block_size
        for j in range(start_pos // bs, (end_pos - 1) // bs + 1):
            b = int(self.tables[lane, j])
            if b and self.ref_count[b] - int(self.index_ref[b]) != 1:
                raise AssertionError(
                    f"write aliasing: lane {lane} logical block {j} maps "
                    f"physical {b} with {int(self.ref_count[b])} refs "
                    f"(index_held={bool(self.index_ref[b])}) — shared "
                    "blocks are read-only; fork_block before appending")

    def defragment(self) -> np.ndarray:
        """Compact live blocks to the low end of the pool.

        Returns `perm` (shape (num_blocks,), int32) with
        `new_pool[i] = old_pool[perm[i]]` — the engine applies it to every
        device pool; tables, refcounts, and the free list are rewritten here
        so the compacted ids are contiguous (gathers touch one dense pool
        prefix, the locality the GPP streaming schedule wants).

        Shared blocks appear in MULTIPLE tables (and possibly the prefix
        index): `live` is deduplicated and every referencing table row is
        rewritten through one old->new map, so a moved shared block stays
        consistent for each holder.  The caller must remap the prefix index
        with the same map (`old_to_new(perm)`) in the same breath.
        """
        nb = self.cfg.num_blocks
        live: list[int] = [0]                        # null block stays put
        seen = {0}
        for lane in range(self.slots):
            for b in self.blocks_for(lane):          # skips released (0) slots
                if b not in seen:                    # dedup: shared blocks
                    seen.add(b)                      # appear in many tables
                    live.append(b)
        for b in range(1, nb):                       # index-only blocks are
            if self.ref_count[b] > 0 and b not in seen:   # live too
                seen.add(b)
                live.append(b)
        dead = [b for b in range(nb) if b not in seen]
        perm = np.asarray(live + dead, np.int32)
        assert perm.shape == (nb,)
        o2n = self.old_to_new(perm)
        for lane in range(self.slots):
            n = int(self.num_mapped[lane])
            if n:
                self.tables[lane, :n] = o2n[self.tables[lane, :n]]
        self.ref_count = self.ref_count[perm]
        self.index_ref = self.index_ref[perm]
        self.allocator.reset_free(list(range(nb - 1, len(live) - 1, -1)))
        return perm

    @staticmethod
    def old_to_new(perm: np.ndarray) -> np.ndarray:
        """Invert a defragment permutation into an old-id -> new-id map
        (what table rewrites and prefix-index remaps consume)."""
        o2n = np.empty(perm.shape[0], np.int64)
        o2n[perm] = np.arange(perm.shape[0])
        return o2n

    def check_invariants(self, index_held: "dict[int, int] | None" = None) -> None:
        """Test hook: refcounts must equal lane table mappings plus the
        index's claims, and the free list must be exactly the zero-ref
        blocks.  `index_held` maps block id -> index refs (0/1) as reported
        by the prefix index."""
        counts = np.zeros_like(self.ref_count)
        for lane in range(self.slots):
            for b in self.blocks_for(lane):
                counts[b] += 1
        counts[1:] += self.index_ref[1:].astype(np.int64)
        if index_held is not None:
            held = np.zeros_like(self.ref_count)
            for b, n in index_held.items():
                held[b] = n
            if not (held == self.index_ref.astype(np.int64)).all():
                raise AssertionError("prefix index claims != index_ref flags")
        if not (counts == self.ref_count).all():
            bad = np.nonzero(counts != self.ref_count)[0]
            raise AssertionError(
                f"refcount mismatch at blocks {bad.tolist()}: "
                f"mapped={counts[bad].tolist()} ref={self.ref_count[bad].tolist()}")
        free = sorted(self.allocator._free)
        zero = sorted(int(b) for b in range(1, self.cfg.num_blocks)
                      if self.ref_count[b] == 0)
        if free != zero:
            raise AssertionError(f"free list {free} != zero-ref blocks {zero}")


class GroupedPagedCache:
    """One `PagedKVCache` per layer group, behind the single-cache surface
    the scheduler drives.

    Groups bucket layers by attention reach (see
    `models.transformer.layer_group_keys`): `horizons[g]` is the group's
    sliding-window size or None for global reach.  Each group owns its own
    block-id space and tables, so `release_expired` reclaims a windowed
    group's blocks even while a global group pins full history — the paged
    pools for a gemma3-style 5-local:1-global stack plateau on the local
    layers instead of growing everywhere.

    `pending_copies` queues copy-on-write block copies as (group, src, dst)
    triples; the engine drains it into device pool copies at the start of
    each step, BEFORE any model write, so a forked block's contents are in
    place before the lane appends (and before a freed source id could be
    overwritten by this step's writes).
    """

    def __init__(self, *, slots: int, num_blocks: int, block_size: int,
                 max_blocks_per_seq: int,
                 horizons: "tuple[int | None, ...]" = (None,)):
        if not horizons:
            raise ValueError("need at least one layer group")
        self.groups = tuple(
            PagedKVCache(slots=slots, num_blocks=num_blocks,
                         block_size=block_size,
                         max_blocks_per_seq=max_blocks_per_seq)
            for _ in horizons)
        self.horizons = tuple(horizons)
        self.slots = slots
        self.pending_copies: "list[tuple[int, int, int]]" = []

    # ------------------------------------------------------------ queries
    @property
    def cfg(self) -> PagedCacheConfig:
        return self.groups[0].cfg

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def blocks_in_use(self) -> int:
        return sum(g.blocks_in_use for g in self.groups)

    @property
    def num_free(self) -> int:
        """Free blocks in the TIGHTEST group (the admission constraint)."""
        return min(g.num_free for g in self.groups)

    @property
    def blocks_shared(self) -> int:
        return sum(g.blocks_shared for g in self.groups)

    def blocks_for(self, lane: int) -> "tuple[list[int], ...]":
        return tuple(g.blocks_for(lane) for g in self.groups)

    def table_snapshot(self, lane: int, nblocks: int) -> "tuple[list[int], ...]":
        return tuple(g.table_snapshot(lane, nblocks) for g in self.groups)

    def blocks_needed(self, lane: int, upto_pos: int) -> int:
        return max(g.blocks_needed(lane, upto_pos) for g in self.groups)

    # --------------------------------------------------------- mutations
    def ensure(self, lane: int, upto_pos: int) -> bool:
        """Map blocks in EVERY group.  On a partial failure the groups
        already extended keep their mappings (they are needed regardless);
        the caller evicts/preempts and retries, and satisfied groups then
        need zero new blocks."""
        for g in self.groups:
            if not g.ensure(lane, upto_pos):
                return False
        return True

    def share_blocks(self, lane: int,
                     blocks_by_group: "tuple[list[int], ...]") -> None:
        lens = {len(b) for b in blocks_by_group}
        if len(blocks_by_group) != len(self.groups) or len(lens) != 1:
            raise ValueError("need one equal-length block list per group")
        for g, blocks in zip(self.groups, blocks_by_group):
            g.share_blocks(lane, blocks)

    def fork_tail(self, lane: int, logical: int) -> bool:
        """Copy-on-write the lane's `logical` table entry in every group,
        queueing pool copies.  False when some group's pool is dry — the
        caller rolls the tail share back (`drop_last_shared`); groups forked
        before the failure keep their (now exclusive) fresh blocks, which
        `drop_last_shared` then frees."""
        for gi, g in enumerate(self.groups):
            old = int(g.tables[lane, logical])
            if not old:
                continue            # null window coverage: nothing to fork
            new = g.fork_block(lane, logical)
            if new is None:
                return False
            if new != old:
                self.pending_copies.append((gi, old, new))
        return True

    def drop_last_shared(self, lane: int) -> None:
        dropped = []
        for gi, g in enumerate(self.groups):
            have = int(g.num_mapped[lane])
            dropped.append((gi, int(g.tables[lane, have - 1])))
            g.drop_last_shared(lane)
        # purge queued copies whose destination was just rolled back
        gone = set(dropped)
        self.pending_copies = [
            (gi, s, d) for gi, s, d in self.pending_copies
            if (gi, d) not in gone]

    def free_lane(self, lane: int) -> None:
        for g in self.groups:
            g.free_lane(lane)

    def release_expired(self, lane: int, pos: int) -> int:
        """Per-group window reclamation: each group with a finite horizon
        frees the lane's blocks wholly behind it; global groups keep
        everything.  Returns total blocks freed."""
        freed = 0
        for g, h in zip(self.groups, self.horizons):
            if h is not None:
                freed += g.release_expired(lane, pos, h)
        return freed

    def truncate_blocks(self, lane: int, keep_blocks: int) -> int:
        """Speculative rollback across every group (logical layouts are
        identical, so one keep-count serves all).  Returns blocks freed."""
        return sum(g.truncate_blocks(lane, keep_blocks) for g in self.groups)

    def assert_writable(self, lane: int, start_pos: int, end_pos: int) -> None:
        for g in self.groups:
            g.assert_writable(lane, start_pos, end_pos)

    def defragment(self) -> "tuple[np.ndarray, ...]":
        """Compact every group's pool; returns one permutation per group.
        The engine permutes each group's device pools with its perm and
        remaps the prefix index with `PagedKVCache.old_to_new(perm)`."""
        return tuple(g.defragment() for g in self.groups)

    def check_invariants(self,
                         index_held: "tuple[dict[int, int], ...] | None" = None
                         ) -> None:
        for gi, g in enumerate(self.groups):
            g.check_invariants(index_held[gi] if index_held else None)
