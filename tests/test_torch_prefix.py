"""The port's prefix cache (`repro_torch.serving.prefix`, a radix index over
paged KV blocks) and its engine path, against the JAX package's on the
CPU.

  * One scripted sequence of `insert` / `match` / `evict` / `enforce_cap` /
    `remap` (after `defragment`) / `suffix_lookup` calls, drawn from a numpy
    RNG, runs on both packages' `PrefixCache`s over their (identical)
    `GroupedPagedCache`s: equal hit tokens, and on hits equal blocks and
    tails, equal evictions, equal LRU order and equal held blocks.  The
    parity never indexes `blocks` on a miss: the reference's miss is
    `PrefixHit(0, ())`, the port's one empty tuple a group.
  * A hypothesis property: the port's hit blocks spell the query, misses
    included (where the reference's `test_match_blocks_spell_the_query`
    fails on its miss shape).
  * The engine: copy-on-write forks land the source rows in every pool
    leaf before the step's writes, `defragment` leaves every lane's
    logical KV unchanged, and greedy streams at float32 on qwen1.5-0.5b,
    deepseek-v2-lite-16b and gemma3-12b SMOKE with the prefix on equal the
    JAX engine's with the prefix on and the port's with it off, through
    sequential rounds that hit a shared prefix, a multi-turn follow-up
    whose match is not block-aligned, preemption and resume under a tight
    pool, and a `defragment` every third step.
"""
import numpy as np
import pytest
import torch

import jax

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st

from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving.cache import GroupedPagedCache as JCache
from repro.serving.cache import PagedKVCache as JPaged
from repro.serving.prefix import PrefixCache as JPrefix
from repro_torch.bridge import config_from_reference
from repro_torch.serving.cache import GroupedPagedCache, PagedKVCache
from repro_torch.serving.engine import ServeConfig, ServingEngine
from repro_torch.serving.prefix import PrefixCache

from _torch_parity import tree_to_torch

pytestmark = pytest.mark.tier1

BS = 4


def _pair(horizons, num_blocks=41, slots=3, mb=12, max_blocks=0):
    kw = dict(slots=slots, num_blocks=num_blocks, block_size=BS,
              max_blocks_per_seq=mb, horizons=horizons)
    jkv, kv = JCache(**kw), GroupedPagedCache(**kw)
    return (jkv, JPrefix(jkv, max_blocks=max_blocks)), \
        (kv, PrefixCache(kv, max_blocks=max_blocks))


def _lane_insert(kv, pc, lane, toks):
    assert kv.ensure(lane, len(toks) - 1)
    return pc.insert(toks, kv.table_snapshot(lane, -(-len(toks) // BS)))


def _lru(pc):
    return sorted((tuple(int(t) for t in n.tokens), n.last_used,
                   None if n.tail_tokens is None
                   else tuple(int(t) for t in n.tail_tokens))
                  for n in pc._walk())


def _same_hit(jh, h):
    assert h.tokens == jh.tokens
    if h.tokens:                      # the reference's miss has no groups
        assert h.blocks == jh.blocks and h.tail == jh.tail


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("horizons", ((None,), (2 * BS, None)),
                         ids=("global", "window+global"))
def test_index_calls_match_reference(horizons, seed):
    rng = np.random.default_rng(seed)
    (jkv, jpc), (kv, pc) = _pair(horizons, max_blocks=10 * (seed % 2))
    stems = [rng.integers(0, 5, rng.integers(3, 3 * BS)) for _ in range(3)]

    def seq():
        s = stems[rng.integers(len(stems))]
        tail = rng.integers(0, 5, rng.integers(0, 2 * BS))
        return np.concatenate([s, tail]).astype(np.int32)[:10 * BS]

    lanes = [None] * 3
    for _ in range(40):
        op = rng.integers(6)
        lane = int(rng.integers(3))
        if op <= 1 and lanes[lane] is None:
            toks = seq()
            if len(toks) > 1:
                assert _lane_insert(kv, pc, lane, toks) == \
                    _lane_insert(jkv, jpc, lane, toks)
                lanes[lane] = toks
        elif op == 2 and lanes[lane] is not None:
            kv.free_lane(lane)
            jkv.free_lane(lane)
            lanes[lane] = None
            pc.enforce_cap()
            jpc.enforce_cap()
        elif op == 3:
            n = int(rng.integers(1, 4))
            assert pc.evict(n) == jpc.evict(n)
        elif op == 4:
            perms, jperms = kv.defragment(), jkv.defragment()
            assert all(np.array_equal(a, b) for a, b in zip(perms, jperms))
            pc.remap(tuple(PagedKVCache.old_to_new(p) for p in perms))
            jpc.remap(tuple(JPaged.old_to_new(p) for p in jperms))
        else:
            q = seq()
            _same_hit(jpc.match(q), pc.match(q))
            _same_hit(jpc.match(q, max_len=6 * BS, chunk=2 * BS),
                      pc.match(q, max_len=6 * BS, chunk=2 * BS))
            np.testing.assert_array_equal(pc.suffix_lookup(q, 3),
                                          jpc.suffix_lookup(q, 3))
        assert _lru(pc) == _lru(jpc)
        assert pc.held_blocks() == jpc.held_blocks()
        assert pc.blocks_held == jpc.blocks_held
        kv.check_invariants(pc.held_blocks())
    assert (pc.lookups, pc.hits, pc.hit_tokens, pc.evicted_blocks) == \
        (jpc.lookups, jpc.hits, jpc.hit_tokens, jpc.evicted_blocks)


def test_a_miss_has_one_empty_tuple_a_group():
    # the reference's minimal case: insert [2], query [3]
    kv = GroupedPagedCache(slots=1, num_blocks=9, block_size=BS,
                           max_blocks_per_seq=4, horizons=(8, None))
    pc = PrefixCache(kv)
    _lane_insert(kv, pc, 0, np.asarray([2], np.int32))
    hit = pc.match(np.asarray([3, 3], np.int32))
    assert hit.tokens == 0 and hit.blocks == ((), ()) and hit.tail is None
    assert pc.match(np.asarray([3], np.int32)).blocks == ((), ())


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=30, deadline=None)
@given(st.lists(st.lists(st.integers(0, 3), min_size=1, max_size=20),
                min_size=1, max_size=6),
       st.lists(st.integers(0, 3), min_size=1, max_size=20))
def test_hit_blocks_spell_the_query(seqs, query):
    """Whatever the insert history, a probe's blocks cover exactly the
    query's leading tokens, misses included, with C <= len - 1."""
    kv = GroupedPagedCache(slots=1, num_blocks=257, block_size=BS,
                           max_blocks_per_seq=8, horizons=(None,))
    pc = PrefixCache(kv)
    spelled = {}                       # physical block -> its tokens
    for s in seqs:
        toks = np.asarray(s[: 8 * BS], np.int32)
        _lane_insert(kv, pc, 0, toks)
        for j, b in enumerate(kv.groups[0].table_snapshot(
                0, -(-len(toks) // BS))):
            spelled[b] = toks[j * BS: (j + 1) * BS]
        kv.free_lane(0)
    q = np.asarray(query, np.int32)
    hit = pc.match(q)
    assert 0 <= hit.tokens <= max(0, len(q) - 1)
    nfull = hit.tokens // BS
    assert len(hit.blocks) == 1 and len(hit.blocks[0]) == nfull
    for j, b in enumerate(hit.blocks[0]):
        np.testing.assert_array_equal(spelled[b], q[j * BS: (j + 1) * BS])
    if hit.tail is not None:
        k = hit.tokens - nfull * BS
        np.testing.assert_array_equal(spelled[hit.tail[0]][:k],
                                      q[nfull * BS: hit.tokens])
    kv.check_invariants(pc.held_blocks())


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

ARCHS = ("qwen1.5-0.5b", "deepseek-v2-lite-16b", "gemma3-12b")
SERVE = dict(slots=2, max_len=64, block_size=8, prefill_chunk=8)
SHARED = list(range(100, 121))      # 21 tokens: 2 full blocks + 5 more


_MODELS = {}


def _load(arch):
    """(jcfg, jparams, cfg, params) at float32 SMOKE, built once a run."""
    if arch not in _MODELS:
        jcfg = jregistry.get_config(arch, smoke=True).with_(dtype="float32")
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
        _MODELS[arch] = (jcfg, jparams, config_from_reference(jcfg),
                         tree_to_torch(jparams))
    return _MODELS[arch]


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return _load(request.param)


def _serve(engine, rounds, defrag_every=0):
    """Serve `rounds` (lists of (prompt, max_new)) one after another; a
    round whose prompt is None extends the previous round's first request
    (prompt + output + 3 tokens: a follow-up turn whose match ends inside
    a block).  Checks the cache's invariants after every step."""
    outs, last, steps = [], None, 0
    prefix = getattr(engine, "prefix", None)
    for rnd in rounds:
        if rnd is None:
            p, o = last
            rnd = [(p + o + [5, 6, 7], 4)]
        rids = [engine.submit(p, max_new_tokens=n) for p, n in rnd]
        while engine.pending:
            engine.step()
            steps += 1
            if defrag_every and steps % defrag_every == 0:
                engine.defragment()
            if defrag_every:
                engine.kv.check_invariants(prefix.held_blocks()
                                           if prefix else None)
        got = [engine.result(r) for r in rids]
        last = (rnd[0][0], got[0])
        outs.append(got)
    return outs


ROUNDS = [[(SHARED + [7, 8, 9], 6), (SHARED + [11, 12, 13, 14], 6)],
          [(SHARED + [13], 4)], None]


@pytest.mark.parametrize("case", ("rounds", "preempt"))
def test_prefix_streams_match_reference_and_prefix_off(model, case):
    jcfg, jparams, cfg, params = model
    if case == "rounds":
        rounds, serve = ROUNDS, SERVE
    else:                             # a pool of 7 blocks for both lanes
        rounds = [[(SHARED + [7], 12), (SHARED + [9, 9], 4)]]
        serve = dict(SERVE, num_blocks=8)
    want = _serve(JServingEngine(jcfg, jparams, JServeConfig(
        prefix_cache=True, **serve)), rounds)
    eng = ServingEngine(cfg, params, ServeConfig(
        prefix_cache=True, device="cpu", **serve))
    assert _serve(eng, rounds, defrag_every=3) == want
    off = ServingEngine(cfg, params, ServeConfig(device="cpu", **SERVE))
    assert _serve(off, rounds) == want
    assert eng.prefix_hit_rate() > 0 and eng.prefix.hit_tokens > 0
    assert eng.metrics.total("prefix_saved_bytes") == \
        eng.metrics.total("prefix_hit_tokens") * eng._kv_token_bytes
    if case == "preempt":
        assert any(m["preempted"] for m in eng.metrics)
    assert eng.trace_counts["prefill_chunk"] == 1
    assert eng.trace_counts["decode"] == 1


def _logical_kv(engine, lanes):
    """Every pool leaf's rows of each lane's mapped blocks, in logical
    order, through its group's table (what attention reads)."""
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import _pool_leaves
    out = {}
    for path, pool in _pool_leaves(engine.caches):
        g = engine.kv.groups[tf.cache_path_group(engine.cfg, path)]
        for lane in lanes:
            ids = torch.as_tensor(g.table_snapshot(lane), dtype=torch.long)
            rows = pool[:, ids] if tf.is_stacked_cache_path(path) \
                else pool[ids]
            out[path, lane] = rows.clone()
    return out


def test_a_freed_lane_takes_its_queued_copies_with_it():
    # lane 0 forks a shared block and is freed in the same step (as a
    # preemption would); its fresh block returns to the free list and lane
    # 1's fork of the same source may get it again: one drain must not
    # name a destination twice
    kv = GroupedPagedCache(slots=3, num_blocks=9, block_size=BS,
                           max_blocks_per_seq=4, horizons=(None, None))
    assert kv.ensure(2, BS - 1)
    src = kv.table_snapshot(2, 1)
    for lane in (0, 1):
        kv.share_blocks(lane, src)
    assert kv.fork_tail(0, 0) and len(kv.pending_copies) == 2
    kv.free_lane(0)
    assert kv.pending_copies == []
    assert kv.fork_tail(1, 0)
    dsts = [(gi, d) for gi, _, d in kv.pending_copies]
    assert len(dsts) == len(set(dsts)) == 2
    kv.check_invariants()
    # the engine's drain refuses a repeated destination or an overlap
    _, _, cfg, params = _load("qwen1.5-0.5b")
    eng = ServingEngine(cfg, params, ServeConfig(
        prefix_cache=True, device="cpu", **SERVE))
    for bad in ([(0, 3, 5), (0, 4, 5)], [(0, 3, 5), (0, 5, 6)]):
        eng.kv.pending_copies = list(bad)
        with pytest.raises(RuntimeError, match="destination"):
            eng._apply_pending_copies()


def test_copy_on_write_and_defragment_move_pool_rows():
    # deepseek: MLA latent pools, an unstacked prefix layer and stacked ones
    _, _, cfg, params = _load("deepseek-v2-lite-16b")
    eng = ServingEngine(cfg, params, ServeConfig(
        prefix_cache=True, device="cpu", **SERVE))
    drained = []
    apply = eng._apply_pending_copies

    def drain():
        copies = list(eng.kv.pending_copies)
        apply()
        assert not eng.kv.pending_copies
        if not copies:
            return
        drained.extend(copies)
        from repro_torch.models import transformer as tf
        from repro_torch.serving.engine import _pool_leaves
        for path, pool in _pool_leaves(eng.caches):
            gi = tf.cache_path_group(cfg, path)
            for g, src, dst in copies:
                if g == gi:
                    a = pool[:, src] if tf.is_stacked_cache_path(path) \
                        else pool[src]
                    b = pool[:, dst] if tf.is_stacked_cache_path(path) \
                        else pool[dst]
                    assert torch.equal(a, b)

    eng._apply_pending_copies = drain
    # a finished request whose indexed blocks are then evicted leaves holes
    # low in the pools
    eng.submit(list(range(300, 330)), max_new_tokens=2)
    eng.run()
    r1 = eng.submit(SHARED + [7, 8, 9], max_new_tokens=8)
    while eng.scheduler.phase.get(0) != "decode":
        eng.step()
    assert eng.prefix.evict(100) > 0
    # the second lane matches 21 tokens: 2 shared blocks + a forked tail
    r2 = eng.submit(SHARED + [11, 12, 13, 14], max_new_tokens=8)
    eng.step()
    assert drained and eng.kv.blocks_shared >= 2
    before = _logical_kv(eng, (0, 1))
    perms = []
    kv_defragment = eng.kv.defragment
    eng.kv.defragment = lambda: perms.extend(kv_defragment()) or perms
    eng.defragment()
    assert any(not np.array_equal(p, np.arange(len(p))) for p in perms)
    after = _logical_kv(eng, (0, 1))
    assert before.keys() == after.keys()
    assert all(torch.equal(before[k], after[k]) for k in before)
    eng.kv.check_invariants(eng.prefix.held_blocks())
    eng.run()
    assert len(eng.result(r1)) == len(eng.result(r2)) == 8
