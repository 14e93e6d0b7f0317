"""Port parity of the prefix trie: ``repro_torch.serving.PrefixTrie``
against ``repro.serving.PrefixTrie`` on the same seeded random
insert/match/evict traces (hypothesis, and a seeded numpy fallback),
and a zipfian-prompt workload through both schedulers: equal matched
pages, evictions (order included), node counts, refcounts and
admissions.  Then the reference's targeted trie cases on the port:
partial-page boundary, first writer wins, LRU leaf-first eviction, kept
nodes.  Host-side only, no tensors."""
import numpy as np
import pytest
import torch

from _hyp import given, settings, st

from repro import serving as jsv
from repro_torch import serving as tsv

torch.set_num_threads(2)              # six xdist workers share the CPUs

PS = 4


def _pages(path):
    return [n.page for n in path]


def _trie_trace(seed, n_ops):
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(8, 48))
    sides = []
    for mod in (jsv, tsv):
        pool = mod.KVPool(n_pages, PS)
        sides.append((pool, mod.PrefixTrie(pool)))
    prompts = [rng.integers(0, 6, int(rng.integers(1, 25))).tolist()
               for _ in range(8)]
    held = []                                    # lane page lists
    for _ in range(n_ops):
        op = int(rng.integers(0, 4))
        prompt = prompts[int(rng.integers(len(prompts)))]
        n_evict = int(rng.integers(1, 4))
        out = []
        for pool, trie in sides:
            if op == 0:                          # a prefill registers
                n = -(-len(prompt) // PS)
                if n > pool.available:
                    out.append(None)
                    continue
                pages = pool.alloc(n)
                trie.insert(prompt, pages)
                out.append(pages)
            elif op == 1:
                out.append(_pages(trie.match(prompt)))
            elif op == 2:                        # keep a matched path
                keep = frozenset(id(n) for n in trie.match(prompt))
                out.append((trie.reclaimable(keep),
                            trie.evict(n_evict, keep=keep)))
            else:
                out.append(None)
        assert out[0] == out[1], (op, out)
        if op == 0 and out[1] is not None:
            held.append(out[1])
        if op == 3 and held:                     # a lane retires
            pages = held.pop(int(rng.integers(len(held))))
            for pool, _ in sides:
                pool.free(pages)
        (jp, jt), (tp, tt) = sides
        assert (jp._free, jp._rc, jt.n_nodes) == (tp._free, tp._rc,
                                                  tt.n_nodes)
        tt.check_invariants()
        tp.check_invariants()


@pytest.mark.parametrize("seed", range(8))
def test_trie_trace_matches_reference_seeded(seed):
    _trie_trace(seed, 150)


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=40, deadline=None)
def test_trie_trace_matches_reference_hypothesis(seed):
    _trie_trace(seed, 60)


@pytest.mark.parametrize("seed", [7, 8])
def test_zipfian_admissions_match_reference(seed):
    """Zipf-distributed traffic over a small prompt population through
    both schedulers: the same lanes, shared pages, fresh pages and hit
    counts at every admission, and hits only on true token prefixes."""
    rng = np.random.default_rng(seed)
    scheds = [mod.Scheduler(mod.KVPool(n_pages=257, page_size=PS),
                            max_lanes=4, prefill_chunk=8, max_seq=64,
                            prefix_cache=True) for mod in (jsv, tsv)]
    population = [rng.integers(0, 1000, int(rng.integers(8, 25))).tolist()
                  for _ in range(6)]
    ranks = np.minimum(rng.zipf(1.5, size=60) - 1, len(population) - 1)
    for rid, k in enumerate(ranks):
        prompt = population[int(k)]
        got = []
        for mod, s in zip((jsv, tsv), scheds):
            s.submit(mod.Request(rid=rid, tokens=prompt, max_new_tokens=4))
            i = s.try_admit()
            lane = s.lanes[i]
            got.append((i, list(lane.pages), sorted(lane.shared_idx),
                        list(lane.cow_reserve), lane.reuse_tokens,
                        s.prefix_hits, s.prefix_lookups))
            path = s.trie.match(prompt)
            shared = [t for n in path[:len(lane.shared_idx)]
                      for t in n.tokens]
            assert shared == prompt[:len(shared)]
            s.register_prefix(lane)
            s.finish(i)
        assert got[0] == got[1], rid
        scheds[1].pool.check_invariants()
        scheds[1].trie.check_invariants()
    assert scheds[1].page_hit_rate == scheds[0].page_hit_rate > 0.0


# ------------------------------------------------ targeted, on the port
def _trie(n_pages=64):
    pool = tsv.KVPool(n_pages=n_pages, page_size=PS)
    return pool, tsv.PrefixTrie(pool)


def test_match_splits_at_partial_page():
    pool, trie = _trie()
    prompt = list(range(10))                 # 2 full pages + 2 spare slots
    pages = pool.alloc(3)
    trie.insert(prompt, pages)
    assert trie.n_nodes == 2
    assert pool.refcount(pages[2]) == 1      # partial tail page never shared
    assert _pages(trie.match(list(range(9)) + [99])) == pages[:2]
    assert _pages(trie.match([0, 1, 2, 3, 4, 99, 6, 7])) == pages[:1]
    trie.check_invariants()


def test_insert_keeps_first_writer_on_duplicate():
    pool, trie = _trie()
    a, b = pool.alloc(2), pool.alloc(2)
    trie.insert(list(range(8)), a)
    trie.insert(list(range(8)), b)
    assert _pages(trie.match(list(range(8)))) == a
    assert pool.refcount(b[0]) == 1 and pool.refcount(b[1]) == 1


def test_evict_dead_leaves_first_lru():
    pool, trie = _trie()
    old = pool.alloc(3)
    trie.insert(list(range(12)), old)
    young = pool.alloc(2)
    trie.insert([50, 51, 52, 53, 54, 55, 56, 57], young)
    pool.free(old)
    pool.free(young)
    assert trie.reclaimable() == 5
    assert trie.evict(1) == [old[2]]
    trie.match(list(range(8)))
    assert trie.evict(1) == [young[1]]
    assert trie.evict(10) == [young[0], old[1], old[0]]
    assert trie.n_nodes == 0 and pool.in_use == 0
    pool.check_invariants()


def test_evict_spares_live_and_kept_nodes():
    pool, trie = _trie()
    live = pool.alloc(2)
    trie.insert(list(range(8)), live)
    dead = pool.alloc(1)
    trie.insert([9, 9, 9, 9], dead)
    pool.free(dead)
    keep = frozenset(id(n) for n in trie.match([9, 9, 9, 9]))
    assert trie.reclaimable() == 1 and trie.reclaimable(keep=keep) == 0
    assert trie.evict(5, keep=keep) == []
    assert trie.evict(5) == dead
    assert _pages(trie.match(list(range(8)))) == live
    trie.check_invariants()
