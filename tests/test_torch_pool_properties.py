"""Port parity of the serving bookkeeping: ``repro_torch.serving``'s
``KVPool`` and ``Scheduler`` against ``repro.serving``'s on the same
seeded random traces (hypothesis, with a seeded numpy fallback that runs
without it).  After every operation both sides must agree exactly: the
pages handed out, free lists, refcounts, the exceptions raised,
admissions (lane and page list), COW ranges, preemptions, trie
evictions and the queue order; and the port's invariants hold.
Host-side only, no tensors."""
import numpy as np
import pytest
import torch

from _hyp import given, settings, st

from repro import serving as jsv
from repro.serving import scheduler as jsched
from repro_torch import serving as tsv
from repro_torch.serving import scheduler as tsched

torch.set_num_threads(2)              # six xdist workers share the CPUs

ALLOC, INCREF, DECREF, COW, FREE = range(5)


def _state(pool):
    return list(pool._free), dict(pool._rc)


def _both(fn_j, fn_t):
    """Call both sides; they must return equal values or raise the same
    exception type."""
    outs = []
    for fn in (fn_j, fn_t):
        try:
            outs.append(("ok", fn()))
        except (ValueError, RuntimeError) as ex:
            outs.append(("raise", type(ex).__name__))
    assert outs[0] == outs[1], outs
    return outs[1]


# ------------------------------------------------------------------ pool
def _pool_trace(n_pages, ops):
    jp, tp = jsv.KVPool(n_pages, 4), tsv.KVPool(n_pages, 4)
    held = []
    for op, a in ops:
        if op == ALLOC:
            kind, pages = _both(lambda: jp.alloc(a % 6),
                                lambda: tp.alloc(a % 6))
            if kind == "ok":
                held.extend(pages)
        elif op == INCREF and held:
            p = held[a % len(held)]
            _both(lambda: jp.incref(p), lambda: tp.incref(p))
            held.append(p)
        elif op == DECREF and held:
            p = held.pop(a % len(held))
            _both(lambda: jp.decref(p), lambda: tp.decref(p))
        elif op == COW and held:
            i = a % len(held)
            p = held[i]
            kind, res = _both(lambda: jp.cow(p), lambda: tp.cow(p))
            if kind == "ok":
                held[i] = res[0]
        elif op == FREE and held:
            k = 1 + a % min(4, len(held))
            batch, held = held[:k], held[k:]
            _both(lambda: jp.free(batch), lambda: tp.free(batch))
        elif op == DECREF:                   # foreign page: both raise
            _both(lambda: jp.decref(1 + a % (n_pages - 1)),
                  lambda: tp.decref(1 + a % (n_pages - 1)))
        assert _state(jp) == _state(tp)
        tp.check_invariants()
    _both(lambda: jp.free(held), lambda: tp.free(held))
    assert _state(jp) == _state(tp)
    assert tp.in_use == 0 and tp.available == n_pages - 1


@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 10 ** 6)),
                max_size=120),
       st.integers(2, 24))
@settings(max_examples=60, deadline=None)
def test_pool_trace_matches_reference_hypothesis(ops, n_pages):
    _pool_trace(n_pages, ops)


@pytest.mark.parametrize("seed", range(6))
def test_pool_trace_matches_reference_seeded(seed):
    rng = np.random.default_rng(seed)
    ops = [(int(rng.integers(0, 5)), int(rng.integers(0, 10 ** 6)))
           for _ in range(200)]
    _pool_trace(int(rng.integers(2, 25)), ops)


def test_pool_errors_and_trash_page_match_reference():
    for mod in (jsv, tsv):
        with pytest.raises(ValueError, match="trash page"):
            mod.KVPool(1, 4)
        with pytest.raises(ValueError, match="page_size"):
            mod.KVPool(4, 0)
    assert tsv.TRASH_PAGE == jsv.TRASH_PAGE == 0
    tp = tsv.KVPool(3, 4)
    a, b = tp.alloc(2)
    tp.incref(a)
    with pytest.raises(tsv.PoolExhausted):
        tp.cow(a)                            # nothing free: untouched
    assert tp.refcount(a) == 2 and tp.refcount(b) == 1
    assert tsv.TRASH_PAGE not in (a, b)


# ------------------------------------------------------------- scheduler
def _view(s):
    lanes = [None if l is None else
             (l.req.rid, list(l.pages), l.state, l.next_chunk, l.pos,
              sorted(l.shared_idx), list(l.cow_reserve), l.reuse_tokens)
             for l in s.lanes]
    return (lanes, [r.rid for r in s.queue], _state(s.pool),
            s.preemptions, s.cow_copies, s.trie_evictions, s.prefix_hits,
            s.prefix_lookups, None if s.trie is None else s.trie.n_nodes)


def _sched_trace(seed, n_ops):
    rng = np.random.default_rng(seed)
    kw = dict(max_lanes=int(rng.integers(1, 5)), prefill_chunk=8,
              max_seq=48, prefix_cache=bool(rng.integers(2)),
              priorities=int(rng.integers(1, 4)))
    kw["preempt"] = kw["priorities"] > 1 and bool(rng.integers(2))
    n_pages = int(rng.integers(12, 40))
    sides = [(jsv, jsched, jsv.Scheduler(jsv.KVPool(n_pages, 4), **kw)),
             (tsv, tsched, tsv.Scheduler(tsv.KVPool(n_pages, 4), **kw))]
    (_, _, js), (_, _, ts) = sides
    both = lambda f: _both(lambda: f(*sides[0]), lambda: f(*sides[1]))
    system = rng.integers(0, 50, 12).tolist()      # 3 pages, shared
    rid = 0
    for _ in range(n_ops):
        op = int(rng.integers(0, 5))
        if op == 0 and rid < 40:
            toks = (system if rng.integers(2) else []) + rng.integers(
                0, 50, int(rng.integers(1, 17))).tolist()
            req = dict(rid=rid, tokens=toks,
                       max_new_tokens=int(rng.integers(1, 9)),
                       priority=int(rng.integers(0, kw["priorities"])))
            both(lambda m, _, s: s.submit(m.Request(**req)))
            rid += 1
        elif op == 1:
            both(lambda m, _, s: s.try_admit())
        elif op == 2 and ts.prefilling():
            i = int(rng.choice(ts.prefilling()))
            start = ts.lanes[i].next_chunk * 8

            def chunk(m, mod, s):                # one prefill chunk lands
                lane = s.lanes[i]
                pairs = s.cow_range(lane, start, start + 8)
                lane.next_chunk += 1
                if lane.next_chunk * 8 >= lane.padded_len:
                    lane.state = mod.DECODE
                    s.register_prefix(lane)
                return pairs
            both(chunk)
        elif op == 3 and ts.decoding():
            i = int(rng.choice(ts.decoding()))
            both(lambda m, _, s: s.finish(i).req.rid)
        elif op == 4 and kw["preempt"] and ts.decoding():
            i = int(rng.choice(ts.decoding()))
            both(lambda m, _, s: s.preempt(i).req.rid)
        assert _view(js) == _view(ts)
        ts.pool.check_invariants()
        if ts.trie is not None:
            ts.trie.check_invariants()
    assert [ts.page_row(l) for l in ts.lanes if l is not None] == [
        js.page_row(l) for l in js.lanes if l is not None]


@pytest.mark.parametrize("seed", range(8))
def test_scheduler_trace_matches_reference_seeded(seed):
    _sched_trace(seed, 150)


@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=30, deadline=None)
def test_scheduler_trace_matches_reference_hypothesis(seed):
    _sched_trace(seed, 80)


def test_scheduler_errors_match_reference():
    for mod in (jsv, tsv):
        with pytest.raises(ValueError, match="multiple of page_size"):
            mod.Scheduler(mod.KVPool(8, 4), max_lanes=1, prefill_chunk=6,
                          max_seq=32)
        s = mod.Scheduler(mod.KVPool(8, 4), max_lanes=1, prefill_chunk=8,
                          max_seq=32)
        with pytest.raises(ValueError, match="unresolved"):
            s.submit(mod.Request(rid=0, tokens=[1]))
        with pytest.raises(ValueError, match="max_seq"):
            s.submit(mod.Request(rid=0, tokens=[1] * 30, max_new_tokens=9))
        with pytest.raises(ValueError, match="priority"):
            s.submit(mod.Request(rid=0, tokens=[1], max_new_tokens=2,
                                 priority=1))
        with pytest.raises(ValueError, match="empty prompt"):
            mod.Request(rid=0, tokens=[])
