"""Continuous-batching scheduler: admission, lanes, priorities,
preemption and prefix-cache page sharing (copy of
``repro/serving/scheduler.py``; DESIGN.md §12).

Pure host-side bookkeeping — no torch — so the admit/preempt/finish
state machine is property-testable on its own
(tests/test_torch_pool_properties.py drives random priority traces
through it and the reference's scheduler side by side;
tests/test_torch_prefix.py covers the trie).

Policy (recorded trade-offs in DESIGN.md §12):

  * Priority classes, FIFO within a class: the queue is ordered by
    (priority desc, submit order), and the *head* admits only when a
    lane is free AND the pool can cover its worst case (padded prompt
    plus ``max_new_tokens``) — a blocked head blocks everything behind
    it (no skip-ahead; starvation-free within a class).
  * Reserve-ahead still holds with sharing: a lane reserves fresh pages
    for everything it may ever write — including one replacement page
    per shared page its re-run prefill chunks overlap (the COW
    reserve) — so a running request can never exhaust the pool
    mid-decode.
  * Prefix sharing (``prefix_cache=True``): the head's prompt is
    matched against the :class:`~repro_torch.serving.prefix.PrefixTrie`;
    matched full-page prefixes attach the *same physical pages*
    (incref), prefill restarts at the first chunk past the
    chunk-aligned reuse point, and the final chunk always re-runs so
    the first token's logits are produced.  Shared pages a re-run chunk
    writes are copy-on-write swapped from the lane's reserve
    (``cow_range``); dead trie pages are evicted before admission is
    refused.
  * Preemption (``preempt=True``): when the head outranks a running
    request and admission is starved, the lowest-priority decoding lane
    is evicted — its pages are released (the trie keeps any registered
    prefix alive, so re-prefill is partial) and the request requeues at
    the front of its priority class; its regenerated tokens are
    bit-identical because sampling is a pure function of
    (seed, position).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.serving.pool import KVPool, TRASH_PAGE
from repro_torch.serving.prefix import PrefixTrie

PREFILL, DECODE = "prefill", "decode"


@dataclasses.dataclass
class Request:
    """One generation request.  ``seed`` feeds the per-request counter
    RNG, so sampled output is reproducible no matter which lane or batch
    composition serves it.  ``max_new_tokens=None`` means "the engine's
    ``serving.max_new_tokens`` default" — resolved at ``Engine.submit``.
    ``priority``: higher admits first; a preempted request keeps its
    submit order within its class."""
    rid: int
    tokens: Sequence[int]              # prompt token ids
    max_new_tokens: Optional[int] = None
    seed: int = 0
    priority: int = 0

    def __post_init__(self):
        if len(self.tokens) < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens is not None and self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens must be "
                             f">= 1, got {self.max_new_tokens}")
        if self.priority < 0:
            raise ValueError(f"request {self.rid}: priority must be >= 0, "
                             f"got {self.priority}")


@dataclasses.dataclass
class Lane:
    req: Request
    pages: List[int]
    prompt_len: int
    padded_len: int                    # prompt padded to the chunk bucket
    state: str = PREFILL
    next_chunk: int = 0                # next prefill chunk index
    pos: int = 0                       # cache slots filled so far
    last_token: Optional[int] = None   # token the next decode step feeds
    out: List[int] = dataclasses.field(default_factory=list)
    t_admit: float = 0.0
    t_first: float = 0.0
    admit_seq: int = 0                 # admission order (FIFO tiebreak)
    # --- prefix sharing (DESIGN.md §12)
    shared_idx: Set[int] = dataclasses.field(default_factory=set)
    cow_reserve: List[int] = dataclasses.field(default_factory=list)
    reuse_tokens: int = 0              # cache slots attached, not recomputed


class Scheduler:
    def __init__(self, pool: KVPool, *, max_lanes: int, prefill_chunk: int,
                 max_seq: int, prefix_cache: bool = False,
                 priorities: int = 1, preempt: bool = False):
        if prefill_chunk % pool.page_size:
            raise ValueError(f"prefill_chunk={prefill_chunk} must be a "
                             f"multiple of page_size={pool.page_size}")
        if max_seq % pool.page_size:
            raise ValueError(f"max_seq={max_seq} must be a multiple of "
                             f"page_size={pool.page_size}")
        if priorities < 1:
            raise ValueError(f"priorities must be >= 1, got {priorities}")
        self.pool = pool
        self.max_lanes = max_lanes
        self.prefill_chunk = prefill_chunk
        self.max_seq = max_seq
        self.priorities = priorities
        self.preempt_enabled = preempt
        self.trie: Optional[PrefixTrie] = (PrefixTrie(pool) if prefix_cache
                                           else None)
        self.table_width = max_seq // pool.page_size
        self.lanes: List[Optional[Lane]] = [None] * max_lanes
        self.queue: Deque[Request] = deque()
        self._admit_seq = 0
        self._submit_seq = 0
        self._seq: Dict[int, int] = {}     # rid -> submit order
        # sharing / preemption telemetry (engine exports as obs gauges)
        self.prefix_hits = 0               # full prompt pages attached shared
        self.prefix_lookups = 0            # full prompt pages looked up
        self.preemptions = 0
        self.cow_copies = 0
        self.trie_evictions = 0

    # ---------------------------------------------------------- capacity
    def padded_prompt(self, prompt_len: int) -> int:
        c = self.prefill_chunk
        return -(-prompt_len // c) * c

    def span(self, req: Request) -> int:
        """Worst-case cache slots the request can touch: the padded
        prefill writes, then decode writes up to prompt+max_new."""
        return max(self.padded_prompt(len(req.tokens)),
                   len(req.tokens) + req.max_new_tokens)

    def submit(self, req: Request):
        if req.max_new_tokens is None:
            raise ValueError(f"request {req.rid}: max_new_tokens unresolved "
                             "— submit through Engine.submit, which applies "
                             "the serving.max_new_tokens default")
        if req.priority >= self.priorities:
            raise ValueError(
                f"request {req.rid}: priority {req.priority} out of range "
                f"[0, {self.priorities}) — raise serving.priorities")
        span = self.span(req)
        if span > self.max_seq:
            raise ValueError(
                f"request {req.rid}: needs {span} cache slots > "
                f"serving.max_seq={self.max_seq} (prompt {len(req.tokens)} "
                f"+ max_new {req.max_new_tokens})")
        if self.pool.pages_for(span) > self.pool.n_pages - 1:
            raise ValueError(
                f"request {req.rid}: needs {self.pool.pages_for(span)} "
                f"pages > pool capacity {self.pool.n_pages - 1}")
        self._submit_seq += 1
        self._seq[req.rid] = self._submit_seq
        self._enqueue(req)

    def _key(self, req: Request) -> Tuple[int, int]:
        return (-req.priority, self._seq[req.rid])

    def _enqueue(self, req: Request):
        """Ordered insert: priority desc, then submit order — a requeued
        (preempted) request's old seq puts it back at the front of its
        class."""
        k = self._key(req)
        for idx, queued in enumerate(self.queue):
            if self._key(queued) > k:
                self.queue.insert(idx, req)
                return
        self.queue.append(req)

    # --------------------------------------------------------- admission
    def free_lane(self) -> Optional[int]:
        for i, lane in enumerate(self.lanes):
            if lane is None:
                return i
        return None

    def _plan(self, req: Request):
        """Admission plan for ``req``: trie path to attach, fresh pages
        to allocate (table + COW reserve), and the chunk-aligned reuse
        point."""
        ps = self.pool.page_size
        c = self.prefill_chunk
        total = self.pool.pages_for(self.span(req))
        path = self.trie.match(req.tokens)[:total] if self.trie else []
        n_shared = len(path)
        padded = self.padded_prompt(len(req.tokens))
        # reuse must be chunk-aligned (prefill restarts on a chunk
        # boundary) and leave the final chunk to re-run — it produces
        # the first token's logits
        reuse_tokens = max(0, min((n_shared * ps // c) * c, padded - c))
        n_cow = n_shared - reuse_tokens // ps
        need_fresh = (total - n_shared) + n_cow
        return path, total, n_shared, reuse_tokens, n_cow, need_fresh

    def _victim(self, below: int) -> Optional[int]:
        """Lowest-priority decoding lane strictly under ``below``
        (youngest admission first within the class)."""
        best = None
        for i, lane in enumerate(self.lanes):
            if lane is None or lane.state != DECODE:
                continue
            if lane.req.priority >= below:
                continue
            if best is None or ((lane.req.priority, -lane.admit_seq)
                                < (self.lanes[best].req.priority,
                                   -self.lanes[best].admit_seq)):
                best = i
        return best

    def _reclaim(self, need_fresh: int, keep) -> None:
        if self.trie is not None and need_fresh > self.pool.available:
            self.trie_evictions += len(
                self.trie.evict(need_fresh - self.pool.available, keep=keep))

    def try_admit(self, now: float = 0.0) -> Optional[int]:
        """Admit the queue head if a lane is free and the pool covers its
        worst case.  Before refusing: reclaim dead prefix-trie pages,
        then (``preempt=True``) evict decoding lanes the head outranks.
        A still-blocked head blocks everything behind it."""
        if not self.queue:
            return None
        req = self.queue[0]
        path, total, n_shared, reuse_tokens, n_cow, need_fresh = \
            self._plan(req)
        keep = frozenset(id(n) for n in path)
        i = self.free_lane()
        self._reclaim(need_fresh, keep)
        while (self.preempt_enabled
               and (i is None or need_fresh > self.pool.available)):
            v = self._victim(req.priority)
            if v is None:
                break
            self.preempt(v)
            self._reclaim(need_fresh, keep)
            i = self.free_lane()
        if i is None or need_fresh > self.pool.available:
            return None
        self.queue.popleft()
        if self.trie is not None:
            self.prefix_lookups += len(req.tokens) // self.pool.page_size
            self.prefix_hits += n_shared
        shared = [n.page for n in path]
        for p in shared:
            self.pool.incref(p)
        fresh = self.pool.alloc(need_fresh)
        n_table_fresh = total - n_shared
        self._admit_seq += 1
        self.lanes[i] = Lane(req=req, pages=shared + fresh[:n_table_fresh],
                             prompt_len=len(req.tokens),
                             padded_len=self.padded_prompt(len(req.tokens)),
                             next_chunk=reuse_tokens // self.prefill_chunk,
                             pos=reuse_tokens,
                             t_admit=now, admit_seq=self._admit_seq,
                             shared_idx=set(range(n_shared)),
                             cow_reserve=fresh[n_table_fresh:],
                             reuse_tokens=reuse_tokens)
        return i

    # ----------------------------------------------------- prefix sharing
    def cow_range(self, lane: Lane, start: int, end: int
                  ) -> List[Tuple[int, int]]:
        """Copy-on-write every shared page overlapping cache slots
        [start, end) that a prefill chunk is about to write: swap in a
        private page from the lane's reserve (allocated at admission, so
        this can never exhaust the pool) and drop the shared reference.
        Returns (shared_page, private_page) pairs — the engine copies
        the device content before the write lands."""
        ps = self.pool.page_size
        pairs: List[Tuple[int, int]] = []
        for idx in range(start // ps, -(-end // ps)):
            if idx in lane.shared_idx and idx < len(lane.pages):
                old = lane.pages[idx]
                new = lane.cow_reserve.pop()
                self.pool.decref(old)      # trie (and peers) keep it alive
                lane.pages[idx] = new
                lane.shared_idx.discard(idx)
                self.cow_copies += 1
                pairs.append((old, new))
        return pairs

    def register_prefix(self, lane: Lane):
        """Offer a finished prefill's full prompt pages to the trie
        (engine calls this when the final chunk lands).  Already-shared
        pages match their existing nodes; the lane's fresh pages extend
        the chain and gain the trie's reference."""
        if self.trie is not None:
            self.trie.insert(lane.req.tokens, lane.pages)

    # ---------------------------------------------------------- preempt
    def preempt(self, i: int) -> Lane:
        """Evict lane ``i``: release its pages (a trie-registered prefix
        survives via the trie's references) and requeue its request at
        the front of its priority class.  Generated tokens are
        discarded — regeneration is bit-identical because sampling is a
        pure function of (seed, position)."""
        lane = self.lanes[i]
        assert lane is not None, f"preempt on empty lane {i}"
        self.pool.free(lane.pages)
        self.pool.free(lane.cow_reserve)
        self.lanes[i] = None
        self.preemptions += 1
        self._enqueue(lane.req)
        return lane

    # ------------------------------------------------------------ retire
    def finish(self, i: int) -> Lane:
        """Retire lane ``i``: drop its page references.  Pages the trie
        also references stay allocated for future prefix hits; the rest
        return to the pool immediately."""
        lane = self.lanes[i]
        assert lane is not None, f"finish on empty lane {i}"
        self.pool.free(lane.pages)
        self.pool.free(lane.cow_reserve)   # non-empty only pre-prefill-end
        self.lanes[i] = None
        self._seq.pop(lane.req.rid, None)
        return lane

    # -------------------------------------------------------- page table
    def page_row(self, lane: Lane) -> List[int]:
        """The lane's page-table row, trash-padded to ``table_width``."""
        row = list(lane.pages[:self.table_width])
        row += [TRASH_PAGE] * (self.table_width - len(row))
        return row

    def trash_row(self) -> List[int]:
        return [TRASH_PAGE] * self.table_width

    # ------------------------------------------------------------- views
    def prefilling(self) -> List[int]:
        return [i for i, l in enumerate(self.lanes)
                if l is not None and l.state == PREFILL]

    def decoding(self) -> List[int]:
        return [i for i, l in enumerate(self.lanes)
                if l is not None and l.state == DECODE]

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(l is not None for l in self.lanes)

    @property
    def page_hit_rate(self) -> float:
        """Shared prompt pages attached / full prompt pages looked up."""
        return (self.prefix_hits / self.prefix_lookups
                if self.prefix_lookups else 0.0)
