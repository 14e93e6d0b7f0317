"""Paged KV-cache pool: refcounted fixed-size pages over one
preallocated arena (copy of ``repro/serving/pool.py``; DESIGN.md §12).

The *arena* is the device-side slab (``models.lm.init_paged_cache``):
per stage-block, (R, n_pages, page_size, KV, dh) tensors shared by every
request.  The *pool* is the host-side allocator over page ids — pure
Python, no torch — so the scheduler's admit/finish bookkeeping is testable
without a device and the property suite can drive random traces against
the invariants directly.

Pages are **refcounted** for prefix sharing (DESIGN.md §12): a page the
prefix trie and N lanes all reference carries refcount N+1.  ``alloc``
hands out pages at refcount 1; ``incref`` registers another holder;
``decref`` (and ``free``, which is decref over a batch) drops one
reference and returns the page to the free list only when the count
reaches zero.  ``cow`` implements copy-on-write bookkeeping: a sole
owner writes in place, a shared page is swapped for a fresh private one
(the device-side content copy is the engine's job — the pool holds
no tensor).

Invariants (``check_invariants`` asserts them; the stateful property
suite in tests/test_torch_pool_properties.py holds it against the
reference's pool):

  * free ∪ allocated == {1 .. n_pages-1}, disjoint — page 0 is reserved
    as the *trash page* (inactive lanes write there; see lm.paged_step)
    and is never handed out.
  * every allocated page has refcount >= 1; no free page has one.
  * ``decref``/``free`` of a page not currently allocated raises
    (double-free).
  * ``alloc(n)`` either returns exactly n distinct pages or raises
    :class:`PoolExhausted` leaving the pool untouched.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

TRASH_PAGE = 0


class PoolExhausted(RuntimeError):
    """alloc() could not cover the request; the pool is unchanged."""


class KVPool:
    """Host-side refcounted page allocator over ``n_pages`` fixed-size
    pages."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError(f"n_pages must be >= 2 (page 0 is the trash "
                             f"page), got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO free list: recently freed pages are reused first, which
        # keeps the hot arena slice small and cache-friendly.
        self._free: List[int] = list(range(n_pages - 1, 0, -1))
        self._rc: Dict[int, int] = {}

    # ------------------------------------------------------------- alloc
    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._rc)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` cache slots."""
        return -(-n_tokens // self.page_size)

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"({len(self._rc)} in use of {self.n_pages - 1} usable)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        return pages

    # ---------------------------------------------------------- refcounts
    def refcount(self, p: int) -> int:
        """Current reference count (0 for a free page)."""
        return self._rc.get(p, 0)

    def incref(self, p: int):
        """Register another holder of an allocated page."""
        if p not in self._rc:
            raise ValueError(f"incref of unallocated page {p}")
        self._rc[p] += 1

    def decref(self, p: int) -> bool:
        """Drop one reference; returns True when the page went back to
        the free list (last holder gone)."""
        if p not in self._rc:
            raise ValueError(f"double-free or foreign page {p} "
                             f"(in_use={sorted(self._rc)})")
        self._rc[p] -= 1
        if self._rc[p] == 0:
            del self._rc[p]
            self._free.append(p)
            return True
        return False

    def free(self, pages: Sequence[int]):
        """Drop one reference per page — the retire path.  A page other
        holders (the prefix trie, another lane) still reference stays
        allocated for them."""
        for p in pages:
            self.decref(p)

    def cow(self, p: int) -> Tuple[int, bool]:
        """Copy-on-write bookkeeping for a holder about to write page
        ``p``: a sole owner keeps it (no copy); a shared page is
        exchanged for a fresh private page at refcount 1 and the
        caller's reference to ``p`` is dropped.  Returns ``(page,
        copied)`` — when ``copied`` the caller must copy the device
        content ``p -> page`` before writing.  Raises
        :class:`PoolExhausted` (pool untouched) when no page is free."""
        if p not in self._rc:
            raise ValueError(f"cow of unallocated page {p}")
        if self._rc[p] == 1:
            return p, False
        q = self.alloc(1)[0]
        self.decref(p)
        return q, True

    # -------------------------------------------------------- invariants
    def check_invariants(self):
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert not (free & self._rc.keys()), "page both free and allocated"
        assert TRASH_PAGE not in free and TRASH_PAGE not in self._rc, \
            "trash page entered circulation"
        assert free | self._rc.keys() == set(range(1, self.n_pages)), \
            "page leaked out of the pool"
        assert len(free) + len(self._rc) == self.n_pages - 1, \
            "available + in_use != usable pages"
        assert all(rc >= 1 for rc in self._rc.values()), \
            "allocated page with refcount < 1"
