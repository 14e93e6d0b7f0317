"""Prefix-cache index: a radix trie over token-aligned KV pages
(copy of ``repro/serving/prefix.py``; DESIGN.md §12).

Per-tenant ZO adaptation (MeZO-style, arxiv 2305.17333) multiplies one
system prompt across every request of a tenant — at serving scale the
prompt-prefix KV work is overwhelmingly redundant.  The trie deduplicates
it at *page* granularity: each edge is exactly one page worth of prompt
tokens, each node owns one physical page of the arena whose content is
the K/V of those positions.  Because K/V at position p is a pure
function of ``tokens[0..p]`` (causal attention) and of the shared model
params, two requests agreeing on a full-page-aligned token prefix can
read the very same physical pages — vLLM-style sharing on top of
:class:`~repro_torch.serving.pool.KVPool` refcounts.

Matching is **token-exact**: children are keyed by the page's token
tuple, so a lookup can only ever hit a true token prefix — there is no
hash-collision false-share path (tests/test_torch_prefix.py pins this).

The trie holds one pool reference per node page.  A node whose page
refcount is exactly 1 is *dead* — no lane references it, only the trie —
and is reclaimable under pool pressure: ``evict`` releases dead nodes
leaf-first in LRU order (``Scheduler.try_admit`` calls it before
refusing admission).  Because lanes attach whole root paths, liveness is
closed upward: an attached node's ancestors are attached too, so a dead
node's descendants are all dead and leaf-first eviction never strands a
live chain.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from repro_torch.serving.pool import KVPool


class TrieNode:
    """One page-aligned edge of the prefix trie: ``tokens`` (exactly
    ``page_size`` ids) mapping to physical page ``page``."""

    __slots__ = ("tokens", "page", "children", "parent", "stamp")

    def __init__(self, tokens: Tuple[int, ...], page: int,
                 parent: Optional["TrieNode"], stamp: int):
        self.tokens = tokens
        self.page = page
        self.children: Dict[Tuple[int, ...], "TrieNode"] = {}
        self.parent = parent
        self.stamp = stamp          # LRU clock of the last match/insert

    def depth(self) -> int:
        d, n = 0, self.parent
        while n is not None:
            d, n = d + 1, n.parent
        return d


class PrefixTrie:
    """Radix index over token-aligned pages, backed by ``pool``."""

    def __init__(self, pool: KVPool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root: Dict[Tuple[int, ...], TrieNode] = {}
        self.n_nodes = 0
        self._clock = 0

    # ------------------------------------------------------------ lookup
    def _blocks(self, tokens: Sequence[int]):
        """Full-page token blocks of ``tokens`` (the partial tail page,
        whose K/V would depend on tokens outside it, never shares)."""
        ps = self.page_size
        for i in range(len(tokens) // ps):
            yield tuple(int(t) for t in tokens[i * ps:(i + 1) * ps])

    def match(self, tokens: Sequence[int]) -> List[TrieNode]:
        """Longest token-exact full-page prefix match: the root path of
        nodes whose concatenated tokens prefix ``tokens``.  Touches the
        LRU stamp of every node on the path."""
        self._clock += 1
        path: List[TrieNode] = []
        children = self.root
        for blk in self._blocks(tokens):
            node = children.get(blk)
            if node is None:
                break
            node.stamp = self._clock
            path.append(node)
            children = node.children
        return path

    # ------------------------------------------------------------ insert
    def insert(self, tokens: Sequence[int], pages: Sequence[int]):
        """Register a finished prefill: ``pages[i]`` holds the K/V of
        full page ``i`` of ``tokens``.  Existing nodes are kept (their
        page already carries identical content — first writer wins);
        new nodes take the lane's page and add the trie's reference."""
        self._clock += 1
        children, parent = self.root, None
        for i, blk in enumerate(self._blocks(tokens)):
            if i >= len(pages):
                break
            node = children.get(blk)
            if node is None:
                node = TrieNode(blk, pages[i], parent, self._clock)
                self.pool.incref(pages[i])
                children[blk] = node
                self.n_nodes += 1
            else:
                node.stamp = self._clock
            parent, children = node, node.children

    # ---------------------------------------------------------- eviction
    def _dead_leaves(self, keep: FrozenSet[int]) -> List[TrieNode]:
        out, stack = [], list(self.root.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if (not n.children and id(n) not in keep
                    and self.pool.refcount(n.page) == 1):
                out.append(n)
        return out

    def reclaimable(self, keep: FrozenSet[int] = frozenset()) -> int:
        """Pages ``evict`` could currently release: dead nodes (refcount
        1, trie-only) outside ``keep``.  Dead subtrees are closed
        downward, so every dead node is eventually leaf-evictable."""
        count, stack = 0, list(self.root.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if id(n) not in keep and self.pool.refcount(n.page) == 1:
                count += 1
        return count

    def evict(self, n: int, keep: FrozenSet[int] = frozenset()) -> List[int]:
        """Release up to ``n`` dead pages back to the pool, deepest and
        least-recently-used leaves first; returns the evicted page ids.
        Nodes whose ids are in ``keep`` (a path about to be attached)
        are never evicted."""
        evicted: List[int] = []
        while len(evicted) < n:
            leaves = self._dead_leaves(keep)
            if not leaves:
                break
            leaves.sort(key=lambda nd: (nd.stamp, -nd.depth()))
            for node in leaves:
                if len(evicted) >= n:
                    break
                siblings = (node.parent.children if node.parent is not None
                            else self.root)
                del siblings[node.tokens]
                self.n_nodes -= 1
                self.pool.decref(node.page)
                evicted.append(node.page)
        return evicted

    # -------------------------------------------------------- invariants
    def check_invariants(self):
        seen_pages = set()
        stack = [(None, node) for node in self.root.values()]
        count = 0
        while stack:
            parent, n = stack.pop()
            count += 1
            assert n.parent is parent, "parent link broken"
            assert len(n.tokens) == self.page_size, \
                f"edge {n.tokens!r} is not one full page"
            assert n.page not in seen_pages, \
                f"page {n.page} appears twice in the trie"
            seen_pages.add(n.page)
            assert self.pool.refcount(n.page) >= 1, \
                f"trie node page {n.page} is not allocated"
            for blk, child in n.children.items():
                assert blk == child.tokens, "child keyed by wrong tokens"
                stack.append((n, child))
        assert count == self.n_nodes, "n_nodes out of sync"
