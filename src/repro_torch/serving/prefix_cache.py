"""Radix-tree prefix cache over KV pages (cross-request page sharing).

The port's own copy of ``repro.serving.prefix_cache`` (pure Python,
unchanged): the port imports nothing of the JAX package.

Production traffic is dominated by shared prefixes — system prompts,
few-shot templates, multi-turn history — and the paper's binding platform
constraint for high-concurrency serving is KV memory capacity (PAPER
§II-B, §V).  This module makes the KV page the unit of *sharing*, not
just ownership: a radix tree keyed on page-granular token blocks maps a
new request's longest cached prompt prefix onto physical pages already
resident in the device pool, so the request

- maps those pages **read-only** into its page-table row (one extra
  holder per page in the refcounted :class:`~.paging.PageAllocator`),
- skips those tokens' prefill entirely — the unified packed step only
  computes the uncached suffix (positions and kv_len are absolute, so the
  ragged kernel attends the shared pages with no kernel change), and
- is charged only its uncached pages at admission.

Tree shape
----------
One node per **full page** of tokens (``page_size`` tokens), children
keyed by the page's exact token tuple — "hashing" a block is dict lookup
on the tuple, which is collision-safe by construction.  Each node pins one
page with a cache-held reference, so a page can outlive every request
that wrote or read it.  A request's partial tail page is never shared;
the one case where a *cached* page would be written — a full hit, whose
last prompt token must be recomputed for logits — is resolved by the
engine with a copy-on-write fork of that tail page (see
``ServeEngine._prefix_attach``).

Eviction is LRU over refcount-1 **leaves** only: a page some request still
maps, or an interior node some longer cached suffix hangs off, is never
reclaimed.  Evicting a leaf may expose its parent as the next candidate,
so one ``evict`` call can peel a whole cold branch.

Pure host-side Python: it sits on the scheduler hot path next to the
allocator and is audited by the same ``check()`` discipline.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator

from .paging import PageAllocator

#: Allocator owner id under which the cache holds its node references.
#: Engine request ids are non-negative, so -1 never collides.
CACHE_OWNER = -1

Block = tuple[int, ...]


@dataclass
class _Node:
    """One full page of cached prompt tokens."""

    block: Block                      # the page_size tokens this node covers
    page: int                         # physical page id holding their KV
    parent: "_Node | None"
    children: dict[Block, "_Node"] = field(default_factory=dict)
    last_used: int = 0                # LRU clock tick of the last touch

    @property
    def is_leaf(self) -> bool:
        return not self.children


@dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0                     # lookups matching >= 1 page
    lookup_tokens: int = 0
    hit_tokens: int = 0
    inserted_pages: int = 0
    evicted_pages: int = 0

    @property
    def hit_rate(self) -> float:
        """Token-weighted hit rate over all lookups."""
        return self.hit_tokens / self.lookup_tokens if self.lookup_tokens \
            else 0.0


class PrefixCache:
    """Radix tree of page-granular prompt blocks over a ``PageAllocator``.

    The cache holds one allocator reference per node (owner
    :data:`CACHE_OWNER`), so ``pager.check()`` audits the tree's page
    pins together with every request's.
    """

    def __init__(self, pager: PageAllocator):
        self.pager = pager
        self.page_size = pager.page_size
        self.root = _Node(block=(), page=0, parent=None)
        self.n_nodes = 0              # excludes the root sentinel
        self.stats = PrefixCacheStats()
        self._clock = 0

    # -- token helpers -------------------------------------------------------
    def _blocks(self, tokens: list[int]) -> Iterator[Block]:
        ps = self.page_size
        for i in range(0, len(tokens) - ps + 1, ps):
            yield tuple(tokens[i:i + ps])

    def _walk(self, tokens: list[int]) -> list[_Node]:
        """Nodes along the longest cached page-prefix of ``tokens``."""
        node, path = self.root, []
        for block in self._blocks(tokens):
            child = node.children.get(block)
            if child is None:
                break
            path.append(child)
            node = child
        return path

    def _touch(self, path: list[_Node]) -> None:
        self._clock += 1
        for n in path:
            n.last_used = self._clock

    # -- queries -------------------------------------------------------------
    def lookup(self, tokens: list[int]) -> tuple[list[int], int]:
        """Longest cached page-prefix of ``tokens``: (pages, n_cached_tokens).

        Read-only peek — no references are taken and LRU order is not
        touched; the engine calls this at submit time for hit accounting
        and cache-hit-aware admission estimates.
        """
        path = self._walk(tokens)
        n = len(tokens)
        self.stats.lookups += 1
        self.stats.lookup_tokens += n
        if path:
            self.stats.hits += 1
            self.stats.hit_tokens += min(len(path) * self.page_size, n)
        return [nd.page for nd in path], len(path) * self.page_size

    def acquire(self, owner: int, tokens: list[int]) -> list[int]:
        """Map the longest cached page-prefix into ``owner``'s page list.

        Takes one allocator reference per matched page (so eviction can no
        longer reclaim them) and refreshes LRU along the path.  Returns the
        matched pages in token order; ``owner`` is charged nothing for them
        beyond the refcount.
        """
        path = self._walk(tokens)
        self._touch(path)
        pages = [nd.page for nd in path]
        if pages:
            self.pager.acquire(owner, pages)
        return pages

    # -- growth --------------------------------------------------------------
    def insert(self, tokens: list[int], pages: list[int]) -> int:
        """Register ``owner``-held ``pages`` as the cached KV of ``tokens``.

        Called when a request finishes prefill: every *full* page of its
        processed tokens becomes a node (partial tails are never cached).
        Blocks already present keep their existing page — first writer
        wins, the latecomer's private page simply stays private.  Each new
        node takes one cache-held reference on its page.  Returns the
        number of newly cached pages.
        """
        node, new = self.root, 0
        path: list[_Node] = []
        for i, block in enumerate(self._blocks(tokens)):
            child = node.children.get(block)
            if child is None:
                self.pager.acquire(CACHE_OWNER, [pages[i]])
                child = _Node(block=block, page=pages[i], parent=node)
                node.children[block] = child
                self.n_nodes += 1
                new += 1
            path.append(child)
            node = child
        self._touch(path)
        self.stats.inserted_pages += new
        return new

    # -- eviction ------------------------------------------------------------
    def _evictable(self) -> list[_Node]:
        """Leaves whose page only the cache still references, LRU first."""
        out: list[_Node] = []
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if n.is_leaf:
                if self.pager.refcount(n.page) == 1:
                    out.append(n)
            else:
                stack.extend(n.children.values())
        out.sort(key=lambda n: n.last_used)
        return out

    def evict(self, n_pages: int) -> int:
        """Reclaim up to ``n_pages`` pages from LRU refcount-1 leaves.

        Returns how many pages actually went back to the free list.  Pages
        a request maps (refcount >= 2) and interior nodes are never touched;
        evicting a leaf may expose its parent, so the scan repeats until
        the target is met or no candidate remains.
        """
        freed = 0
        while freed < n_pages:
            candidates = self._evictable()
            if not candidates:
                break
            for node in candidates:
                if freed >= n_pages:
                    break
                self._drop(node)
                freed += 1
        self.stats.evicted_pages += freed
        return freed

    def clear(self) -> int:
        """Drop every node (regardless of LRU order) whose page is
        cache-only; returns pages freed.  Shared pages stay cached."""
        return self.evict(self.n_nodes)

    def _drop(self, node: _Node) -> None:
        assert node.is_leaf and node.parent is not None
        del node.parent.children[node.block]
        self.pager.release_one(CACHE_OWNER, node.page)
        self.n_nodes -= 1

    # -- introspection -------------------------------------------------------
    @property
    def cached_pages(self) -> int:
        return self.n_nodes

    def check(self) -> None:
        """Tree audit: node count, parent links, and one cache reference
        per node (the page side is ``pager.check()``)."""
        held = sorted(self.pager.owned(CACHE_OWNER))
        pages: list[int] = []
        stack = [(self.root, None)]
        count = 0
        while stack:
            node, parent = stack.pop()
            if node.parent is not parent:
                raise AssertionError("parent link broken")
            if node is not self.root:
                count += 1
                pages.append(node.page)
            stack.extend((c, node) for c in node.children.values())
        if count != self.n_nodes:
            raise AssertionError(f"n_nodes drift: {count} != {self.n_nodes}")
        if sorted(pages) != held:
            raise AssertionError("cache-held pages != tree pages")
