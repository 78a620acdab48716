"""Paged KV-cache block allocator (the PagedAttention capacity lever).

The port's own copy of ``repro.serving.paging`` (pure Python, unchanged):
the port imports nothing of the JAX package.

The paper's binding platform constraint for long-context / high-concurrency
serving is **memory capacity** (PAPER §II-B, §V): a dense engine reserves
``max_slots x max_seq`` KV tokens per layer, so short requests strand
capacity and measured concurrency never reaches what the analytical side
says the platform supports.  Paging fixes that: the device keeps one flat
pool of fixed-size pages (``page_size`` tokens each) per attention layer,
and each request owns just enough pages to cover the tokens it has actually
produced — internal fragmentation is bounded by *one page per request*.

This module is the host half: a pure-Python free-list allocator with
per-owner page lists, mirroring the engine's scheduler style (pure Python,
easy to fault-inject and test).  The device half is the resident
``(n_pages, Hkv, page_size, Dh)`` pool + per-segment page tables in
:mod:`repro_torch.models.attention`.

Page id 0 is the **null page**: never allocated, it backs every unused
page-table entry so freed/garbage decode slots write their junk somewhere
harmless and gathers never index out of bounds.

Pages are **refcounted** so a prefix cache (the reference's
``repro.serving.prefix_cache``; not ported yet) can map
one physical page into many requests' page tables: ``ensure`` allocates
fresh pages at refcount 1, ``acquire`` adds a holder to live pages, and
``release`` drops one holder per page — a page returns to the free list
only when its last holder lets go.  Engines that never share pages see the
exact pre-refcount behaviour (every page sits at refcount 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` tokens (ceil division)."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // page_size)


@dataclass
class PageAllocator:
    """Fixed-pool free-list allocator with per-owner accounting.

    ``n_pages`` counts the whole device pool *including* the reserved null
    page 0, so ``usable_pages == n_pages - 1``.  Owners are opaque ints
    (the engine uses request ids); ``ensure`` is idempotent growth —
    allocate-on-append maps to ``ensure(rid, n_tokens)`` once per token or
    page boundary, and ``release`` is free-on-finish.
    """

    n_pages: int
    page_size: int
    _free: list[int] = field(default_factory=list)
    _owned: dict[int, list[int]] = field(default_factory=dict)
    _refs: dict[int, int] = field(default_factory=dict)
    peak_in_use: int = 0

    def __post_init__(self):
        if self.n_pages < 2:
            raise ValueError("PageAllocator needs >= 2 pages (page 0 is the "
                             "reserved null page)")
        if self.page_size < 1:
            raise ValueError("page_size must be >= 1")
        # LIFO free list: recently freed pages are reused first (cache-warm)
        self._free = list(range(self.n_pages - 1, 0, -1))

    # -- capacity ------------------------------------------------------------
    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.usable_pages - len(self._free)

    @property
    def utilization(self) -> float:
        return self.pages_in_use / self.usable_pages if self.usable_pages \
            else 0.0

    def pages_for(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_size)

    def can_fit(self, n_tokens: int) -> bool:
        """Would a fresh request of ``n_tokens`` tokens get its pages?"""
        return self.pages_for(n_tokens) <= self.free_pages

    # -- allocation ----------------------------------------------------------
    def ensure(self, owner: int, n_tokens: int) -> bool:
        """Grow ``owner``'s page list to cover ``n_tokens`` tokens.

        All-or-nothing: on shortage nothing is allocated and False is
        returned (the engine then preempts a victim and retries).  Already
        holding enough pages is a no-op returning True.
        """
        held = self._owned.get(owner, [])
        need = self.pages_for(n_tokens) - len(held)
        if need <= 0:
            return True
        if need > len(self._free):
            return False
        if owner not in self._owned:
            self._owned[owner] = held
        for _ in range(need):
            page = self._free.pop()
            self._refs[page] = 1
            held.append(page)
        self.peak_in_use = max(self.peak_in_use, self.pages_in_use)
        return True

    def acquire(self, owner: int, pages: list[int]) -> None:
        """Add ``owner`` as a holder of already-live ``pages`` (in order).

        This is how the prefix cache maps shared pages read-only into a hit
        request's page table: each page's refcount goes up by one and the
        page is appended to ``owner``'s token-ordered list.  Acquiring a
        free or null page is a bug and raises.
        """
        for p in pages:
            if p == 0 or self._refs.get(p, 0) < 1:
                raise ValueError(f"acquire of non-live page {p}")
        held = self._owned.setdefault(owner, [])
        for p in pages:
            self._refs[p] += 1
            held.append(p)

    def owned(self, owner: int) -> list[int]:
        """Page ids held by ``owner``, in token order."""
        return list(self._owned.get(owner, []))

    def refcount(self, page: int) -> int:
        """Holder count of ``page`` (0 when free)."""
        return self._refs.get(page, 0)

    @property
    def shared_pages(self) -> int:
        """Pages currently mapped by more than one holder."""
        return sum(1 for c in self._refs.values() if c >= 2)

    def release(self, owner: int) -> int:
        """Drop every page reference ``owner`` holds; returns how many pages
        actually went back to the free list (refcount hit 0 — with sharing,
        pages the prefix cache still references survive the owner)."""
        pages = self._owned.pop(owner, [])
        freed = 0
        for p in pages:
            freed += self._decref(p)
        return freed

    def release_one(self, owner: int, page: int) -> bool:
        """Drop ``owner``'s single reference to ``page`` (one occurrence is
        removed from its token-ordered list); True if the page was freed."""
        held = self._owned.get(owner)
        if held is None or page not in held:
            raise ValueError(f"owner {owner} does not hold page {page}")
        held.remove(page)
        if not held:
            del self._owned[owner]
        return bool(self._decref(page))

    def _decref(self, page: int) -> int:
        self._refs[page] -= 1
        if self._refs[page] == 0:
            del self._refs[page]
            self._free.append(page)
            return 1
        return 0

    # -- introspection -------------------------------------------------------
    def holders(self) -> list[int]:
        return list(self._owned)

    def check(self) -> None:
        """Invariant audit (tests / fault injection / ``debug_guards``).

        Every usable page is either on the free list or live, never both and
        never page 0; every live page's refcount equals the number of holder
        lists it appears in (a shared page's refcount == its owner count);
        no refcounted page sits on the free list.
        """
        counts: dict[int, int] = {}
        for owner, pages in self._owned.items():
            for p in pages:
                if p == 0:
                    raise AssertionError(f"owner {owner} holds null page 0")
                if pages.count(p) != 1:
                    raise AssertionError(
                        f"owner {owner} holds page {p} more than once")
                counts[p] = counts.get(p, 0) + 1
        if counts != self._refs:
            bad = {p: (counts.get(p, 0), self._refs.get(p, 0))
                   for p in set(counts) | set(self._refs)
                   if counts.get(p, 0) != self._refs.get(p, 0)}
            raise AssertionError(
                f"refcount drift (page: holders vs refcount): {bad}")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        if free & set(counts):
            raise AssertionError(
                f"refcounted pages on the free list: {free & set(counts)}")
        if 0 in free:
            raise AssertionError("null page 0 on the free list")
        if len(free) + len(counts) != self.usable_pages:
            raise AssertionError("page leak: free + live != usable")
