"""Radix prefix cache (counterpart of paddle_tpu/serving/prefix_cache.py,
copied: the reference module is stdlib-only): a trie over page-aligned token
chunks mapping shared prompt prefixes to refcounted read-only KV pages.

With the paged layout (kv_pages.py) a prefix is a list of pages, so sharing
it is a page-table copy:

- the trie is keyed on **whole pages** of tokens (``page_tokens`` per
  edge): only fully-written prompt pages are ever inserted, so a shared
  page is immutable by construction: decode for the inserting request
  writes from position ``prompt_len`` onward, past every inserted page,
  and later sharers have their own fresh pages for everything after the
  match.
- ``match()`` walks the longest aligned chunk path, increfs each matched
  page on the caller's behalf, and returns the pages: the admitting
  request copies them into its page-table row and prefills only the
  unshared tail (or skips prefill entirely on a full match, the engine's
  "replay" seat).
- a page whose last slot reference drops and that still has a trie node
  parks in the pool's LRU ``evictable`` set instead of freeing: the bytes
  are a cache, not a leak. ``evict()`` frees least-recently-used
  refcount-zero **leaves** (leaf-first order never frees a page a live
  slot can still gather: any live descendant path was matched through the
  parent).

The trie is host-side pure Python: admission-time work.
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from .kv_pages import PagePool


class _Node:
    __slots__ = ("chunk", "page", "parent", "children", "last_use")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_Node"]):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_use = 0


class RadixPrefixCache:
    """Trie of page-sized token chunks over a :class:`PagePool`.

    All slot-page lifecycle flows through here (``release`` consults the
    trie to decide park-vs-free), so the engine never touches pool
    refcounts directly.
    """

    def __init__(self, pool: PagePool, page_tokens: int):
        self.pool = pool
        self.page_tokens = int(page_tokens)
        self._root: Dict[Tuple[int, ...], _Node] = {}
        self._page_node: Dict[int, _Node] = {}
        self._clock = itertools.count(1)
        self.lookups = 0
        self.hit_tokens = 0
        self.full_hits = 0
        self.partial_hits = 0
        self.inserted_pages = 0
        self.evicted_pages = 0

    # ----------------------------------------------------------- queries
    def _chunks(self, tokens) -> List[Tuple[int, ...]]:
        pt = self.page_tokens
        n = len(tokens) // pt
        return [tuple(int(t) for t in tokens[i * pt:(i + 1) * pt])
                for i in range(n)]

    def peek(self, tokens) -> int:
        """Matched-prefix length in tokens, no refcount side effects (the
        router's prefix-locality probe)."""
        matched = 0
        children = self._root
        for chunk in self._chunks(tokens):
            node = children.get(chunk)
            if node is None:
                break
            matched += self.page_tokens
            children = node.children
        return matched

    def match(self, tokens) -> List[int]:
        """Longest aligned-chunk match; increfs every matched page for the
        caller (release each through :meth:`release` at slot retirement)
        and stamps the path for LRU."""
        self.lookups += 1
        pages: List[int] = []
        children = self._root
        tick = next(self._clock)
        for chunk in self._chunks(tokens):
            node = children.get(chunk)
            if node is None:
                break
            self.pool.incref(node.page)
            node.last_use = tick
            pages.append(node.page)
            children = node.children
        nshared = len(pages) * self.page_tokens
        self.hit_tokens += nshared
        if pages:
            if nshared >= len(tokens):
                self.full_hits += 1
            else:
                self.partial_hits += 1
        return pages

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups that matched at least one page."""
        if not self.lookups:
            return 0.0
        return (self.full_hits + self.partial_hits) / self.lookups

    # ----------------------------------------------------------- updates
    def insert(self, tokens, pages: Sequence[int]) -> None:
        """Publish a request's fully-written prompt pages: ``pages[i]``
        holds chunk ``i`` of ``tokens``. Chunks already present keep the
        incumbent page (ours stays slot-private and frees at retirement);
        new chunks get a node pointing at our page — the slot's reference
        keeps it alive for now, and release() parks it when that drops."""
        children = self._root
        parent: Optional[_Node] = None
        tick = next(self._clock)
        for chunk, page in zip(self._chunks(tokens), pages):
            node = children.get(chunk)
            if node is None:
                if page in self._page_node:   # page already published
                    break                     # (shouldn't happen; be safe)
                node = _Node(chunk, int(page), parent)
                children[chunk] = node
                self._page_node[int(page)] = node
                self.inserted_pages += 1
            node.last_use = tick
            parent = node
            children = node.children

    def release(self, page: int) -> None:
        """Drop one slot reference. At refcount zero the page either parks
        as evictable (it has a trie node — content stays reusable) or goes
        straight back to the free list."""
        if self.pool.decref(page) == 0:
            if page in self._page_node:
                self.pool.park(page, next(self._clock))
            else:
                self.pool.release(page)

    # ---------------------------------------------------------- eviction
    def _evict_one(self) -> bool:
        """Free the least-recently-used refcount-zero leaf. Evicting a
        leaf may expose its parent; callers loop."""
        for page in list(self.pool.evictable):
            node = self._page_node.get(page)
            if node is None or node.children:
                continue
            siblings = (node.parent.children if node.parent is not None
                        else self._root)
            siblings.pop(node.chunk, None)
            del self._page_node[page]
            self.pool.release(page)
            self.evicted_pages += 1
            return True
        return False

    def evict(self, n: int = 1) -> int:
        """Try to free n pages from the evictable set; returns how many
        were actually freed."""
        freed = 0
        while freed < n and self._evict_one():
            freed += 1
        return freed

    def flush(self) -> int:
        """Drop every refcount-zero cached prefix (bench hygiene: measure
        a cold trie against warm executables)."""
        freed = 0
        while self._evict_one():
            freed += 1
        return freed

    def ensure_free(self, n: int) -> bool:
        """Make sure the pool has >= n free pages, evicting cached
        prefixes LRU-first. False if the pool simply isn't big enough."""
        while self.pool.free_count < n:
            if not self._evict_one():
                return False
        return True

    def stats(self) -> Dict[str, float]:
        return {
            "lookups": self.lookups,
            "full_hits": self.full_hits,
            "partial_hits": self.partial_hits,
            "hit_rate": round(self.hit_rate, 4),
            "hit_tokens": self.hit_tokens,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "cached_pages": self.pool.cached,
        }
