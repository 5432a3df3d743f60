"""Paged KV cache (counterpart of paddle_tpu/serving/kv_pages.py): fixed-size
pages drawn from one pool, a block allocator, and a per-slot page table.

Each sequence is broken into ``page_tokens``-sized pages (vLLM's
PagedAttention block table, arXiv 2309.06180):

- **device state** (per layer): a page pool ``[num_pages, page_tokens, nh,
  hd]`` plus, for all layers at once, one page table ``[slots, max_pages]``
  of int32 pool indices.
- **read** = gather: ``pool[table]`` reassembles each slot's logical
  ``[max_pages * page_tokens, nh, hd]`` K/V, and the causal mask
  (``col <= query_pos``) makes everything past a slot's offset inert.
- **write** = scatter: token position ``p`` lands in page ``table[slot,
  p // page_tokens]`` at row ``p % page_tokens``. The pools are updated in
  place (``index_put_``), as the contiguous caches are.

Two pool pages are reserved:

- page 0 is the **zero page**: every unallocated page-table entry points
  here and it is never written, so gathering an unallocated region reads
  exact zeros, the values of a freshly zeroed contiguous cache.
- page 1 is the **scratch page**: rows that must not write (idle slots,
  prefix-replay steps re-deriving an already-cached position, prefill pad)
  have their scatter redirected here. It is never read through a table.
  Several rows may write it at once; which write lands is undefined, which
  is harmless only because nothing reads it.

Quantized pages (``kv_cache_dtype``): 'bf16' casts the pool; 'int8' stores
absmax/127 chunk-scaled int8 with one f32 scale per (page, token, head),
dequantized in f32 inside the read.

Host side, :class:`PagePool` is a refcounting block allocator (free list +
LRU-evictable set of refcount-zero pages still referenced by the radix
prefix cache, prefix_cache.py); :func:`truncate_row` frees a slot's pages
past the accepted frontier after a speculative verify window.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Dict, List

import numpy as np
import torch

ZERO_PAGE = 0
SCRATCH_PAGE = 1
RESERVED_PAGES = 2


class PoolExhausted(RuntimeError):
    """No free page and nothing evictable: the pool is undersized for the
    admitted load (raise kv_num_pages or lower slot_count/max_new_cap)."""


class PagePool:
    """Host-side page accounting: a free list plus per-page refcounts.

    The pool tracks *references held by live slots* only; the prefix cache
    holds pages weakly (a refcount-0 page with a trie node parks in the LRU
    ``evictable`` set, still allocated, content preserved, until either
    re-matched or evicted to satisfy an allocation).
    """

    def __init__(self, num_pages: int):
        if num_pages < RESERVED_PAGES + 1:
            raise ValueError(f"num_pages must be > {RESERVED_PAGES}, "
                             f"got {num_pages}")
        self.num_pages = int(num_pages)
        self.free: deque = deque(range(RESERVED_PAGES, self.num_pages))
        self.ref = np.zeros(self.num_pages, np.int32)
        # page -> monotonic clock at last release (LRU eviction order);
        # maintained by the prefix cache via park()
        self.evictable: "OrderedDict[int, int]" = OrderedDict()

    @property
    def free_count(self) -> int:
        return len(self.free)

    @property
    def available(self) -> int:
        """Pages an allocation could obtain (free + evictable-cached)."""
        return len(self.free) + len(self.evictable)

    @property
    def in_use(self) -> int:
        """Pages referenced by at least one live slot."""
        return int((self.ref > 0).sum())

    @property
    def cached(self) -> int:
        """Refcount-zero pages parked for prefix reuse."""
        return len(self.evictable)

    def alloc(self) -> int:
        """Pop a free page with refcount 1. The caller has made sure a free
        page exists (evicting through the prefix cache if needed)."""
        if not self.free:
            raise PoolExhausted(
                f"KV page pool exhausted: {self.num_pages} pages, "
                f"{self.in_use} in use, {self.cached} cached (nothing "
                "evictable was freed); raise kv_num_pages")
        p = self.free.popleft()
        self.ref[p] = 1
        return p

    def incref(self, page: int) -> int:
        self.ref[page] += 1
        if page in self.evictable:      # back in use: no longer evictable
            del self.evictable[page]
        return int(self.ref[page])

    def decref(self, page: int) -> int:
        if self.ref[page] <= 0:
            raise RuntimeError(f"decref of unreferenced page {page}")
        self.ref[page] -= 1
        return int(self.ref[page])

    def release(self, page: int) -> None:
        """Return a refcount-zero page to the free list."""
        if self.ref[page] != 0:
            raise RuntimeError(
                f"release of page {page} with refcount {self.ref[page]}")
        self.evictable.pop(page, None)
        self.free.append(page)

    def park(self, page: int, clock: int) -> None:
        """Park a refcount-zero page as evictable (prefix-cached)."""
        self.evictable[page] = clock
        self.evictable.move_to_end(page)


def resolve_store_dtype(mode, compute_dtype):
    """Map ``kv_cache_dtype`` to (storage dtype, quantized?)."""
    if mode in (None, "", "auto"):
        return compute_dtype, False
    if mode == "bf16":
        return torch.bfloat16, False
    if mode == "int8":
        return torch.int8, True
    raise ValueError(f"kv_cache_dtype must be auto|bf16|int8, got {mode!r}")


def quantize_kv_int8(x):
    """[..., hd] -> (int8 [..., hd], f32 scale [...]): absmax/127 scaling
    with the head dim as the chunk, rounded half to even, clipped to ±127."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    safe = scale.clamp_min(1e-30)
    q = torch.round(xf / safe[..., None]).clamp(-127, 127)
    return q.to(torch.int8), scale


class PagedLayerCache:
    """Per-layer view of the paged KV state, standing in for the dense
    ``(k_cache, v_cache, offset)`` tuple GPTModel indexes (``cache[2]`` ->
    the per-row offsets).

    offset: [b] count of already-cached positions per row (the write
    position of this step's first token), clamped by the engine.
    write_mask: bool [b] or [b, s]: rows / positions whose scatter goes to
    a real page; everything else is redirected to the scratch page.
    page_table: [b, n_pages] int64 pool indices on the pools' device.
    """

    def __init__(self, k_pool, v_pool, page_table, offset, write_mask,
                 page_tokens: int, compute_dtype, k_scale=None, v_scale=None):
        self.k_pool = k_pool            # [P, pt, nh, hd] storage dtype
        self.v_pool = v_pool
        self.page_table = page_table
        self.offset = offset
        self.write_mask = write_mask
        self.page_tokens = int(page_tokens)
        self.compute_dtype = compute_dtype
        self.k_scale = k_scale          # [P, pt, nh] f32 (int8 pages only)
        self.v_scale = v_scale

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    def __getitem__(self, i):
        if i == 2:      # GPTModel reads caches[0][2] for the position embedding
            return self.offset
        raise IndexError(f"PagedLayerCache exposes only [2] (offset), "
                         f"got [{i}]")


def update_and_read(cache: PagedLayerCache, k, v):
    """Scatter this step's K/V into the pools through the page table (in
    place), then gather the logical cache back out in the compute dtype.

    k, v: [b, s, nh, hd]. Returns (kc, vc, new_cache): kc/vc are the dense
    [b, n_pages * page_tokens, nh, hd] views attention reads, and new_cache
    is the same pools with the offset advanced by s.
    """
    b, s = k.shape[0], k.shape[1]
    pt = cache.page_tokens
    table = cache.page_table
    t_eff = table.shape[1] * pt
    dev = k.device

    pos = cache.offset.to(torch.long)[:, None] + torch.arange(s, device=dev)[None, :]
    pos_c = pos.clamp(0, t_eff - 1)                            # [b, s]
    within = pos_c % pt
    gpage = torch.gather(table, 1, pos_c // pt)                # [b, s]
    wm = cache.write_mask
    if wm.dim() == 1:
        wm = wm[:, None]
    # positions past the table (an idle slot at the cache tip, prefill pad)
    # always redirect: no write may ever reach the zero page
    wm = wm & (pos < t_eff)
    target = torch.where(wm, gpage, torch.full_like(gpage, SCRATCH_PAGE))

    if cache.quantized:
        qk, sk = quantize_kv_int8(k)                           # [b,s,nh,hd] / [b,s,nh]
        qv, sv = quantize_kv_int8(v)
        cache.k_pool.index_put_((target, within), qk)
        cache.v_pool.index_put_((target, within), qv)
        cache.k_scale.index_put_((target, within), sk)
        cache.v_scale.index_put_((target, within), sv)
    else:
        cache.k_pool.index_put_((target, within), k.to(cache.k_pool.dtype))
        cache.v_pool.index_put_((target, within), v.to(cache.v_pool.dtype))

    def gather(pool, scale):
        g = pool[table]                                        # [b, n_pages, pt, nh, hd]
        if scale is not None:
            g = g.float() * scale[table][..., None]
        return g.reshape((b, t_eff) + g.shape[3:]).to(cache.compute_dtype)

    kc = gather(cache.k_pool, cache.k_scale)
    vc = gather(cache.v_pool, cache.v_scale)
    new_cache = PagedLayerCache(
        cache.k_pool, cache.v_pool, table, cache.offset + s, cache.write_mask,
        pt, cache.compute_dtype, cache.k_scale, cache.v_scale)
    return kc, vc, new_cache


def truncate_row(tables, slot_pages: List[int], release, slot: int,
                 keep_pages: int) -> int:
    """Speculative decoding's rollback of a paged slot (reference
    kv_pages.py:261): drop the page-table entries from ``keep_pages`` on and
    return their pages to the pool.

    After a verify window is partly rejected the slot's offset rewinds to
    the accepted frontier; the pages past ``keep_pages`` (the page holding
    the next write position, plus one) hold only rejected rows. They are
    always the slot's own: shared prefix pages and published prompt pages
    lie below ``new_off // page_tokens``, generation starting at the prompt
    length, so releasing them through the prefix cache frees them.

    tables: host [slots, max_pages] int32; slot_pages: the slot's page list
    (mutated); release: RadixPrefixCache.release. Returns the pages freed.
    """
    freed = 0
    for pi in range(keep_pages, tables.shape[1]):
        page = int(tables[slot, pi])
        if page == ZERO_PAGE:
            continue
        tables[slot, pi] = ZERO_PAGE
        slot_pages.remove(page)
        release(page)
        freed += 1
    return freed


def make_pool_state(num_layers: int, num_pages: int, page_tokens: int,
                    num_heads: int, head_dim: int, slots: int,
                    max_pages: int, store_dtype, quantized: bool,
                    device=None) -> Dict:
    """Device-side paged state: per-layer K/V pools, per-layer scale pools
    (int8 pages only) and the shared int32 page table."""
    shape = (num_pages, page_tokens, num_heads, head_dim)
    state = {
        "k": [torch.zeros(shape, dtype=store_dtype, device=device)
              for _ in range(num_layers)],
        "v": [torch.zeros(shape, dtype=store_dtype, device=device)
              for _ in range(num_layers)],
        "ks": [], "vs": [],
        "tables": torch.zeros((slots, max_pages), dtype=torch.int32,
                              device=device),
    }
    if quantized:
        sshape = (num_pages, page_tokens, num_heads)
        state["ks"] = [torch.zeros(sshape, dtype=torch.float32, device=device)
                       for _ in range(num_layers)]
        state["vs"] = [torch.zeros(sshape, dtype=torch.float32, device=device)
                       for _ in range(num_layers)]
    return state


def pool_state_bytes(state: Dict) -> int:
    """Device bytes of pools + scales + tables (the paged engine's KV-cache
    footprint)."""
    tensors = [*state["k"], *state["v"], *state["ks"], *state["vs"],
               state["tables"]]
    return sum(t.numel() * t.element_size() for t in tensors)


def layer_views(state: Dict, table, offset, write_mask, page_tokens: int,
                compute_dtype) -> List[PagedLayerCache]:
    """One PagedLayerCache per layer over a (possibly sliced) int64 table."""
    n = len(state["k"])
    ks = state["ks"] or [None] * n
    vs = state["vs"] or [None] * n
    return [PagedLayerCache(state["k"][i], state["v"][i], table, offset,
                            write_mask, page_tokens, compute_dtype,
                            ks[i], vs[i])
            for i in range(n)]
