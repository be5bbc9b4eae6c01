"""Host-side page bookkeeping for the paged KV cache — the port of
``adapt_tpu/runtime/paged.py``'s :class:`Pager` (with :class:`PagerStats`
and the radix metadata) and ``insert_prefill_pages``.

The device side is ``ops/paged_attention`` (pools + kernels K3/K4); this
module owns the ALLOCATOR: a free list of physical pages, per-slot page
ownership, and the (slots, pages_per_slot) page table the decode step
consumes. The allocator is plain numpy/python on the serving control path,
copied from the JAX package with its names and semantics: refcounted
content-keyed prefix pages, an LRU of rc=0 cached pages, the radix books
over token blocks, copy-on-write claims (``retain`` / ``release_claim``)
and sliding-window recycling (``release_prefix``).

Conventions (shared with ``ops/paged_attention``):
- page 0 is the shared TRASH page: never allocated, the target of every
  unallocated table entry and of idle rows' garbage writes. Reads of it
  are always masked; concurrent garbage writes to it are unordered and
  unread.
- a slot's table row holds its pages in logical order; entries past its
  allocation point at the trash page.
- low page ids hand out first.

The host KV tier (``HostKVTier``) waits for the fleet slice; the
``evict_hook`` seam stays, unused by the batcher.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PagerStats:
    num_pages: int  # total pool pages incl. trash
    free: int  # immediately allocatable (free list + evictable cache)
    in_use: int  # rc > 0, excl. trash
    cached: int  # rc == 0 but resident for prefix reuse
    prefix_hits: int
    prefix_misses: int
    prefix_capacity_skips: int  # resident page, but the table row was full
    radix_nodes: int  # resident token-block nodes (== registered keys)
    radix_partial_hits: int  # admissions whose match ended mid-path
    radix_hit_tokens: int  # prompt tokens answered from resident nodes
    cow_forks: int  # fan-out page forks (private copy of a shared page)


@dataclasses.dataclass
class _RadixNode:
    """Metadata for one resident token-block node. The tree STRUCTURE
    lives in the content keys themselves (a node's key is its full
    root path; the parent key is the same bytes minus one page of
    tokens), so nodes need no child pointers — only what a flat key
    can't carry: the block depth and how hot the node runs."""

    depth: int  # 1-based page depth (covers depth * page_tokens tokens)
    hits: int = 0  # lookup_share acquisitions through this node


class Pager:
    """Free-list page allocator with refcounted prefix sharing over a
    pool of ``num_pages`` physical pages (page 0 reserved as trash) for
    ``slots`` lockstep slots whose table rows are ``pages_per_slot``
    wide."""

    def __init__(
        self,
        num_pages: int,
        slots: int,
        pages_per_slot: int,
        page_tokens: int | None = None,
    ):
        if num_pages < 2:
            raise ValueError(f"num_pages must be >= 2, got {num_pages}")
        if pages_per_slot < 1:
            raise ValueError(
                f"pages_per_slot must be >= 1, got {pages_per_slot}"
            )
        self.num_pages = num_pages
        self.pages_per_slot = pages_per_slot
        #: Tokens per page — lets the radix books convert page depths
        #: to token counts and ``radix_probe`` walk a raw prompt. None
        #: (a caller that never probes by tokens) degrades the radix
        #: view to depth-0 nodes with the byte registry untouched.
        self.page_tokens = page_tokens
        # Pop from the end -> low page ids hand out first (determinism
        # helps test reproducibility; no perf meaning).
        self._free = list(range(num_pages - 1, 0, -1))
        self._owned: list[list[int]] = [[] for _ in range(slots)]
        #: Rolling-window offset: how many LEADING logical ordinals of
        #: each slot have been released mid-request (sliding-window
        #: recycling). owned[0] then sits at table ordinal base[slot].
        self._base: list[int] = [0 for _ in range(slots)]
        self._rc: dict[int, int] = {}
        # Content-addressed prefix registry: key -> page, both ways.
        self._by_key: dict[bytes, int] = {}
        self._key_of: dict[int, bytes] = {}
        # rc==0 registered pages, oldest-first (eviction order).
        self._lru: collections.OrderedDict[int, None] = (
            collections.OrderedDict()
        )
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_capacity_skips = 0
        #: Radix metadata, keyed by the SAME content keys as _by_key
        #: (kept in lockstep: inserted by register/adopt_cached, dropped
        #: by the two eviction paths) — the byte registry stays the one
        #: source of residency truth, radix coherence with the host
        #: tier's spill/readmit keys is free.
        self._radix: dict[bytes, _RadixNode] = {}
        self.radix_partial_hits = 0
        self.radix_hit_tokens = 0
        self.radix_evictions = 0
        self.cow_forks = 0
        #: Optional eviction callback ``(page, key) -> None``, invoked
        #: just BEFORE a registered rc=0 page leaves the pool (LRU
        #: eviction under allocation pressure, or an ``evict_cached``
        #: sweep) — the hierarchical-cache seam a host tier will use to
        #: spill the page's bytes instead of killing the content. The
        #: page's bytes are still readable when the hook runs (the new
        #: owner writes later), and the hook must not reenter the pager.
        self.evict_hook = None

    @property
    def num_allocatable(self) -> int:
        """Pages the allocator can ever hand out: the pool minus the
        reserved trash page — the denominator occupancy gauges and
        capacity planning should use (``num_pages`` counts the trash
        page too)."""
        return self.num_pages - 1

    # -- raw pages ---------------------------------------------------------

    def _take_one(self) -> int | None:
        if self._free:
            return self._free.pop()
        if self._lru:  # evict the coldest cached prefix page
            page, _ = self._lru.popitem(last=False)
            key = self._key_of.pop(page)
            del self._by_key[key]
            self._radix_drop(key)
            if self.evict_hook is not None:
                self.evict_hook(page, key)
            return page
        return None

    # -- radix metadata (keys double as root-to-node paths) ----------------

    def _radix_add(self, key: bytes) -> None:
        if key not in self._radix:
            depth = (
                len(key) // (4 * self.page_tokens)
                if self.page_tokens
                else 0
            )
            self._radix[key] = _RadixNode(depth=depth)

    def _radix_drop(self, key: bytes) -> None:
        if self._radix.pop(key, None) is not None:
            self.radix_evictions += 1

    def can_alloc(self, n: int) -> bool:
        return len(self._free) + len(self._lru) >= n

    def alloc(self, slot: int, n: int) -> bool:
        """Grant ``n`` MORE pages to ``slot``; all-or-nothing. False if
        the pool cannot cover it even after evicting every rc=0 cached
        page (caller leaves the request queued)."""
        owned = self._owned[slot]
        if self._base[slot] + len(owned) + n > self.pages_per_slot:
            raise ValueError(
                f"slot {slot}: {self._base[slot]}+{len(owned)}+{n} pages "
                f"exceeds table width {self.pages_per_slot}"
            )
        if not self.can_alloc(n):
            return False
        for _ in range(n):
            page = self._take_one()
            self._rc[page] = 1
            owned.append(page)
        return True

    def _release_one(self, page: int) -> None:
        """Drop one claim on ``page``; at rc=0 it returns to the free
        list — unless registered as prefix cache, in which case it
        stays resident and evictable (LRU)."""
        self._rc[page] -= 1
        if self._rc[page] == 0:
            del self._rc[page]
            if page in self._key_of:
                self._lru[page] = None  # newest = last evicted
            else:
                self._free.append(page)

    def free_slot(self, slot: int) -> None:
        """Drop ``slot``'s claim on all its pages."""
        for page in reversed(self._owned[slot]):
            self._release_one(page)
        self._owned[slot] = []
        self._base[slot] = 0

    def release_prefix(self, slot: int, n: int) -> None:
        """Sliding-window recycling: release ``slot``'s first ``n``
        logical pages MID-REQUEST (they fell wholly behind the
        attention window — masked forever, written never again). Their
        table ordinals point at the trash page from here on; shared /
        registered pages follow the usual rc / LRU rules, so a released
        prompt page can still serve future prefix hits."""
        if n <= 0:
            return
        if n > len(self._owned[slot]):
            raise ValueError(
                f"slot {slot}: releasing {n} of "
                f"{len(self._owned[slot])} owned pages"
            )
        for page in self._owned[slot][:n]:
            self._release_one(page)
        self._owned[slot] = self._owned[slot][n:]
        self._base[slot] += n

    def base(self, slot: int) -> int:
        return self._base[slot]

    def owned(self, slot: int) -> list[int]:
        return list(self._owned[slot])

    def table(self) -> np.ndarray:
        """(slots, pages_per_slot) int32; unallocated (and released)
        entries -> trash page 0."""
        t = np.zeros((len(self._owned), self.pages_per_slot), np.int32)
        for i, pages in enumerate(self._owned):
            b = self._base[i]
            t[i, b: b + len(pages)] = pages
        return t

    # -- prefix sharing ----------------------------------------------------

    @staticmethod
    def prefix_key(tokens: np.ndarray, upto: int) -> bytes:
        """Content key for the page covering positions [upto-P, upto):
        the whole prompt prefix [0, upto) (K/V at position p depend on
        every earlier token, so the key must cover them all)."""
        return np.ascontiguousarray(tokens[:upto], np.int32).tobytes()

    def lookup_share(self, slot: int, key: bytes) -> int | None:
        """If ``key``'s page is resident, acquire it for ``slot``
        (rc+1, out of the eviction LRU) and return it."""
        page = self._by_key.get(key)
        if page is None:
            self.prefix_misses += 1
            return None
        # Row-capacity check mirrors alloc()'s accounting: the recycled
        # window base occupies leading ordinals even though the pages are
        # gone (len(owned) alone would overflow the row of a slot sharing
        # into a partially-recycled window).
        if self._base[slot] + len(self._owned[slot]) + 1 > self.pages_per_slot:
            # A miss for accounting (hits+misses == probes) with its own
            # counter: the page WAS resident, the row was just full.
            self.prefix_misses += 1
            self.prefix_capacity_skips += 1
            return None
        self._lru.pop(page, None)
        self._rc[page] = self._rc.get(page, 0) + 1
        self._owned[slot].append(page)
        self.prefix_hits += 1
        node = self._radix.get(key)
        if node is not None:
            node.hits += 1
        return page

    def retain(self, page: int) -> None:
        """Take one RAW claim on ``page`` (rc+1, out of the eviction
        LRU) without binding it to a slot — how a fan-out group pins
        its shared last-prompt page so it cannot recycle before every
        queued sibling has forked off it. Balance with
        :meth:`release_claim`."""
        self._lru.pop(page, None)
        self._rc[page] = self._rc.get(page, 0) + 1

    def release_claim(self, page: int) -> None:
        """Drop a :meth:`retain` claim; the usual rc=0 rules apply
        (registered pages park in the LRU, others return free)."""
        self._release_one(page)

    def record_prefix_match(self, matched_pages: int, prompt_len: int) -> None:
        """Token-weighted admission accounting for one radix walk:
        ``matched_pages`` leading pages of a ``prompt_len``-token
        prompt were answered from resident nodes. A match that ends
        strictly inside the prompt's shareable page run is a PARTIAL
        hit — the case whole-run keying would have scored as a total
        miss."""
        if matched_pages <= 0 or not self.page_tokens:
            return
        self.radix_hit_tokens += matched_pages * self.page_tokens
        if matched_pages < (prompt_len - 1) // self.page_tokens:
            self.radix_partial_hits += 1

    def note_cow_fork(self) -> None:
        """One fan-out sibling forked a private copy of a shared page
        (the copy-on-write write point)."""
        self.cow_forks += 1

    def radix_probe(self, tokens) -> tuple[int, int, int]:
        """Read-only radix walk for a prompt: ``(matched_pages,
        matched_tokens, heat)`` of the deepest resident token-block
        path, where ``heat`` sums the path nodes' lifetime hit counts.
        No counters move and nothing is acquired — safe to call per
        queued candidate (the scheduler's cache-aware ordering and
        `prefix_cached` both score with it). The walk caps at
        ``(len(tokens)-1)//page_tokens`` pages, mirroring the admission
        probe: the page holding the last prompt token is never shared
        because its tail positions get written."""
        if not self.page_tokens:
            return (0, 0, 0)
        tokens = np.ascontiguousarray(
            np.asarray(tokens, np.int32).reshape(-1)
        )
        raw = tokens.tobytes()
        step = 4 * self.page_tokens
        pages = heat = 0
        for j in range((tokens.shape[0] - 1) // self.page_tokens):
            node = self._radix.get(raw[: (j + 1) * step])
            if node is None:
                break
            pages += 1
            heat += node.hits
        return (pages, pages * self.page_tokens, heat)

    def radix_sketch(self, k: int) -> list[tuple[bytes, int, int]]:
        """Top-``k`` resident radix nodes by token-weighted heat:
        ``[(content_key, depth, hits)]``, hottest first. Weight is
        ``depth * (1 + hits)`` — depth counts the tokens a match at
        this node saves, the ``1 +`` keeps never-hit (freshly
        registered) deep prefixes rankable at all. Read-only snapshot
        (``list()`` at C speed: a reader thread may call while the
        ticking thread mutates) — what a capacity plane exports as its
        prefix-affinity sketch."""
        if not self.page_tokens or k <= 0:
            return []
        items = list(self._radix.items())
        items.sort(
            key=lambda kv: (
                kv[1].depth * (1 + kv[1].hits), kv[1].depth,
            ),
            reverse=True,
        )
        return [(key, n.depth, n.hits) for key, n in items[:k]]

    def adopt_cached(self, keys: list[bytes]) -> list[tuple[int, int]]:
        """Adopt EXTERNALLY prefilled prefix pages into the cache — the
        disaggregated-serving landing path (``runtime/disagg``): for
        every key not already resident, take a pool page, register it
        under its content key and park it rc=0 in the LRU (newest), so
        the next admission whose prompt hashes to these keys shares
        them exactly like locally computed prefix pages (evictable
        under pressure by the usual rules until then). Returns
        ``[(ordinal, page)]`` for the keys actually adopted — the
        caller scatters ONLY those ordinals' K/V (already-resident keys
        dedupe against the cache; first writer won). Returns ``[]``
        with nothing taken when the pool cannot cover the new pages
        all-or-nothing (the caller falls back to a collocated
        prefill — adoption is an optimization, never a correctness
        gate)."""
        fresh = [
            (i, k) for i, k in enumerate(keys) if k not in self._by_key
        ]
        if not fresh or not self.can_alloc(len(fresh)):
            return []
        out = []
        for i, key in fresh:
            page = self._take_one()
            self._by_key[key] = page
            self._key_of[page] = key
            self._radix_add(key)
            self._lru[page] = None  # rc=0, resident, newest
            out.append((i, page))
        return out

    def evict_cached(self, n: int | None = None) -> int:
        """Evict up to ``n`` (default: all) COLD prefix-cache pages —
        rc=0 LRU residents, oldest first — back to the free list,
        dropping their content keys. The degradation ladder's sweep
        rung (``runtime/scheduler``): capacity-NEUTRAL by construction
        (``can_alloc`` already counts the LRU and ``alloc`` evicts on
        demand), it trades the cache's speculative prefix-hit value
        for the allocator's free-list fast path under overload. Live
        (rc>0) pages are untouched; the pool partition (used + free +
        cached) is conserved. Returns the count evicted."""
        evicted = 0
        while self._lru and (n is None or evicted < n):
            page, _ = self._lru.popitem(last=False)
            key = self._key_of.pop(page)
            del self._by_key[key]
            self._radix_drop(key)
            if self.evict_hook is not None:
                self.evict_hook(page, key)
            self._free.append(page)
            evicted += 1
        return evicted

    def resident(self, key: bytes) -> bool:
        """True when ``key``'s page is in the pool (owned or cached) —
        the no-accounting residency probe the host-tier readmit path
        uses BEFORE ``lookup_share`` (which counts a hit or miss)."""
        return key in self._by_key

    def cached_pages(self) -> list[tuple[int, bytes]]:
        """The rc=0 prefix-cache residents with their content keys,
        oldest (next-evicted) first — the proactive spill sweep's
        working set. Spill candidates come ONLY from here: a page
        referenced by a live slot (rc > 0) never appears, which is
        what keeps lossy host-tier codecs away from live decode
        state."""
        return [(p, self._key_of[p]) for p in self._lru]

    def register(self, page: int, key: bytes) -> None:
        """Publish ``page`` (currently owned, rc>=1) as the cache entry
        for ``key``. First writer wins; a page may carry one key."""
        if key in self._by_key or page in self._key_of:
            return
        self._by_key[key] = page
        self._key_of[page] = key
        self._radix_add(key)

    def stats(self) -> PagerStats:
        # O(1): the batcher takes these books at the end of every tick
        # half. _rc holds only referenced pages (an entry goes when its
        # count reaches 0), so its size is the in-use count.
        return PagerStats(
            num_pages=self.num_pages,
            free=len(self._free) + len(self._lru),
            in_use=len(self._rc),
            cached=len(self._lru),
            prefix_hits=self.prefix_hits,
            prefix_misses=self.prefix_misses,
            prefix_capacity_skips=self.prefix_capacity_skips,
            radix_nodes=len(self._radix),
            radix_partial_hits=self.radix_partial_hits,
            radix_hit_tokens=self.radix_hit_tokens,
            cow_forks=self.cow_forks,
        )


def insert_prefill_pages(pool, pages, kv):
    """Scatter a prefilled request's contiguous (1, kv_h, S, w) K or V
    into its physical ``pages`` ((n,) int, logical order) of ``pool``
    (num_pages, kv_h, page, w) IN PLACE, and return the pool. S pads up
    to n * page positions with zeros that sit beyond the prompt (masked
    until decode overwrites them). One index_copy_ on the page axis. A
    quantized ``(values, scales)`` pool takes a pair and scatters both
    members by the same pages, so a page's scales travel with its
    values."""
    if isinstance(pool, tuple):
        return tuple(insert_prefill_pages(p, pages, x)
                     for p, x in zip(pool, kv))
    pages = torch.as_tensor(pages, device=pool.device).long().reshape(-1)
    n = pages.shape[0]
    _, kvh, page, hd = pool.shape
    s = kv.shape[2]
    if s > n * page:
        raise ValueError(f"{s} positions do not fit {n} pages of {page}")
    kvp = torch.nn.functional.pad(kv[0], (0, 0, 0, n * page - s))
    kvp = kvp.reshape(kvh, n, page, hd).transpose(0, 1)
    pool.index_copy_(0, pages, kvp.to(pool.dtype))
    return pool
