"""Refcounted, hash-indexed prefix cache over the paged KV pool (port of
inference/prefix_cache.py, host only; the port keeps its own copy because
importing any module of the JAX package imports JAX).

Concurrent requests that share a prompt prefix (the system-prompt
pattern of production serving) would otherwise prefill and store the
same K/V pages once per request. This module is the sharing layer the
continuous-batching engine (inference/engine.py) consults at admission:
prompt prefixes are indexed page-aligned (an entry per full page of
prompt tokens, keyed by the exact token prefix through that page), and a
cache hit maps the same physical pages into the new request's page table
instead of prefilling them again. The ragged paged attention already
reads per-slot page tables (ops/prefill_attention.py), so sharing is a
scheduler and page-table change only.

Sharing rules (each one is load-bearing for correctness):

- **Page-aligned, full pages only.** An entry covers tokens
  [0, depth*page_size) of some prompt, identified by its own page's
  exact token slice chained through its parent entry (dict-indexed,
  collision-free: the dict keys are the tokens at every level; the full
  prefix is never materialized, since a full key tuple per depth would
  hold O(P^2) tokens for a P-page prefix). Partial trailing prompt pages
  are never registered: their pages also receive decode writes, so their
  content depends on the request that produced them.
- **Cap at len(prompt) - 1.** At least one prompt token always
  prefills: the engine needs the forward's next-token logits for the
  last prompt position.
- **Copy-on-write on the first divergent page.** When a prompt matches
  a cached prefix beyond its last full-page hit but diverges (or ends)
  mid-page, the matching leading rows of that page are still valid KV
  (position p's K/V depends only on tokens <= p). The engine copies that
  page into a private page and resumes prefill at the divergence offset,
  so the shared page never sees the new request's writes.
- **Refcounts gate the free list.** A page referenced by any slot is
  never freed and never evicted. Release at refcount zero retains
  registered pages in the cache (LRU-stamped, evictable); unregistered
  pages go back to the engine's free list.
- **LRU eviction, leaves first.** Under pool pressure the engine
  reclaims unreferenced cached pages longest-suffix-first (an entry with
  registered children is pinned by them). Every eviction batch logs and
  counts toward `evicted_pages`.

Thread contract: every mutating call happens on the engine's serve
thread; `stats()` reads plain ints and is safe from the metrics thread.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

_logger = logging.getLogger(__name__)


@dataclass
class _Entry:
    """One cached full page of prompt prefix: `own` is the page's own
    token slice [(depth-1)*page_size, depth*page_size); the covered
    prefix is the `own` chain walked up through `parent_page` (pages
    are unique physical ids, so the parent page IS the parent's
    identity). `page` is the physical pool page holding the KV."""

    own: Tuple[int, ...]
    page: int
    parent_page: Optional[int]  # None for depth-1 entries
    depth: int  # pages of prompt prefix this entry completes
    last_used: int = 0  # LRU stamp, bumped on match and on release


@dataclass
class Match:
    """Admission-time lookup result. `pages` are the full-page hits in
    prefix order; `matched` counts ALL reusable tokens (full pages plus
    the valid leading rows of the COW page); `cow_src` is the physical
    page to copy when the match ends mid-page (None otherwise)."""

    pages: List[int] = field(default_factory=list)
    matched: int = 0
    cow_src: Optional[int] = None

    @property
    def full_pages(self) -> int:
        return len(self.pages)


class PrefixCache:
    def __init__(self, page_size: int):
        assert page_size >= 1
        self.page_size = page_size
        self._by_page: Dict[int, _Entry] = {}
        # trie edges: parent page (None = root) -> {own page tokens ->
        # child entry}. The per-page-tokens inner key lets lookup()
        # walk one page slice at a time (O(len(prompt)) total) instead
        # of rebuilding and hashing a fresh full-prefix tuple per depth
        # (O(L^2/ps) — the serve thread re-runs lookup every round for
        # a pool-blocked FIFO head, exactly when admission is already
        # under pressure), and keying nodes by their physical page
        # keeps stored tokens at O(prefix length) per chain instead of
        # O(P^2) full-key tuples. A parent with live children is never
        # evictable (their match walk depends on its tokens/KV).
        self._children: Dict[Optional[int],
                             Dict[Tuple[int, ...], _Entry]] = {}
        # slot references per page — ONLY pages the cache tracks
        # (entries); the engine free-lists everything else itself
        self._ref: Dict[int, int] = {}
        self._clock = 0  # LRU clock (monotonic, bumped per touch)

        # accounting (exported via DecodeEngine.counters)
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.hits = 0  # requests with matched > 0
        self.lookups = 0
        self.cow_copies = 0
        self.evicted_pages = 0
        self.inserted_pages = 0

    # -- lookup / acquire --------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, prompt: List[int]) -> Match:
        """Longest reusable prefix of `prompt`, capped at
        len(prompt) - 1 tokens: consecutive full-page entry hits from
        page 0, then at most one mid-page (COW) continuation among the
        last hit's children. Read-only — acquire() claims the result."""
        ps = self.page_size
        cap = len(prompt) - 1
        m = Match()
        depth = 0
        node_page: Optional[int] = None
        while (depth + 1) * ps <= cap:
            # one trie edge per page: hash only the page's own tokens,
            # never a rebuilt full-prefix tuple (O(len(prompt)) total)
            e = self._children.get(node_page, {}).get(
                tuple(prompt[depth * ps: (depth + 1) * ps]))
            if e is None:
                break
            depth += 1
            node_page = e.page
            m.pages.append(e.page)
            e.last_used = self._tick()
        m.matched = depth * ps
        # mid-page continuation: the child sharing the longest leading
        # run with the next prompt page is COW-shareable for that run
        nxt = prompt[depth * ps: (depth + 1) * ps]
        best, best_common = None, 0
        for own, e in self._children.get(node_page, {}).items():
            common = 0
            for a, b in zip(own, nxt):
                if a != b:
                    break
                common += 1
            if common > best_common:
                best, best_common = e, common
        valid = min(depth * ps + best_common, cap)
        if best is not None and valid > m.matched:
            m.cow_src = best.page
            m.matched = valid
            best.last_used = self._tick()
        return m

    def note(self, prompt_tokens: int, matched: int) -> None:
        """Book one ADMITTED request's hit accounting. Separate from
        lookup() on purpose: a pool-blocked FIFO head re-looks-up every
        scheduler round, and counting those retries would inflate the
        hit-rate gauge."""
        self.lookups += 1
        self.lookup_tokens += prompt_tokens
        if matched > 0:
            self.hits += 1
            self.hit_tokens += matched

    def acquire(self, match: Match) -> None:
        """Claim a lookup result for a slot: refcount every full-page
        hit AND the COW source (pinned against eviction until the page
        copy has been issued — release_page() drops that pin)."""
        for pg in match.pages:
            self._ref[pg] = self._ref.get(pg, 0) + 1
        if match.cow_src is not None:
            self._ref[match.cow_src] = self._ref.get(match.cow_src, 0) + 1

    def unacquire(self, match: Match) -> None:
        """Undo acquire() when admission backs out (pool still short
        after eviction): exact inverse, pages stay cached."""
        for pg in match.pages:
            self.release(pg)
        if match.cow_src is not None:
            self.release(match.cow_src)

    # -- registration / release --------------------------------------------

    def insert(self, prefix_tokens: List[int], page: int) -> bool:
        """Register `page` as the cache entry for the full-page prefix
        `prefix_tokens` (length must be a page multiple; the KV must
        already be written — the engine registers as prefill passes
        each boundary). The registering slot's reference carries over
        (refcount 1). Returns False when the key already exists (a
        concurrent request prefilled the same prefix first): the page
        stays untracked and the engine free-lists it at retirement."""
        assert len(prefix_tokens) % self.page_size == 0 and prefix_tokens
        ps = self.page_size
        depth = len(prefix_tokens) // ps
        parent_page: Optional[int] = None
        for d in range(depth - 1):
            pe = self._children.get(parent_page, {}).get(
                tuple(prefix_tokens[d * ps: (d + 1) * ps]))
            if pe is None:
                # broken parent chain (an ancestor evicted between this
                # slot's earlier boundary and now): the entry would be
                # unreachable by lookup's root walk — leave the page
                # untracked instead of caching garbage
                return False
            parent_page = pe.page
        own = tuple(prefix_tokens[(depth - 1) * ps:])
        kids = self._children.setdefault(parent_page, {})
        if own in kids:
            return False
        e = _Entry(own=own, page=page, parent_page=parent_page,
                   depth=depth, last_used=self._tick())
        kids[own] = e
        self._by_page[page] = e
        self._ref[page] = self._ref.get(page, 0) + 1
        self.inserted_pages += 1
        return True

    def insert_chain(self, prefix_tokens: List[int],
                     pages: List[int]) -> List[int]:
        """Register a TRANSFERRED page chain (the cross-replica KV
        hand-off): page `pages[d-1]` holds the KV for prefix depth `d`.
        Unlike a prefilling slot's insert(), no slot references these
        pages — each successful insert's registering reference is
        dropped immediately, so the chain lands registered-but-
        unreferenced: the next lookup maps it for free, and eviction
        may reclaim it under pool pressure like any idle entry.
        Returns the pages the cache did NOT retain (prefix already
        cached here, or chain broken by concurrent eviction) — the
        caller free-lists those; their KV is bitwise identical to the
        retained entry's, so dropping duplicates loses nothing."""
        ps = self.page_size
        assert len(prefix_tokens) == len(pages) * ps and pages
        rejected: List[int] = []
        for d, pg in enumerate(pages, start=1):
            if self.insert(prefix_tokens[: d * ps], pg):
                retained = self.release(pg)
                assert retained  # fresh entry: registered, now idle
            else:
                rejected.append(pg)
        return rejected

    def owns(self, page: int) -> bool:
        return page in self._ref or page in self._by_page

    def release(self, page: int) -> bool:
        """Drop one slot reference. Returns True when the cache RETAINS
        the page (registered entry, or still referenced by another
        slot) — the caller must NOT free-list it; False hands the page
        back to the caller."""
        if page not in self._ref:
            return False  # never tracked: caller's page
        self._ref[page] -= 1
        if self._ref[page] > 0:
            return True
        del self._ref[page]
        e = self._by_page.get(page)
        if e is None:
            return False  # was only a COW-source pin on a foreign page
        e.last_used = self._tick()  # unreferenced now: LRU-evictable
        return True

    # alias with intent: dropping the temporary COW-source pin
    release_page = release

    # -- eviction ----------------------------------------------------------

    def _evictable(self) -> List[_Entry]:
        return [
            e for e in self._by_page.values()
            if self._ref.get(e.page, 0) == 0
            and not self._children.get(e.page)
        ]

    def evict(self, need_pages: int) -> List[int]:
        """Reclaim up to `need_pages` pages from unreferenced LEAF
        entries, least-recently-used first (evicting a leaf can expose
        its parent as the next candidate). Never touches a referenced
        page. One candidate scan + a heap per batch — this runs on the
        serve thread's admission path under pool pressure, exactly when
        a per-page rescan of every entry would hurt most. Loud: one
        warning per batch with the accounting."""
        import heapq

        freed: List[int] = []
        heap = [(e.last_used, e.page) for e in self._evictable()]
        heapq.heapify(heap)
        while heap and len(freed) < need_pages:
            _, page = heapq.heappop(heap)
            e = self._by_page.get(page)
            if (e is None or self._ref.get(page, 0)
                    or self._children.get(page)):
                continue  # stale heap entry
            del self._by_page[page]
            kids = self._children.get(e.parent_page)
            if kids is not None:
                kids.pop(e.own, None)
                if not kids:
                    del self._children[e.parent_page]
            self._children.pop(page, None)
            freed.append(page)
            pe = (self._by_page.get(e.parent_page)
                  if e.parent_page is not None else None)
            if (pe is not None and not self._children.get(pe.page)
                    and not self._ref.get(pe.page, 0)):
                heapq.heappush(heap, (pe.last_used, pe.page))
        if freed:
            self.evicted_pages += len(freed)
            _logger.warning(
                "prefix cache evicted %d page(s) under pool pressure "
                "(asked %d; %d entries / %d referenced pages remain; "
                "%d evicted lifetime) — raise page_budget if this is "
                "hot-path traffic",
                len(freed), need_pages, len(self._by_page),
                len(self._ref), self.evicted_pages,
            )
        return freed

    # -- accounting --------------------------------------------------------

    @property
    def cached_pages(self) -> int:
        return len(self._by_page)

    @property
    def shared_pages(self) -> int:
        """Pages currently mapped by MORE than one slot — the physical
        dedup the cache exists for. list() snapshots the dict in one
        C-level call: the serve thread mutates _ref without a lock, and
        a Python-level generator over live .values() could die with
        'dictionary changed size during iteration' under a concurrent
        /metrics poll."""
        return sum(1 for v in list(self._ref.values()) if v >= 2)

    @property
    def referenced_pages(self) -> int:
        return len(self._ref)

    def stats(self) -> dict:
        return {
            "prefix_hit_rate": round(
                self.hit_tokens / max(self.lookup_tokens, 1), 4),
            "prefix_hit_tokens": self.hit_tokens,
            "prefix_lookup_tokens": self.lookup_tokens,
            "prefix_hits": self.hits,
            "prefix_lookups": self.lookups,
            "prefix_cached_pages": self.cached_pages,
            "prefix_shared_pages": self.shared_pages,
            "prefix_cow_copies": self.cow_copies,
            "prefix_evicted_pages": self.evicted_pages,
        }
