"""Host-side paged KV-cache bookkeeping: block allocator, refcounted
pages, and RAG prefix sharing (pure stdlib — no torch import).

An own copy of the reference's ``serving/paged.py``, line for line, so
the two allocators make the same plans for the same admissions.

The device side (:mod:`repro_torch.serving.executor` in paged mode)
holds one global pool of ``num_pages`` fixed-size K/V pages per layer
plus a
per-slot block table.  Everything about *which* page holds *what* is
decided here, on the host, by :class:`PagePool`:

* **Free-list allocator with refcounts.**  Pages are partitioned when
  the pool is sharded (a slot on data-shard ``d`` may only use pages
  resident on ``d``); each partition keeps its own free list.  A page's
  refcount counts the slots using it plus (for registered prefix pages)
  one cache reference.
* **Prefix sharing.**  RAG traffic re-prefills the same guarded
  template and the same retrieved passages over and over.  Admission
  hashes the prompt's token pages with a *cumulative chain hash*
  (K/V at position ``i`` depend on every token ``<= i``, so a page is
  only reusable when its entire prefix matches).  Cache-hot full pages
  are mapped into the new slot's block table instead of re-prefilled —
  only the unique suffix goes through the prefill program.
* **Copy-on-write fork.**  The suffix usually starts mid-page.  That
  page's shared K/V (refcount > 1 — the cache and/or other slots hold
  it) must not be written, so the plan gathers the source page into the
  prefill scratch and commits the combined prefix+suffix content to a
  *fresh* page: copy-before-write, the writer gets its own fork.
* **Back-pressure.**  When a partition cannot supply the pages a
  request needs — even after evicting unreferenced cache entries
  (LRU) — :meth:`PagePool.plan` returns ``None`` and the engine defers
  the admission instead of OOMing.

Page-table row layout for a planned request (page size ``ps``)::

    blocks [0, shared)                -> borrowed cache pages (read-only)
    block  shared (iff p0 % ps != 0)  -> CoW fork: gathered + rewritten
    blocks [shared+cow, total)        -> fresh pages (prefill + decode)

where ``p0`` is the suffix start in tokens, capped at ``plen - 1`` so
prefill always sees at least one token (it must emit the first output
token from real logits).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


def hash_prefix_pages(tokens: Sequence[int], page_size: int) -> List[bytes]:
    """Cumulative chain hash per FULL token page.

    ``out[i]`` identifies tokens ``[0, (i+1)*page_size)`` — not just
    page ``i``'s tokens — because a page's K/V depend on the whole
    prefix.  Deterministic across processes (blake2b over the raw
    int token bytes; no Python ``hash()`` randomization).
    """
    out: List[bytes] = []
    h = b"\x00" * 16
    for i in range(len(tokens) // page_size):
        chunk = tokens[i * page_size:(i + 1) * page_size]
        payload = h + b"".join(int(t).to_bytes(8, "little", signed=True)
                               for t in chunk)
        h = hashlib.blake2b(payload, digest_size=16).digest()
        out.append(h)
    return out


@dataclass
class PagePlan:
    """One admitted request's page assignment (engine keeps it until the
    slot is released; every page in ``pages`` holds one reference)."""
    pages: List[int]            # full table row: blocks [0, total)
    p0: int                     # suffix start (tokens); prefill covers
    #                             [p0, plen) at absolute positions
    shared: int                 # leading blocks borrowed from the cache
    cow: bool                   # block `shared` is a copy-on-write fork
    gather_src: List[int]       # source page per block < ceil(p0/ps)
    write_mask: List[bool]      # per block: commit from prefill scratch
    register: List[Tuple[bytes, int]] = field(default_factory=list)
    partition: int = 0


class PagePool:
    """Allocator + prefix cache over a partitioned page pool."""

    def __init__(self, num_pages: int, page_size: int, *,
                 partitions: int = 1, prefix_sharing: bool = True):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        if num_pages % max(partitions, 1) != 0:
            raise ValueError(
                f"num_pages={num_pages} must be divisible by "
                f"partitions={partitions} (pages shard with the slots)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.partitions = max(1, partitions)
        self.per_partition = num_pages // self.partitions
        self.prefix_sharing = prefix_sharing
        self._ref = [0] * num_pages
        self._free: List[List[int]] = [
            list(range((p + 1) * self.per_partition - 1,
                       p * self.per_partition - 1, -1))
            for p in range(self.partitions)]
        # per-partition prefix cache: chain hash -> page id, LRU-ordered
        # (move_to_end on hit).  Every entry holds one cache reference;
        # eviction only touches entries no slot is using (refcount 1).
        self._prefix: List[OrderedDict] = [OrderedDict()
                                           for _ in range(self.partitions)]
        self._hash_of_page: Dict[int, bytes] = {}
        # counters (engine folds these into EngineStats)
        self.n_evicted = 0
        self.n_cow_forks = 0

    def bind_metrics(self, registry) -> None:
        """Register pool occupancy / prefix-cache / eviction gauges as
        scrape-time views over a :class:`repro_torch.obs.MetricsRegistry`."""
        in_use_g = registry.gauge("pagepool_pages_in_use",
                                  "pool pages with a live reference")
        free_g = registry.gauge("pagepool_pages_free",
                                "free pages across all partitions")
        cached_g = registry.gauge("pagepool_prefix_cached_pages",
                                  "pages held by the prefix cache")
        evicted_c = registry.counter("pagepool_evictions_total",
                                     "prefix-cache LRU evictions")
        cow_c = registry.counter("pagepool_cow_forks_total",
                                 "mid-page copy-on-write forks")

        def scrape() -> None:
            in_use_g.set(self.pages_in_use)
            free_g.set(sum(len(f) for f in self._free))
            cached_g.set(sum(len(c) for c in self._prefix))
            evicted_c.set_total(self.n_evicted)
            cow_c.set_total(self.n_cow_forks)

        registry.register_collector(scrape)

    # -- allocator core -------------------------------------------------

    def n_free(self, partition: int = 0) -> int:
        return len(self._free[partition])

    @property
    def pages_in_use(self) -> int:
        return sum(1 for r in self._ref if r > 0)

    def _alloc(self, partition: int) -> int:
        page = self._free[partition].pop()
        assert self._ref[page] == 0, "allocated a referenced page"
        self._ref[page] = 1
        return page

    def _ref_page(self, page: int) -> None:
        assert self._ref[page] > 0, "ref on a free page"
        self._ref[page] += 1

    def _deref(self, page: int) -> None:
        assert self._ref[page] > 0, "deref on a free page"
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free[page // self.per_partition].append(page)

    def _evict_one(self, partition: int) -> bool:
        """Drop the least-recently-used cache entry whose page no slot
        references (refcount == 1: the cache's own ref)."""
        cache = self._prefix[partition]
        for h, page in cache.items():
            if self._ref[page] == 1:
                del cache[h]
                self._hash_of_page.pop(page, None)
                self._deref(page)
                self.n_evicted += 1
                return True
        return False

    # -- prefix lookup --------------------------------------------------

    def _hits(self, hashes: List[bytes], partition: int) -> List[int]:
        """Longest run of consecutive cached prefix pages."""
        if not self.prefix_sharing:
            return []
        cache = self._prefix[partition]
        pages: List[int] = []
        for h in hashes:
            page = cache.get(h)
            if page is None:
                break
            pages.append(page)
        return pages

    def preview_hit_tokens(self, tokens: Sequence[int],
                           partition: int = 0) -> int:
        """Side-effect-free p0 preview — the engine groups admissions by
        (padded length, p0) so one prefill dispatch shares a uniform
        suffix start."""
        hashes = hash_prefix_pages(tokens, self.page_size)
        n = len(self._hits(hashes, partition))
        return min(n * self.page_size, max(len(tokens) - 1, 0))

    # -- admission planning ---------------------------------------------

    def plan(self, tokens: Sequence[int], limit: int,
             partition: int = 0) -> Optional[PagePlan]:
        """Plan pages for a request with ``plen`` prompt tokens and up
        to ``limit`` generated tokens.  Returns ``None`` when the
        partition cannot supply enough pages (caller defers admission).

        The plan covers ``plen + limit + 1`` positions: an idle slot's
        masked decode write may land one past its final position, and
        the executor drops it only when the block index is in range.
        """
        ps = self.page_size
        plen = len(tokens)
        if plen <= 0:
            raise ValueError("empty prompt cannot be planned")
        total_blocks = -(-(plen + limit + 1) // ps)
        hashes = hash_prefix_pages(tokens, ps)
        hit_pages = self._hits(hashes, partition)
        p0 = min(len(hit_pages) * ps, plen - 1)
        shared = p0 // ps
        cow = (p0 % ps) != 0
        n_fresh = total_blocks - shared
        while self.n_free(partition) < n_fresh:
            if not self._evict_one(partition):
                return None
        fresh = [self._alloc(partition) for _ in range(n_fresh)]
        for page in hit_pages[:shared]:
            self._ref_page(page)
        pages = hit_pages[:shared] + fresh
        # prefill scratch needs the WHOLE prefix [0, p0) resident: the
        # suffix attends over it.  Shared full pages gather as-is; the
        # CoW block gathers from its source and recommits to its fork.
        gather_src = hit_pages[:shared + (1 if cow else 0)]
        n_prompt_blocks = -(-plen // ps)
        write_mask = [shared <= i < n_prompt_blocks
                      for i in range(total_blocks)]
        register = [(hashes[i], pages[i]) for i in range(len(hashes))
                    if i >= shared and hashes[i] not in
                    self._prefix[partition]]
        if cow:
            self.n_cow_forks += 1
        return PagePlan(pages=pages, p0=p0, shared=shared, cow=cow,
                        gather_src=gather_src, write_mask=write_mask,
                        register=register, partition=partition)

    def commit(self, plan: PagePlan) -> None:
        """The plan's prefill+commit was dispatched: its fresh FULL
        prompt pages are now (in program order) valid K/V, so register
        them for future sharing.  First writer wins on hash collision
        within a race-free host loop — identical prompts in the SAME
        admission group intentionally do not share (their gathers would
        be dispatched before the commit that fills the pages)."""
        cache = self._prefix[plan.partition]
        for h, page in plan.register:
            if h in cache:
                continue
            cache[h] = page
            self._hash_of_page[page] = h
            self._ref_page(page)
        for page in plan.pages[:plan.shared]:
            h = self._hash_of_page.get(page)
            if h is not None and h in cache:
                cache.move_to_end(h)

    def release(self, plan: PagePlan) -> None:
        """Drop the plan's references (slot freed, admission rolled
        back, or request aborted).  Registered pages keep their cache
        reference and stay sharable until evicted."""
        for page in plan.pages:
            self._deref(page)

    # -- introspection ---------------------------------------------------

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def cached_pages(self, partition: int = 0) -> int:
        return len(self._prefix[partition])
