"""Page allocator + hash-based prefix cache (vLLM-style) for one engine.

Pages are the unit of both memory management and *reuse*: a full page of
``page_size`` tokens is content-addressed by the rolling hash of every
token up to and including that page.  The AIBrix distributed KV pool
(repro.core.kvcache) speaks the same block-hash language, which is what
makes cross-engine reuse possible: an engine that misses locally can ask
the pool for the page payload by hash.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


def chunk_hashes(tokens: Sequence[int], page_size: int,
                 salt: str = "") -> List[str]:
    """Rolling content hash per *full* page of the token prefix.

    ``salt`` namespaces the hash chain — LoRA requests pass their
    adapter name so KV computed under one adapter (the v-projection
    changes cached values) can never be prefix-matched, pool-shared,
    or swap-restored into a request running a different adapter.  Base
    requests use the empty salt, keeping their hashes stable."""
    out = []
    h = hashlib.sha256()
    if salt:
        h.update(bytes(salt, "utf-8"))
    n_full = len(tokens) // page_size
    for i in range(n_full):
        chunk = tokens[i * page_size:(i + 1) * page_size]
        h.update(bytes(str(list(chunk)), "utf-8"))
        out.append(h.hexdigest()[:24])
    return out


@dataclass
class PageInfo:
    page_id: int
    block_hash: Optional[str] = None
    ref_count: int = 0
    last_used: float = 0.0


class PageAllocator:
    """Fixed pool of physical pages with refcounted prefix caching."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self.free: List[int] = list(range(num_pages))
        self.pages: Dict[int, PageInfo] = {
            i: PageInfo(i) for i in range(num_pages)}
        # block hash -> page id, for pages whose contents are a full,
        # content-addressed token block (prefix-cache index)
        self.hash_index: Dict[str, int] = {}
        # evictable cached pages (ref_count == 0, hash set), maintained
        # in LRU order by insertion: release() re-inserts at the end
        # (move-to-end), so eviction pops the front in O(1) instead of
        # a min()-scan over timestamps
        self._cached_lru: Dict[int, float] = {}
        self.stats = {"allocated": 0, "cache_hits": 0, "cache_misses": 0,
                      "evictions": 0}
        # eviction cascade hook: called as (page_id, block_hash, now)
        # BEFORE a hash-indexed cached page is recycled, while its
        # contents are still intact — the tiered-KV engine offloads the
        # victim into the host-DRAM tier here instead of dropping it
        self.on_evict: Optional[Callable[[int, str, float], None]] = None

    # ---------------------------------------------------------------- util
    @property
    def num_free(self) -> int:
        return len(self.free) + len(self._cached_lru)

    @property
    def utilization(self) -> float:
        in_use = self.num_pages - len(self.free) - len(self._cached_lru)
        return in_use / max(self.num_pages, 1)

    # ---------------------------------------------------------------- alloc
    def _pop_free(self, now: float) -> Optional[int]:
        if self.free:
            return self.free.pop()
        if self._cached_lru:            # evict LRU cached page: O(1)
            pid = next(iter(self._cached_lru))
            del self._cached_lru[pid]
            info = self.pages[pid]
            if info.block_hash:
                if self.on_evict is not None:
                    self.on_evict(pid, info.block_hash, now)
                self.hash_index.pop(info.block_hash, None)
            info.block_hash = None
            self.stats["evictions"] += 1
            return pid
        return None

    def allocate(self, n: int, now: float = 0.0) -> Optional[List[int]]:
        """Allocate n fresh pages (or None if impossible)."""
        if self.num_free < n:
            return None
        out = []
        for _ in range(n):
            pid = self._pop_free(now)
            assert pid is not None
            info = self.pages[pid]
            info.ref_count = 1
            info.last_used = now
            out.append(pid)
        self.stats["allocated"] += n
        return out

    def retain(self, page_ids: Sequence[int]) -> None:
        for pid in page_ids:
            info = self.pages[pid]
            if info.ref_count == 0:
                self._cached_lru.pop(pid, None)
            info.ref_count += 1

    def release(self, page_ids: Sequence[int], now: float = 0.0) -> None:
        """Drop a reference; hash-indexed pages become evictable cache,
        anonymous pages return to the free list."""
        for pid in page_ids:
            info = self.pages[pid]
            info.ref_count -= 1
            assert info.ref_count >= 0, f"double free of page {pid}"
            if info.ref_count == 0:
                if info.block_hash:
                    info.last_used = now
                    # move-to-end keeps dict order == LRU order
                    self._cached_lru.pop(pid, None)
                    self._cached_lru[pid] = now
                else:
                    self.free.append(pid)

    # ---------------------------------------------------------------- prefix
    def register_hash(self, page_id: int, block_hash: str) -> None:
        info = self.pages[page_id]
        info.block_hash = block_hash
        self.hash_index[block_hash] = page_id

    def match_prefix(self, tokens: Sequence[int], now: float = 0.0,
                     salt: str = "") -> Tuple[List[int], int]:
        """Longest cached prefix -> (page_ids retained, tokens covered).

        Never matches the *entire* prompt (the last partial/full block is
        always recomputed so prefill produces at least one new token).
        """
        hashes = chunk_hashes(tokens, self.page_size, salt)
        matched: List[int] = []
        for i, h in enumerate(hashes):
            covered = (i + 1) * self.page_size
            if covered >= len(tokens):
                break
            pid = self.hash_index.get(h)
            if pid is None:
                break
            matched.append(pid)
        if matched:
            self.retain(matched)
            self.stats["cache_hits"] += len(matched)
        self.stats["cache_misses"] += max(
            len(hashes) - len(matched), 0)
        return matched, len(matched) * self.page_size

    def match_len(self, tokens: Sequence[int], salt: str = "") -> int:
        """Non-mutating variant for router scoring (no retain)."""
        hashes = chunk_hashes(tokens, self.page_size, salt)
        n = 0
        for i, h in enumerate(hashes):
            if (i + 1) * self.page_size >= len(tokens):
                break
            if h not in self.hash_index:
                break
            n += 1
        return n * self.page_size
