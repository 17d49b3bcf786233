"""Eviction policies for the distributed KV cache pool.

The paper calls for a *scan-resistant* policy that "selectively persists
hot KV tensors".  One-shot prompt scans (a big Bird-SQL schema seen
once) must not flush the genuinely-hot multi-turn prefixes.  We provide:

  * LRU            — baseline (what a naive pool would do)
  * S3FIFO         — scan-resistant: small probationary FIFO absorbs
                     one-hit-wonder blocks; only re-referenced blocks
                     graduate to the main FIFO (Yang et al., SOSP'23 —
                     the family AIBrix's eviction is drawn from)
  * LRU-K (K=2)    — classic scan-resistant alternative for ablations

All policies share one interface: on_insert / on_access / evict -> key.
"""
from __future__ import annotations

import collections
from typing import Dict, Hashable, Optional


class EvictionPolicy:
    name = "base"

    def on_insert(self, key: Hashable, size: int = 1) -> None:
        raise NotImplementedError

    def on_access(self, key: Hashable) -> None:
        raise NotImplementedError

    def on_remove(self, key: Hashable) -> None:
        raise NotImplementedError

    def evict(self) -> Optional[Hashable]:
        """Choose and forget a victim key (None if empty)."""
        raise NotImplementedError

    def __contains__(self, key) -> bool:
        raise NotImplementedError


class LRU(EvictionPolicy):
    name = "lru"

    def __init__(self):
        self._od: "collections.OrderedDict[Hashable, None]" = \
            collections.OrderedDict()

    def on_insert(self, key, size: int = 1):
        self._od[key] = None
        self._od.move_to_end(key)

    def on_access(self, key):
        if key in self._od:
            self._od.move_to_end(key)

    def on_remove(self, key):
        self._od.pop(key, None)

    def evict(self):
        if not self._od:
            return None
        key, _ = self._od.popitem(last=False)
        return key

    def __contains__(self, key):
        return key in self._od


class S3FIFO(EvictionPolicy):
    """Small (probationary) FIFO + main FIFO + ghost queue.

    * new keys -> small FIFO (default 10% of capacity budget)
    * eviction from small: freq>0 -> promote to main, else -> ghost
    * re-insert of a ghost key -> straight to main (it proved hotness)
    * eviction from main: freq>0 -> reinsert with freq-1 (lazy CLOCK),
      else evict for real.
    """
    name = "s3fifo"

    def __init__(self, capacity: int = 1024, small_ratio: float = 0.1,
                 ghost_ratio: float = 0.9):
        self.capacity = max(capacity, 2)
        self.small_cap = max(1, int(self.capacity * small_ratio))
        self.ghost_cap = max(1, int(self.capacity * ghost_ratio))
        self.small: "collections.deque[Hashable]" = collections.deque()
        self.main: "collections.deque[Hashable]" = collections.deque()
        self.ghost: "collections.OrderedDict[Hashable, None]" = \
            collections.OrderedDict()
        self.freq: Dict[Hashable, int] = {}
        self.where: Dict[Hashable, str] = {}

    def on_insert(self, key, size: int = 1):
        if key in self.where:
            self.on_access(key)
            return
        if key in self.ghost:                    # proven hot: main
            del self.ghost[key]
            self.main.append(key)
            self.where[key] = "main"
        else:
            self.small.append(key)
            self.where[key] = "small"
        self.freq[key] = 0

    def on_access(self, key):
        if key in self.freq:
            self.freq[key] = min(self.freq[key] + 1, 3)

    def on_remove(self, key):
        loc = self.where.pop(key, None)
        if loc == "small":
            try:
                self.small.remove(key)
            except ValueError:
                pass
        elif loc == "main":
            try:
                self.main.remove(key)
            except ValueError:
                pass
        self.freq.pop(key, None)

    def _ghost_insert(self, key):
        self.ghost[key] = None
        while len(self.ghost) > self.ghost_cap:
            self.ghost.popitem(last=False)

    def evict(self):
        # prefer draining an over-full small queue (scan absorption).
        # bound: each key gets at most freq-cap+1 = 4 second chances
        for _ in range(4 * (len(self.small) + len(self.main)) + 4):
            if self.small and (len(self.small) >= self.small_cap
                               or not self.main):
                key = self.small.popleft()
                if self.freq.get(key, 0) > 0:    # survived: promote
                    self.main.append(key)
                    self.where[key] = "main"
                    self.freq[key] = 0
                    continue
                self.where.pop(key, None)
                self.freq.pop(key, None)
                self._ghost_insert(key)
                return key
            if self.main:
                key = self.main.popleft()
                if self.freq.get(key, 0) > 0:    # lazy CLOCK second chance
                    self.freq[key] -= 1
                    self.main.append(key)
                    continue
                self.where.pop(key, None)
                self.freq.pop(key, None)
                return key
            if self.small:                        # main empty: drain small
                key = self.small.popleft()
                self.where.pop(key, None)
                self.freq.pop(key, None)
                self._ghost_insert(key)
                return key
        return None

    def __contains__(self, key):
        return key in self.where


class LRUK(EvictionPolicy):
    """LRU-K (K=2): evict the key with the oldest K-th-last access."""
    name = "lru2"

    def __init__(self, k: int = 2):
        self.k = k
        self.hist: Dict[Hashable, collections.deque] = {}
        self._tick = 0

    def _now(self) -> int:
        self._tick += 1
        return self._tick

    def on_insert(self, key, size: int = 1):
        self.hist[key] = collections.deque([self._now()], maxlen=self.k)

    def on_access(self, key):
        if key in self.hist:
            self.hist[key].append(self._now())

    def on_remove(self, key):
        self.hist.pop(key, None)

    def evict(self):
        if not self.hist:
            return None
        # backward-K distance: keys with < K accesses are "infinitely" old
        def kth(key):
            h = self.hist[key]
            return h[0] if len(h) >= self.k else -1_000_000_000 + h[-1]
        victim = min(self.hist, key=kth)
        del self.hist[victim]
        return victim

    def __contains__(self, key):
        return key in self.hist


POLICIES = {"lru": LRU, "s3fifo": S3FIFO, "lru2": LRUK}


def make_policy(name: str, capacity: int) -> EvictionPolicy:
    if name == "s3fifo":
        return S3FIFO(capacity)
    if name == "lru2":
        return LRUK()
    return LRU()
