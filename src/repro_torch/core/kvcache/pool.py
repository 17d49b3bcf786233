"""Distributed KV cache pool (paper §3.2.5, Figure 5).

Cluster-scope, content-addressed store of KV blocks, shared by every
engine.  Reproduces the paper's four stated mechanisms:

  1. **Scan-resistant eviction** — pluggable policy, S3-FIFO by default
     (one-shot prompt scans don't flush hot multi-turn prefixes).
  2. **Reduced redundant transfers** — blocks are fetched at most once
     per miss; publishes of a hash the pool already holds are dropped
     at the metadata layer before any payload moves.
  3. **Asynchronous metadata updates** — publishes enqueue a metadata
     record and return immediately; a background flush (``tick``) makes
     them visible, so the engine's token path never waits on the pool
     index (visibility_lag models the paper's async update window).
  4. **Shared-memory colocation** — fetches by an engine colocated with
     the block's home node are zero-copy (cost model: dram_bw vs
     network_bw), mirroring the cache-engine colocation fast path.

Payloads are optional: real engines store (k_page, v_page) arrays; the
cluster simulator stores None and uses the cost model only.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.kvcache.eviction import make_policy


@dataclass
class KVBlock:
    block_hash: str
    payload: Any                       # (k_page, v_page) or None (sim)
    size_bytes: int
    home_node: str                     # node that produced it
    created_at: float = 0.0
    hits: int = 0


class KVPoolError(RuntimeError):
    """Pool unreachable — network partition or cache-node loss.  Raised
    by ``fetch``/``publish`` while a partition window is active; callers
    (the scheduler's pool walk) must degrade to recompute, never crash."""


@dataclass
class PoolStats:
    puts: int = 0
    dup_puts_dropped: int = 0
    hits_local: int = 0                # shared-memory (colocated) hits
    hits_remote: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_stored: int = 0
    bytes_transferred: int = 0
    pending_metadata: int = 0
    fetch_failures: int = 0            # fetches rejected by a partition
    publish_failures: int = 0          # publishes rejected by a partition


class DistributedKVPool:
    """One logical pool; engines attach with a node id for colocation."""

    def __init__(self, capacity_bytes: int = 8 << 30,
                 block_bytes: int = 1 << 20,
                 policy: str = "s3fifo",
                 metadata_lag: float = 0.002,
                 network_bw: float = 12.5e9,      # 100 Gb/s fabric
                 dram_bw: float = 50e9,
                 clock: Callable[[], float] = None):
        self.capacity_bytes = capacity_bytes
        self.block_bytes = block_bytes
        self.policy = make_policy(policy, max(capacity_bytes // block_bytes,
                                              2))
        self.metadata_lag = metadata_lag
        self.network_bw = network_bw
        self.dram_bw = dram_bw
        self.clock = clock or (lambda: 0.0)
        self.blocks: Dict[str, KVBlock] = {}
        self.stats = PoolStats()
        # async metadata queue: (visible_at, hash, block), plus an O(1)
        # membership set (contains()/publish dedup sit on the engines'
        # per-block prefill-completion hot path)
        self._pending: "collections.deque[Tuple[float, str, KVBlock]]" = \
            collections.deque()
        self._pending_hashes: set = set()
        # engine node map (engine_id -> node id) for colocation checks
        self._engine_node: Dict[str, str] = {}
        # chaos: while now < _partition_until, fetch/publish raise
        self._partition_until: float = float("-inf")

    # ---------------------------------------------------------- partition
    def partition(self, now: Optional[float] = None,
                  duration: float = 1.0) -> None:
        """Sever the pool for ``duration`` seconds (chaos injection)."""
        now = self.clock() if now is None else now
        self._partition_until = max(self._partition_until, now + duration)

    def heal(self) -> None:
        self._partition_until = float("-inf")

    def partitioned(self, now: Optional[float] = None) -> bool:
        now = self.clock() if now is None else now
        return now < self._partition_until

    # ------------------------------------------------------------ attach
    def attach_engine(self, engine_id: str, node: str) -> None:
        self._engine_node[engine_id] = node

    # ------------------------------------------------------------ publish
    def publish(self, block_hash: str, payload: Any, engine_id: str,
                now: Optional[float] = None, size_bytes: int = 0) -> bool:
        """Async publish; returns False when dropped as duplicate."""
        now = self.clock() if now is None else now
        if self.partitioned(now):
            self.stats.publish_failures += 1
            raise KVPoolError("kv pool partitioned: publish rejected")
        if self.contains(block_hash):
            self.stats.dup_puts_dropped += 1
            return False
        blk = KVBlock(block_hash, payload,
                      size_bytes or self.block_bytes,
                      home_node=self._engine_node.get(engine_id, engine_id),
                      created_at=now)
        self._pending.append((now + self.metadata_lag, block_hash, blk))
        self._pending_hashes.add(block_hash)
        self.stats.puts += 1
        self.stats.pending_metadata = len(self._pending)
        return True

    def tick(self, now: Optional[float] = None) -> int:
        """Flush metadata records that became visible.  Returns #flushed."""
        now = self.clock() if now is None else now
        n = 0
        while self._pending and self._pending[0][0] <= now:
            _, h, blk = self._pending.popleft()
            self._pending_hashes.discard(h)
            if h in self.blocks:
                self.stats.dup_puts_dropped += 1
                continue
            self._insert(blk)
            n += 1
        self.stats.pending_metadata = len(self._pending)
        return n

    def flush_hashes(self, hashes, now: Optional[float] = None) -> int:
        """Synchronously make SPECIFIC pending records visible — a
        handoff barrier for disaggregated prefill engines, which must
        not hand a request off before its published blocks are
        fetchable.  Other engines' pending records keep their
        configured metadata lag.  Returns #flushed."""
        wanted = set(hashes) & self._pending_hashes
        if not wanted:
            return 0
        n = 0
        keep: "collections.deque" = collections.deque()
        while self._pending:
            vis, h, blk = self._pending.popleft()
            if h not in wanted:
                keep.append((vis, h, blk))
                continue
            self._pending_hashes.discard(h)
            if h in self.blocks:
                self.stats.dup_puts_dropped += 1
            else:
                self._insert(blk)
                n += 1
        self._pending = keep
        self.stats.pending_metadata = len(self._pending)
        return n

    def _insert(self, blk: KVBlock) -> None:
        while (self.stats.bytes_stored + blk.size_bytes
               > self.capacity_bytes):
            victim = self.policy.evict()
            if victim is None:
                return                      # cannot fit
            vb = self.blocks.pop(victim, None)
            if vb is not None:
                self.stats.bytes_stored -= vb.size_bytes
                self.stats.evictions += 1
        self.blocks[blk.block_hash] = blk
        self.policy.on_insert(blk.block_hash)
        self.stats.bytes_stored += blk.size_bytes

    # ------------------------------------------------------------ fetch
    def contains(self, block_hash: str) -> bool:
        """Known to the pool: visible OR queued in the async metadata
        path (fetchable after the lag; a publish would be dropped as a
        duplicate) — so engines can skip materializing payloads for
        blocks published moments ago."""
        return block_hash in self.blocks or block_hash in self._pending_hashes

    def fetch(self, block_hash: str, engine_id: str,
              now: Optional[float] = None) -> Optional[Any]:
        """Payload or None.  Updates hotness + transfer accounting."""
        if self.partitioned(now):
            self.stats.fetch_failures += 1
            raise KVPoolError("kv pool partitioned: fetch rejected")
        self.tick(now)
        blk = self.blocks.get(block_hash)
        if blk is None:
            self.stats.misses += 1
            return None
        blk.hits += 1
        self.policy.on_access(block_hash)
        node = self._engine_node.get(engine_id, engine_id)
        if node == blk.home_node:
            self.stats.hits_local += 1
        else:
            self.stats.hits_remote += 1
            self.stats.bytes_transferred += blk.size_bytes
        return blk.payload if blk.payload is not None else True

    def size_of(self, block_hash: str) -> int:
        """Stored wire size of a visible block (0 when unknown) — what
        a fetch of it actually moves (int8-compressed payloads are
        smaller than the raw page)."""
        blk = self.blocks.get(block_hash)
        return blk.size_bytes if blk is not None else 0

    def fetch_cost_s(self, block_hash: str, engine_id: str) -> float:
        """Transfer-time model for the simulator (s)."""
        blk = self.blocks.get(block_hash)
        if blk is None:
            return 0.0
        node = self._engine_node.get(engine_id, engine_id)
        bw = self.dram_bw if node == blk.home_node else self.network_bw
        return blk.size_bytes / bw

    # ------------------------------------------------------------ misc
    def match_prefix(self, hashes: List[str]) -> int:
        """Longest visible prefix run (router/scheduler scoring)."""
        n = 0
        for h in hashes:
            if h not in self.blocks:
                break
            n += 1
        return n

    @property
    def utilization(self) -> float:
        return self.stats.bytes_stored / max(self.capacity_bytes, 1)
