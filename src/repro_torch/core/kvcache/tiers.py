"""KV placement tiers below device HBM (host DRAM) + the wire format.

A copy of ``repro/core/kvcache/tiers.py`` with one deliberate
difference, the carriage of bfloat16 payloads.  numpy has no bfloat16
of its own.  The port's runner hands bf16 pages out as
``ml_dtypes.bfloat16`` arrays where ``ml_dtypes`` imports (it comes
with JAX), the JAX engines' own payloads, so a JAX engine installs a
port page and a port engine a JAX page.  The port does not depend on
``ml_dtypes``: without it (as on a machine with no JAX) bf16 pages go
out as arrays of :data:`BF16`, a one-field structured dtype holding the
raw 2-byte bit patterns under the field name ``"bfloat16"``, which only
the port installs.  Either array keeps 2 bytes an element (so
``payload_nbytes`` and the tiers' byte counters agree with a JAX bf16
engine), pickles to the SSD tier as it is, and says what it holds.
:func:`as_float32` reads both as float32 values, so
:func:`compress_page` quantizes the values, not the bit patterns; on
float32 input it is the same ``np.asarray(x, np.float32)`` as the
reference, so the int8 wire is bit-equal to ``repro``'s.

The device ``PagePool`` (repro_torch.engine.paged_model) and the cluster
``DistributedKVPool`` (repro_torch.core.kvcache.pool) used to be the only two
homes a KV page could have, with nothing in between: a device eviction
dropped the bytes on the floor and a preemption recomputed from token 0.
This module adds the missing middle tier and the compressed wire format
the pool handoff path speaks:

``HostPagePool``
    A bounded host-DRAM page store, content-addressed by the SAME block
    hashes as the device prefix cache and the distributed pool, so the
    admission page walk can check device -> host -> distributed in
    order.  It is fed two ways: the :class:`~repro_torch.engine.page_table.
    PageAllocator` eviction cascade (victims fall into this tier
    instead of vanishing) and swap-based preemption (a preempted
    request's pages — prompt AND generated — park here under per-
    request swap keys until resume).  Eviction is LRU; host evictions
    cascade into the :class:`SSDPagePool` below when one is wired via
    ``on_evict``.

``SSDPagePool``
    The third tier: a bounded SSD page store below host DRAM with
    *asynchronous write-behind* — ``put`` lands in a bounded in-RAM
    dirty buffer and returns immediately; a writer drains it to the
    backing store at SSD bandwidth (modelled ready-times on the
    simulator, a daemon thread writing pickle files on the real
    engine).  Idle-session prefixes and swapped-out requests survive
    host pressure here and resume without recompute.  Entries are
    never quantized (the swap path must stay byte-identical); when the
    dirty buffer is full, new puts are *dropped* (it is a cache — the
    page walk falls through to the distributed pool or recompute).

int8 wire compression (``compress_page`` / ``decompress_page``)
    The distributed-pool handoff path quantizes page payloads to int8
    with per-layer max-abs scales before they cross the wire and
    dequantizes on install.  Round-trip error is bounded by
    ``INT8_WIRE_MAX_REL_ERR`` times the per-layer max-abs value
    (pinned by tests/test_kv_tiers.py).  Host-tier entries are NOT
    compressed — the swap path must be byte-identical.
"""
from __future__ import annotations

import collections
import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np

log = logging.getLogger("repro_torch.kvtiers")

# pinned round-trip bound: |x - dequant(quant(x))| <= this * max|x| per
# scale group (symmetric int8 with round-to-nearest => half an LSB)
INT8_WIRE_MAX_REL_ERR = 0.5 / 127.0

# shared wire-format vocabulary: "int8" compresses; the "fp*" spellings
# all mean raw payloads ("fp" on the real engine — its pool arrays keep
# their native dtype — and "fp16" on the simulator, matching the
# roofline's kv_dtype_bytes).  Anything else is a typo that would
# otherwise silently disable compression.
WIRE_DTYPES = ("fp", "fp16", "fp32", "int8")


def validate_wire_dtype(name: str) -> str:
    if name not in WIRE_DTYPES:
        raise ValueError(f"unknown wire_dtype {name!r}; expected one of "
                         f"{WIRE_DTYPES}")
    return name


# bfloat16 payloads: raw bit patterns in a dtype that names them
BF16 = np.dtype([("bfloat16", "<u2")])


def as_float32(x) -> np.ndarray:
    """A payload array as float32 values: :data:`BF16` and
    ``ml_dtypes.bfloat16`` arrays are widened exactly (a bf16 value is
    the top half of its float32), anything else is cast."""
    x = np.asarray(x)
    if x.dtype == BF16:
        return (x.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return np.asarray(x, np.float32)


# --------------------------------------------------------------- wire format
@dataclass
class CompressedPage:
    """One page's (k, v) arrays quantized to int8 with per-layer scales.

    ``q_k``/``q_v`` keep the payload shape (L, page, Hkv, D); the scales
    are (L, 1, 1, 1) so dequantization is a single broadcast multiply.
    """
    q_k: np.ndarray
    q_v: np.ndarray
    k_scale: np.ndarray
    v_scale: np.ndarray

    @property
    def nbytes(self) -> int:
        return int(self.q_k.nbytes + self.q_v.nbytes
                   + self.k_scale.nbytes + self.v_scale.nbytes)


def _quant(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    x = as_float32(x)
    axes = tuple(range(1, x.ndim))
    scale = np.max(np.abs(x), axis=axes, keepdims=True) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
    return q, scale


def compress_page(k_page, v_page) -> CompressedPage:
    """Quantize one page payload for the pool wire (int8 + scales)."""
    q_k, k_scale = _quant(k_page)
    q_v, v_scale = _quant(v_page)
    return CompressedPage(q_k, q_v, k_scale, v_scale)


def decompress_page(cp: CompressedPage) -> Tuple[np.ndarray, np.ndarray]:
    return (cp.q_k.astype(np.float32) * cp.k_scale,
            cp.q_v.astype(np.float32) * cp.v_scale)


def payload_nbytes(payload: Any, default: int = 0) -> int:
    """Best-effort wire size of a page payload: CompressedPage and
    (k, v) array tuples know their bytes; opaque payloads (the
    simulator's ``True``) fall back to ``default``."""
    if isinstance(payload, CompressedPage):
        return payload.nbytes
    if isinstance(payload, tuple):
        n = sum(int(getattr(p, "nbytes", 0)) for p in payload)
        if n:
            return n
    return int(default)


# ---------------------------------------------------------------- host tier
@dataclass
class HostTierStats:
    puts: int = 0
    dup_puts: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_stored: int = 0
    bytes_offloaded: int = 0     # cumulative bytes written into the tier


class HostPagePool:
    """Bounded host-DRAM page tier between device HBM and the cluster
    pool.  Content-addressed (block hashes for cascade-evicted cache
    pages, ``swap/<rid>/<i>`` keys for swapped-out requests), LRU-
    evicting, payload-agnostic (real engines store raw (k, v) arrays —
    the swap path must be byte-identical, so host entries are never
    quantized; the simulator stores ``True`` and prices transfers with
    ``dram_bw``)."""

    def __init__(self, capacity_bytes: int = 4 << 30,
                 dram_bw: float = 50e9):
        self.capacity_bytes = int(capacity_bytes)
        self.dram_bw = dram_bw
        # key -> (payload, size_bytes); dict order == LRU order
        self._entries: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self.stats = HostTierStats()
        # eviction cascade hook: on_evict(key, payload, size_bytes, now)
        # fires for every capacity eviction (NOT explicit discards) so
        # an SSDPagePool below can absorb the victim
        self.on_evict = None

    def __len__(self) -> int:
        return len(self._entries)

    def can_hold(self, nbytes: int) -> bool:
        """Whether ``nbytes`` could ever fit (evicting everything else
        if needed) — the swap-out feasibility check."""
        return nbytes <= self.capacity_bytes

    def contains(self, key: str) -> bool:
        return key in self._entries

    @property
    def utilization(self) -> float:
        return self.stats.bytes_stored / max(self.capacity_bytes, 1)

    def keys(self):
        return list(self._entries)

    # ------------------------------------------------------------ put/get
    def put(self, key: str, payload: Any, size_bytes: int,
            now: float = 0.0) -> bool:
        """Insert (or refresh) an entry; returns False when it cannot
        fit even after evicting every other entry."""
        size_bytes = int(size_bytes)
        if key in self._entries:
            self._entries.move_to_end(key)
            self.stats.dup_puts += 1
            return True
        if size_bytes > self.capacity_bytes:
            return False
        while (self.stats.bytes_stored + size_bytes
               > self.capacity_bytes) and self._entries:
            vk, (vp, sz) = self._entries.popitem(last=False)
            self.stats.bytes_stored -= sz
            self.stats.evictions += 1
            if self.on_evict is not None:
                self.on_evict(vk, vp, sz, now)
        self._entries[key] = (payload, size_bytes)
        self.stats.bytes_stored += size_bytes
        self.stats.puts += 1
        self.stats.bytes_offloaded += size_bytes
        return True

    def get(self, key: str, now: float = 0.0) -> Optional[Any]:
        ent = self._entries.get(key)
        if ent is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        return ent[0]

    def discard(self, key: str) -> None:
        """Remove an entry without hit/miss accounting — swap-in holds
        the payloads it ``get()``-ed (so a cascade eviction racing the
        page allocation cannot invalidate them) and discards the keys
        only after the installs succeed."""
        ent = self._entries.pop(key, None)
        if ent is not None:
            self.stats.bytes_stored -= ent[1]


# ----------------------------------------------------------------- ssd tier
@dataclass
class SSDTierStats:
    puts: int = 0
    dup_puts: int = 0
    dropped_puts: int = 0        # write-behind buffer full => put dropped
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    bytes_stored: int = 0
    bytes_written: int = 0       # cumulative bytes drained to the SSD


class SSDPagePool:
    """Bounded SSD page tier below host DRAM with asynchronous
    write-behind.

    ``put`` appends to a bounded in-RAM dirty buffer and returns
    immediately; the writer drains it to the backing store at SSD
    bandwidth.  Two backings share the class:

    * **modelled** (``directory=None``, the simulator): each dirty
      entry carries a ready-time computed from a single serial writer
      draining at ``ssd_bw``; ``get``/``put`` lazily promote entries
      whose ready-time has passed into the durable LRU store.
    * **file-backed** (``directory=...``, the real engine): a daemon
      thread pickles payloads to files under ``directory`` — reads are
      byte-identical to what was written (payloads are never
      quantized), which the swap-resume pin in tests/test_sessions.py
      relies on.

    Entries still in the dirty buffer are readable (they live in RAM);
    when the buffer is full new puts are dropped and counted — it is a
    cache, so the page walk just falls through to the next tier.
    Drops are LOUD (like gateway sheds): accumulated and logged at most
    once per ``DROP_LOG_WINDOW_S`` so a saturated write-behind buffer
    shows up in bench output instead of silently degrading reuse.
    """

    DROP_LOG_WINDOW_S = 10.0      # at most one dropped-put log per window

    def __init__(self, capacity_bytes: int = 64 << 30,
                 ssd_bw: float = 3.0e9,
                 write_buffer_bytes: int = 256 << 20,
                 directory: Optional[str] = None):
        self.capacity_bytes = int(capacity_bytes)
        self.ssd_bw = ssd_bw
        self.write_buffer_bytes = int(write_buffer_bytes)
        # durable store: key -> (payload_or_path, size_bytes); LRU order
        self._entries: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        # write-behind buffer: key -> (payload, size_bytes, ready_time)
        self._dirty: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()
        self._dirty_bytes = 0
        self._writer_free_at = 0.0
        self.stats = SSDTierStats()
        # windowed dropped-put logging state (see _note_drop)
        self._drop_window = 0
        self._drop_t0 = 0.0
        self._drop_log_at = float("-inf")
        self._dir = directory
        self._lock = None
        self._queue = None
        if directory is not None:
            import os
            import queue
            import threading
            os.makedirs(directory, exist_ok=True)
            self._lock = threading.Lock()
            self._queue = queue.Queue()
            t = threading.Thread(target=self._file_writer, daemon=True)
            t.start()

    # --------------------------------------------------------- internals
    def _file_writer(self) -> None:
        """Daemon thread: drain the dirty queue to pickle files."""
        import os
        import pickle
        while True:
            key, payload, size_bytes = self._queue.get()
            path = os.path.join(
                self._dir, f"{abs(hash(key)) :x}-{self.stats.puts}.kv")
            with open(path, "wb") as f:
                pickle.dump(payload, f, protocol=4)
            with self._lock:
                if key in self._dirty:           # not discarded meanwhile
                    del self._dirty[key]
                    self._dirty_bytes -= size_bytes
                    self._store(key, path, size_bytes)
                    self.stats.bytes_written += size_bytes
                else:
                    os.remove(path)
            self._queue.task_done()

    def _store(self, key: str, payload: Any, size_bytes: int) -> None:
        """Insert into the durable LRU store, evicting to capacity."""
        while (self.stats.bytes_stored + size_bytes
               > self.capacity_bytes) and self._entries:
            vk, (vp, sz) = self._entries.popitem(last=False)
            self.stats.bytes_stored -= sz
            self.stats.evictions += 1
            self._unlink(vp)
            self._evicted(vk)
        self._entries[key] = (payload, size_bytes)
        self.stats.bytes_stored += size_bytes

    def _evicted(self, key: str) -> None:
        """Hook: a key left the pool (capacity eviction or discard).
        The host-shared subclass drops its writer-origin record here."""

    def _note_drop(self, now: float) -> None:
        """Dropped write-behind puts must be LOUD: accumulate and log
        at most once per DROP_LOG_WINDOW_S with the running total, so a
        full dirty buffer reads as a capacity problem, not light KV
        reuse."""
        if self._drop_window == 0:
            self._drop_t0 = now
        self._drop_window += 1
        if now >= self._drop_log_at:
            log.warning(
                "ssd write-behind dropped %d put(s) over the last %.1fs "
                "(total dropped=%d, dirty=%d/%d bytes) — raise "
                "write_buffer_bytes or SSD bandwidth if reuse matters",
                self._drop_window, max(now - self._drop_t0, 0.0),
                self.stats.dropped_puts, self._dirty_bytes,
                self.write_buffer_bytes)
            self._drop_window = 0
            self._drop_log_at = now + self.DROP_LOG_WINDOW_S

    def _unlink(self, payload: Any) -> None:
        if self._dir is not None and isinstance(payload, str):
            import os
            try:
                os.remove(payload)
            except OSError:
                pass

    def _flush(self, now: float) -> None:
        """Modelled backing: promote dirty entries whose write has
        completed by ``now`` into the durable store."""
        if self._dir is not None:
            return                     # the thread does real draining
        while self._dirty:
            key, (payload, sz, ready) = next(iter(self._dirty.items()))
            if ready > now:
                break
            del self._dirty[key]
            self._dirty_bytes -= sz
            self._store(key, payload, sz)
            self.stats.bytes_written += sz

    # ----------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._entries) + len(self._dirty)

    def can_hold(self, nbytes: int) -> bool:
        return nbytes <= self.capacity_bytes

    def contains(self, key: str) -> bool:
        if self._lock is not None:
            with self._lock:
                return key in self._dirty or key in self._entries
        return key in self._dirty or key in self._entries

    @property
    def utilization(self) -> float:
        return ((self.stats.bytes_stored + self._dirty_bytes)
                / max(self.capacity_bytes, 1))

    def keys(self):
        if self._lock is not None:
            with self._lock:
                return list(self._dirty) + list(self._entries)
        return list(self._dirty) + list(self._entries)

    # ------------------------------------------------------------ put/get
    def put(self, key: str, payload: Any, size_bytes: int,
            now: float = 0.0) -> bool:
        """Write-behind insert: lands in the dirty buffer and returns;
        the writer drains it at SSD bandwidth.  Returns False when the
        entry is too big or the dirty buffer is full (put dropped)."""
        size_bytes = int(size_bytes)
        if self._lock is not None:
            with self._lock:
                return self._put_locked(key, payload, size_bytes, now)
        return self._put_locked(key, payload, size_bytes, now)

    def _put_locked(self, key: str, payload: Any, size_bytes: int,
                    now: float) -> bool:
        self._flush(now)
        if key in self._dirty or key in self._entries:
            self.stats.dup_puts += 1
            if key in self._entries:
                self._entries.move_to_end(key)
            return True
        if size_bytes > self.capacity_bytes:
            return False
        if self._dirty_bytes + size_bytes > self.write_buffer_bytes:
            self.stats.dropped_puts += 1
            self._note_drop(now)
            return False
        if self._dir is None:
            ready = max(now, self._writer_free_at) \
                + size_bytes / self.ssd_bw
            self._writer_free_at = ready
            self._dirty[key] = (payload, size_bytes, ready)
        else:
            self._dirty[key] = (payload, size_bytes, 0.0)
            self._queue.put((key, payload, size_bytes))
        self._dirty_bytes += size_bytes
        self.stats.puts += 1
        return True

    def get(self, key: str, now: float = 0.0) -> Optional[Any]:
        """Fetch a payload: dirty-buffer entries are served from RAM,
        durable entries from the backing store (file-backed entries are
        unpickled — byte-identical to what was written)."""
        if self._lock is not None:
            with self._lock:
                return self._get_locked(key, now)
        return self._get_locked(key, now)

    def _get_locked(self, key: str, now: float) -> Optional[Any]:
        self._flush(now)
        ent = self._dirty.get(key)
        if ent is not None:
            self.stats.hits += 1
            return ent[0]
        ent = self._entries.get(key)
        if ent is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        payload = ent[0]
        if self._dir is not None and isinstance(payload, str):
            import pickle
            with open(payload, "rb") as f:
                return pickle.load(f)
        return payload

    def discard(self, key: str) -> None:
        if self._lock is not None:
            with self._lock:
                self._discard_locked(key)
        else:
            self._discard_locked(key)

    def _discard_locked(self, key: str) -> None:
        ent = self._dirty.pop(key, None)
        if ent is not None:
            self._dirty_bytes -= ent[1]
            self._evicted(key)
            return
        ent = self._entries.pop(key, None)
        if ent is not None:
            self.stats.bytes_stored -= ent[1]
            self._unlink(ent[0])
            self._evicted(key)

    def drain(self, timeout: float = 10.0) -> None:
        """Block until every queued write has landed (file backing) or
        force-complete all modelled writes — tests and engine shutdown
        use this to make write-behind deterministic."""
        if self._queue is not None:
            self._queue.join()
        else:
            self._flush(float("inf"))


# ------------------------------------------------------- host-shared ssd tier
class SharedSSDPool(SSDPagePool):
    """Host-level shared SSD tier: every engine on the host attaches a
    :class:`SharedSSDView` to ONE content-addressed pool, so a prefix
    evicted by engine A is an SSD hit for engine B instead of a
    duplicate file.  Block hashes are engine-independent (token content
    + page size + adapter), which is what makes cross-engine sharing
    sound; swap keys (``swap/<rid>/<i>``) carry the request id and stay
    effectively engine-private.

    One write-behind drain path is shared (the single daemon thread /
    modelled serial writer of the base class); per-engine accounting
    lives on the views.  The pool remembers each key's first writer so
    a hit can be classified same-engine vs cross-engine, and counts the
    puts (and bytes) that deduplicated against another engine's copy —
    the headline dedupe metric."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._origin: Dict[str, str] = {}     # key -> first-writer engine
        self._views: Dict[str, "SharedSSDView"] = {}
        self.dedup_puts = 0       # puts absorbed by another engine's copy
        self.dedup_bytes = 0      # bytes those puts would have written

    def view(self, engine_id: str) -> "SharedSSDView":
        """The engine's handle on the shared pool (one per engine,
        cached — accounting accumulates across reattaches)."""
        v = self._views.get(engine_id)
        if v is None:
            v = self._views[engine_id] = SharedSSDView(self, engine_id)
        return v

    @property
    def dedupe_ratio(self) -> float:
        """Fraction of distinct-content put attempts that were absorbed
        by a copy some OTHER engine already wrote (0.0 when nothing was
        shared)."""
        return self.dedup_puts / max(self.stats.puts + self.dedup_puts, 1)

    def _evicted(self, key: str) -> None:
        self._origin.pop(key, None)

    # per-view entry points: classification must happen under the same
    # lock as the put/get so concurrent engine threads stay consistent
    def put_from(self, view: "SharedSSDView", key: str, payload: Any,
                 size_bytes: int, now: float = 0.0) -> bool:
        size_bytes = int(size_bytes)
        if self._lock is not None:
            with self._lock:
                return self._put_from_locked(view, key, payload,
                                             size_bytes, now)
        return self._put_from_locked(view, key, payload, size_bytes, now)

    def _put_from_locked(self, view, key, payload, size_bytes, now):
        puts0 = self.stats.puts
        dups0 = self.stats.dup_puts
        drops0 = self.stats.dropped_puts
        ok = self._put_locked(key, payload, size_bytes, now)
        if self.stats.puts > puts0:               # fresh write
            self._origin[key] = view.engine_id
            view.stats.puts += 1
        elif self.stats.dup_puts > dups0:         # already resident
            view.stats.dup_puts += 1
            if self._origin.get(key, view.engine_id) != view.engine_id:
                self.dedup_puts += 1
                self.dedup_bytes += size_bytes
        elif self.stats.dropped_puts > drops0:    # dirty buffer full
            view.stats.dropped_puts += 1
        return ok

    def get_from(self, view: "SharedSSDView", key: str,
                 now: float = 0.0) -> Optional[Any]:
        if self._lock is not None:
            with self._lock:
                return self._get_from_locked(view, key, now)
        return self._get_from_locked(view, key, now)

    def _get_from_locked(self, view, key, now):
        payload = self._get_locked(key, now)
        if payload is None:
            view.stats.misses += 1
            view.last_get_cross = False
            return None
        view.stats.hits += 1
        cross = self._origin.get(key, view.engine_id) != view.engine_id
        view.last_get_cross = cross
        if cross:
            view.cross_hits += 1
        return payload


class SharedSSDView:
    """One engine's facade over a :class:`SharedSSDPool` — the same
    interface the scheduler already speaks to a private
    :class:`SSDPagePool` (put/get/contains/discard/keys/drain/stats/
    ssd_bw/capacity_bytes/can_hold), plus cross-engine hit
    classification:

    * ``stats`` counts THIS engine's traffic (its puts may dedupe
      against a sibling's copy; its hits may land on pages a sibling
      wrote).  ``bytes_stored``/``bytes_written`` stay pool-global —
      read them off ``pool.stats``.
    * ``cross_hits`` counts hits on pages another engine wrote, and
      ``last_get_cross`` flags whether the most recent successful get
      was one — the scheduler turns that into ``ssd_cross_hit_tokens``.
    """

    def __init__(self, pool: SharedSSDPool, engine_id: str):
        self.pool = pool
        self.engine_id = engine_id
        self.stats = SSDTierStats()
        self.cross_hits = 0
        self.last_get_cross = False

    # ----------------------------------------------- pool-global queries
    @property
    def ssd_bw(self) -> float:
        return self.pool.ssd_bw

    @property
    def capacity_bytes(self) -> int:
        return self.pool.capacity_bytes

    @property
    def utilization(self) -> float:
        return self.pool.utilization

    def can_hold(self, nbytes: int) -> bool:
        return self.pool.can_hold(nbytes)

    def contains(self, key: str) -> bool:
        return self.pool.contains(key)

    def keys(self):
        return self.pool.keys()

    def __len__(self) -> int:
        return len(self.pool)

    # -------------------------------------------------- per-engine traffic
    def put(self, key: str, payload: Any, size_bytes: int,
            now: float = 0.0) -> bool:
        return self.pool.put_from(self, key, payload, size_bytes, now)

    def get(self, key: str, now: float = 0.0) -> Optional[Any]:
        return self.pool.get_from(self, key, now)

    def discard(self, key: str) -> None:
        self.pool.discard(key)

    def drain(self, timeout: float = 10.0) -> None:
        self.pool.drain(timeout)
