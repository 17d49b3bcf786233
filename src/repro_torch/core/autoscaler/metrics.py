"""Sliding-window metric aggregation (paper §3.2.4).

The paper's optimization: AIBrix "bypasses the custom metrics path and
maintains sliding window metric aggregation directly in the autoscaler"
— i.e. instead of a scrape->adapter->metrics-server pipeline adding tens
of seconds of propagation delay, the autoscaler ingests raw samples and
aggregates over stable/panic windows locally.  We model both paths so
benchmarks can show the reaction-latency difference.
"""
from __future__ import annotations

import collections
from typing import Deque, Dict, Optional, Tuple


class SlidingWindow:
    """Time-bucketed sliding window with O(1) mean over the window."""

    def __init__(self, window_s: float, granularity_s: float = 1.0):
        self.window_s = window_s
        self.granularity = granularity_s
        self._buckets: Deque[Tuple[float, float, int]] = collections.deque()
        # (bucket_start, value_sum, count)

    def record(self, t: float, value: float) -> None:
        start = (t // self.granularity) * self.granularity
        if self._buckets and self._buckets[-1][0] == start:
            s, v, c = self._buckets[-1]
            self._buckets[-1] = (s, v + value, c + 1)
        else:
            self._buckets.append((start, value, 1))
        self._trim(t)

    def _trim(self, now: float) -> None:
        while self._buckets and self._buckets[0][0] < now - self.window_s:
            self._buckets.popleft()

    def mean(self, now: float) -> Optional[float]:
        self._trim(now)
        rows = [(v, c) for s, v, c in self._buckets if s <= now]
        total = sum(v for v, _ in rows)
        count = sum(c for _, c in rows)
        return total / count if count else None

    def max(self, now: float) -> Optional[float]:
        self._trim(now)
        vals = [v / c for s, v, c in self._buckets if c and s <= now]
        return max(vals) if vals else None


class MetricStore:
    """Per-(engine, metric) windows, with an optional propagation delay
    emulating the legacy custom-metrics path (delay=0 == AIBrix path)."""

    def __init__(self, stable_window_s: float = 60.0,
                 panic_window_s: float = 6.0,
                 propagation_delay_s: float = 0.0):
        self.stable_window_s = stable_window_s
        self.panic_window_s = panic_window_s
        self.delay = propagation_delay_s
        self._stable: Dict[str, SlidingWindow] = {}
        self._panic: Dict[str, SlidingWindow] = {}
        self._inflight: Deque[Tuple[float, str, float]] = collections.deque()

    def record(self, t: float, key: str, value: float) -> None:
        if self.delay > 0:
            self._inflight.append((t + self.delay, key, value))
        else:
            self._ingest(t, key, value)

    def _ingest(self, t: float, key: str, value: float) -> None:
        if key not in self._stable:
            self._stable[key] = SlidingWindow(self.stable_window_s)
            self._panic[key] = SlidingWindow(self.panic_window_s)
        self._stable[key].record(t, value)
        self._panic[key].record(t, value)

    def flush(self, now: float) -> None:
        while self._inflight and self._inflight[0][0] <= now:
            t, key, v = self._inflight.popleft()
            self._ingest(t, key, v)

    def stable(self, now: float, key: str) -> Optional[float]:
        self.flush(now)
        w = self._stable.get(key)
        return w.mean(now) if w else None

    def panic(self, now: float, key: str) -> Optional[float]:
        self.flush(now)
        w = self._panic.get(key)
        return w.mean(now) if w else None
