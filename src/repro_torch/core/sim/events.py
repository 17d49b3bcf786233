"""Discrete-event simulation core: virtual clock + event heap."""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Optional, Tuple


class SimClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


class EventLoop:
    # process-wide fired-event counter across every EventLoop instance —
    # benchmarks/run.py prints each suite's sim events/wall-second from
    # the per-suite delta, the scalability headline of the event core
    total_events: int = 0

    def __init__(self, clock: Optional[SimClock] = None):
        self.clock = clock or SimClock()
        self._heap: List[Tuple[float, int, Callable]] = []
        self._seq = itertools.count()
        self.events_fired = 0

    def schedule(self, t: float, fn: Callable) -> None:
        heapq.heappush(self._heap, (max(t, self.clock.now),
                                    next(self._seq), fn))

    def after(self, dt: float, fn: Callable) -> None:
        self.schedule(self.clock.now + dt, fn)

    def every(self, period: float, fn: Callable,
              until: float = float("inf")) -> None:
        def tick():
            fn()
            if self.clock.now + period <= until:
                self.after(period, tick)
        self.after(period, tick)

    def run(self, until: float = float("inf"),
            stop_when: Callable[[], bool] = None) -> float:
        while self._heap:
            t, _, fn = heapq.heappop(self._heap)
            if t > until:
                heapq.heappush(self._heap, (t, next(self._seq), fn))
                break
            self.clock.now = t
            self.events_fired += 1
            EventLoop.total_events += 1
            fn()
            if stop_when is not None and stop_when():
                break
        return self.clock.now

    def run_until(self, pred: Callable[[], bool],
                  max_t: float = 1e9) -> None:
        self.run(until=max_t, stop_when=pred)

    @property
    def pending(self) -> int:
        return len(self._heap)
