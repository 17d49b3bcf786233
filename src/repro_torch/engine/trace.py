"""The engine's step trace: spans and counters of every step, in memory.

One ``StepTrace`` is shared by an ``InferenceEngine`` and its
``ModelRunner``.  Each span is a tuple ``(name, step, parent, start_ns,
end_ns)``: its name (one of the constants below), the id of the
``engine.step`` it ran in, the name of the span it ran inside (None at
the top), and its bounds on ``time.monotonic_ns``, the engine's default
clock, so spans line up with the window bounds and ``Request``
timestamps on that clock.  An ``engine.step`` span carries the step's
counters after its bounds: ``(..., rows_real, rows_padded,
host_syncs)``, counted where the work happens:

- ``rows_real``: tokens the step really ran (a decode row, a chunk's
  tokens, a verify lane's tokens);
- ``rows_padded``: rows the runner's input tensors held (every decode
  slot, every prefill slot times its width);
- ``host_syncs``: calls in which the host waited for the device: each
  ``runner.readback`` span (a readback, or the async loop's wait on its
  staging copy) and each blocking host-to-device copy.

The spans go to a ring of ``capacity`` entries, in the order they
close.  A span costs two clock reads, a tuple and a list push and pop,
and no CUDA call: the trace is always on.  A window is whole in the
ring unless the ring is full and its oldest span ended inside or after
the window: only then may a span of it have been dropped.  Running
totals of ``engine.step`` and ``runner.readback`` are kept apart from
the ring: they give the engine's step wall (``step_ns``) and the
runner's ``device_wait_s`` (``wait_ns``).

``wall_offset_ns`` is ``time.time_ns()`` less the trace clock, from the
tightest of a few paired reads when the trace is made: the profiler
stamps device events on the wall clock.  Every trace registers itself,
held weakly; ``newest`` returns the newest one still alive, so that a
benchmark finds the trace without a handle on the engine.
"""
from __future__ import annotations

import itertools
import time
import weakref
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

STEP = "engine.step"            # the whole InferenceEngine.step call
SCHEDULE = "engine.schedule"    # the call into the scheduler
INPUTS = "runner.inputs"        # host buffers filled and copied over
FORWARD = "runner.forward"      # the enqueue of the model's step
SAMPLE = "runner.sample"        # one sampling call, readback included
READBACK = "runner.readback"    # the host's wait for the device
UPDATE = "engine.update"        # scheduler bookkeeping on the tokens

# 120 s of steps at ~10 steps/s and at most ~25 spans a step, doubled
CAPACITY = 1 << 16

Span = Tuple


def wall_offset_ns(clock: Callable[[], int] = time.monotonic_ns,
                   wall: Callable[[], int] = time.time_ns,
                   reads: int = 5) -> int:
    """``wall`` less ``clock``, from the tightest of ``reads`` wall reads
    each between two clock reads."""
    best = None
    for _ in range(reads):
        a = clock()
        w = wall()
        b = clock()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


class StepTrace:
    """Spans and counters of an engine's steps, in a bounded ring."""

    def __init__(self, capacity: int = CAPACITY,
                 clock: Callable[[], int] = time.monotonic_ns):
        self.clock = clock
        self.spans: deque = deque(maxlen=capacity)
        self.step_ns = self.wait_ns = 0
        self.step = 0
        self.rows_real = self.rows_padded = self.host_syncs = 0
        self._open: List[str] = []      # names of open spans, innermost last
        self.wall_offset_ns = wall_offset_ns(clock)
        _live[next(_ids)] = self

    def begin(self, name: str) -> int:
        """Open a span inside the innermost open one; its start."""
        self._open.append(name)
        return self.clock()

    def end(self, start: int) -> None:
        """Close the innermost open span, begun at ``start``."""
        t = self.clock()
        opened = self._open
        name = opened.pop()
        self.spans.append((name, self.step, opened[-1] if opened else None,
                           start, t))
        if name is READBACK:            # a wait: one host sync
            self.wait_ns += t - start
            self.host_syncs += 1

    def begin_step(self) -> int:
        """Open the next step's ``engine.step`` span, counters at 0."""
        self.step += 1
        self.rows_real = self.rows_padded = self.host_syncs = 0
        self._open.clear()
        return self.begin(STEP)

    def end_step(self, start: int) -> None:
        """Close the step's span with its counters; a span the step left
        open (an exception went through it) is dropped."""
        t = self.clock()
        self._open.clear()
        self.spans.append((STEP, self.step, None, start, t, self.rows_real,
                           self.rows_padded, self.host_syncs))
        self.step_ns += t - start

    def holds(self, t0: int) -> bool:
        """Whether the ring still holds every span that ended at or after
        ``t0``."""
        spans = self.spans
        return len(spans) < spans.maxlen or spans[0][4] < t0

    def window(self, t0: int, t1: int) -> Optional[List[Span]]:
        """Every span that overlaps ``[t0, t1]`` (trace clock, ns), or
        None when the ring may have dropped one."""
        if not self.holds(t0):
            return None
        return [s for s in self.spans if s[4] >= t0 and s[3] <= t1]

    def steps(self, t0: int, t1: int) -> Optional[List[Span]]:
        """The ``engine.step`` spans that started in ``[t0, t1)``, or None
        when the ring may have dropped one."""
        if not self.holds(t0):
            return None
        return [s for s in self.spans if s[0] == STEP and t0 <= s[3] < t1]


def self_ns(spans: List[Span]) -> Dict[str, int]:
    """Self time by name: each span's duration less its children's (the
    spans of its step that name it as parent and lie inside it)."""
    out: Dict[str, int] = {}
    by_step: Dict[int, List[Span]] = {}
    for s in spans:
        by_step.setdefault(s[1], []).append(s)
    for group in by_step.values():
        for name, _, parent, a, b, *_ in group:
            out[name] = out.get(name, 0) + b - a
            for pname, _, _, pa, pb, *_ in group:
                if pname == parent and pa <= a and b <= pb:
                    out[parent] = out.get(parent, 0) - (b - a)
                    break
    return out


_live: "weakref.WeakValueDictionary[int, StepTrace]" = \
    weakref.WeakValueDictionary()
_ids = itertools.count()


def newest() -> Optional[StepTrace]:
    """The trace made last of those still alive, or None."""
    for key in sorted(_live.keys(), reverse=True):
        tr = _live.get(key)
        if tr is not None:
            return tr
    return None
