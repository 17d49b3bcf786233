"""The program's own step trace, as the benchmark reads it.

The port's engine records spans and counters of every step in memory
(``repro_torch.engine.trace``) and registers its trace, held weakly,
where this module finds it without a handle on the engine: the newest
trace still alive, the engine's while the run's readers read.  This is
the one module of the benchmark that reads it, and it imports nothing
of the program: it looks the trace module up among the modules already
loaded (``program.py`` loads the program).  A program without such a
trace gives nothing to read, and neither does a trace whose ring no
longer holds the window whole: every function here then returns None.

- ``window_steps``: the ``engine.step`` records of the steps that
  started in the window and ran work, with their counters.
- ``device_spans``: the spans that overlap the traced sub-window, on
  the device trace's clock (the trace's ``wall_offset_ns`` added).
- ``idle_under``: the device's idle nanoseconds in the traced
  sub-window by the innermost program span covering them (None where no
  span does), charged by overlap.  Idle is the complement of the union
  of the device events, as ``device_idle_pct`` reads it, so the shares
  add up to it.
"""
from __future__ import annotations

import sys
from bisect import bisect_right
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

from servebench.tracing import _union


class Step(NamedTuple):
    step: int
    start_ns: int
    end_ns: int
    rows_real: int
    rows_padded: int
    host_syncs: int


TRACE_MODULE = "repro_torch.engine.trace"


def find():
    """The program's newest live step trace, or None."""
    mod = sys.modules.get(TRACE_MODULE)
    return mod.newest() if mod is not None else None


def window_steps(run) -> Optional[List[Step]]:
    """The steps that started in ``[ws, we)`` and ran rows."""
    tr = find()
    if tr is None:
        return None
    got = tr.steps(int(run.ws * 1e9), int(run.we * 1e9))
    if got is None:
        return None
    steps = [Step(s[1], s[3], s[4], *s[5:8]) for s in got]
    return [s for s in steps if s.rows_padded > 0]


def device_spans(run) -> Optional[List[Tuple[str, int, int]]]:
    """(name, start_ns, end_ns) of every program span that overlaps the
    traced sub-window, on the device trace's clock."""
    tr = find()
    if tr is None or run.trace is None:
        return None
    off = tr.wall_offset_ns
    got = tr.window(run.trace.t0_ns - off, run.trace.t1_ns - off)
    if got is None:
        return None
    return [(s[0], s[3] + off, s[4] + off) for s in got]


def innermost(spans: List[Tuple[str, int, int]]
              ) -> Tuple[List[int], List[Optional[str]]]:
    """Where the innermost open span changes: times, and the name open
    from each (None: no span).  Spans nest, as one thread's do."""
    edges = sorted([(a, 1, -b, n) for n, a, b in spans if b > a]
                   + [(b, 0, 0, n) for n, a, b in spans if b > a])
    stack: List[str] = []
    times: List[int] = []
    names: List[Optional[str]] = []
    for t, opens, _, n in edges:
        if opens:
            stack.append(n)
        else:
            stack.pop()
        top = stack[-1] if stack else None
        if times and times[-1] == t:
            names[-1] = top
        else:
            times.append(t)
            names.append(top)
    return times, names


def idle_under(run) -> Optional[Dict[Optional[str], int]]:
    """Idle ns of the traced sub-window by innermost program span."""
    spans = device_spans(run)
    t = run.trace
    if spans is None or not t.events:
        return None
    t0, t1 = t.t0_ns, t.t1_ns
    busy = _union([(max(a, t0), min(b, t1)) for _, a, b in t.events
                   if b > t0 and a < t1])
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    times, names = innermost(spans)
    out: Dict[Optional[str], int] = defaultdict(int)
    for a, b in zip(edges[::2], edges[1::2]):
        i = bisect_right(times, a) - 1
        while a < b:
            nxt = times[i + 1] if i + 1 < len(times) else b
            e = min(b, nxt)
            out[names[i] if i >= 0 else None] += e - a
            a, i = e, i + 1
    return dict(out)


def idle_pct(run, names) -> Optional[float]:
    """The share of the traced sub-window in which the device idled
    under one of the spans ``names``, in %."""
    idle = idle_under(run)
    if idle is None:
        return None
    t = run.trace
    return 100.0 * sum(idle.get(n, 0) for n in names) / (t.t1_ns - t.t0_ns)
