"""Spans from the harness's side, and the device trace of a sub-window.

``Spans`` wraps the calls into each layer of the program on one engine
(``InferenceEngine.step``, ``Scheduler.schedule``, the runner's
``run_mixed``/``run_decode``/``run_prefill`` and ``sample``) and keeps
(name, start, end) in memory, on the wall clock in nanoseconds, the
clock the profiler stamps its events with.

``DeviceTrace`` profiles a short steady sub-window with
``torch.profiler`` (device activity only: host tracing would slow every
launch and inflate the idle share), from the start of one step to the
end of a later one, and reduces it to a ``TraceSummary``: busy seconds
(the union of device operation intervals), the device operations
themselves and their seconds by name, and the idle gaps labelled by the innermost span the
host was in at each gap's middle.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

Span = Tuple[str, int, int]


class Spans:
    """(name, start_ns, end_ns) of the wrapped calls, in memory."""

    def __init__(self):
        self.items: List[Span] = []

    def wrap(self, obj, attr: str, name: str) -> None:
        orig = getattr(obj, attr)
        items = self.items

        def timed(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return orig(*args, **kwargs)
            finally:
                items.append((name, t0, time.time_ns()))
        setattr(obj, attr, timed)

    def instrument(self, engine) -> None:
        self.wrap(engine, "step", "InferenceEngine.step")
        self.wrap(engine.sched, "schedule", "Scheduler.schedule")
        for attr in ("run_mixed", "run_decode", "run_prefill", "sample"):
            self.wrap(engine.runner, attr, f"ModelRunner.{attr}")


@dataclass
class TraceSummary:
    t0_ns: int
    t1_ns: int
    busy_s: float
    op_seconds: Dict[str, float] = field(default_factory=dict)
    idle_by_host: Dict[str, float] = field(default_factory=dict)
    events: List[Tuple[str, int, int]] = field(default_factory=list)
    aligned_share: Optional[float] = None

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def launches(self, symbol: str, t0: float,
                 t1: float) -> List[Tuple[int, int]]:
        """(start_ns, end_ns) of every launch of an operation whose name
        holds ``symbol`` that started between the wall-clock seconds
        ``t0`` and ``t1``."""
        a, b = int(t0 * 1e9), int(t1 * 1e9)
        return [(s, e) for n, s, e in self.events
                if symbol in n and a <= s <= b]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by short name) and
        the idle time by what the host was doing, at most ``top`` each."""
        by_name: Dict[str, float] = defaultdict(float)
        for k, v in self.op_seconds.items():
            by_name[short_name(k)] += v
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def short_name(name: str, width: int = 96) -> str:
    """A device operation's name without its return type, template
    arguments and parameter list."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:width]


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device operation of a finished
    profile, on the wall clock."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    res = prof.profiler.kineto_results
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in res.events() if e.device_type() == cuda]


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _innermost(spans: List[Span], t: int) -> str:
    best, width = "between steps", None
    for name, a, b in spans:
        if a <= t <= b and (width is None or b - a < width):
            best, width = name, b - a
    return best


def summarize(events: List[Tuple[str, int, int]], spans: List[Span],
              t0: int, t1: int) -> TraceSummary:
    """Reduce device events and host spans over [t0, t1] (ns)."""
    clipped = [(n, max(a, t0), min(b, t1)) for n, a, b in events
               if b > t0 and a < t1]
    busy = _union([(a, b) for _, a, b in clipped])
    secs: Dict[str, float] = defaultdict(float)
    for n, a, b in events:
        secs[n] += (b - a) / 1e9
    near = [s for s in spans if s[2] >= t0 and s[1] <= t1]
    idle: Dict[str, float] = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            idle[_innermost(near, (a + b) // 2)] += (b - a) / 1e9
    steps = [(a, b) for n, a, b in near if n == "InferenceEngine.step"]
    aligned = None
    if steps and events:
        inside = sum(1 for _, a, _ in events
                     if any(s <= a <= e for s, e in steps))
        aligned = inside / len(events)
    return TraceSummary(t0, t1, sum(b - a for a, b in busy) / 1e9,
                        dict(secs), dict(idle), events, aligned)


class DeviceTrace:
    """A device-only ``torch.profiler`` over one sub-window."""

    def __init__(self):
        self._prof = None
        self.t0 = self.t1 = 0
        self.summary: Optional[TraceSummary] = None

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, so that its first start (it
        loads and sets up CUPTI) falls into set-up, not the window."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @property
    def running(self) -> bool:
        return self._prof is not None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.time_ns()

    def stop(self, spans: List[Span]) -> TraceSummary:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        self.summary = summarize(_device_events(prof), spans, self.t0,
                                 self.t1)
        return self.summary
