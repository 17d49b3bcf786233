"""The window's arithmetic: which requests and gaps a metric takes.

A run offers its traffic from ``start`` (the pre-roll) and measures
from ``ws`` to ``we``.  Every time here is on the engine's clock
(``time.monotonic``).

- Time to first token is timed from when a request was *due*, not from
  when the submitter handed it over, so a stall that delays later
  submissions counts.  It is taken over every request due in the
  window; one with no first token by ``we`` counts at its wait so far.
- Queue wait is the scheduler's own: admission minus the arrival the
  engine stamped at submission.  A request due in the window and not
  admitted by ``we`` counts at its wait so far (from its arrival, or
  from when it was due if it was never submitted).
- A gap between consecutive output tokens counts when the later token
  came inside the window, so every gap completed in the window counts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence


@dataclass
class Served:
    """One request of the traffic: due at ``due`` (engine clock), and the
    engine's request once submitted (None before)."""
    due: float
    req: Optional[Any] = None


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """The p-th percentile with linear interpolation between order
    statistics (numpy's default); None for no values."""
    if not values:
        return None
    xs = sorted(values)
    k = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def due_in(served: Sequence[Served], ws: float, we: float) -> List[Served]:
    return [s for s in served if ws <= s.due < we]


def ttfts(served: Sequence[Served], ws: float, we: float) -> List[float]:
    """Seconds from due to first token for every request due in the
    window; a request without a first token by ``we`` at ``we - due``."""
    out = []
    for s in due_in(served, ws, we):
        t = s.req.first_token_time if s.req is not None else 0.0
        out.append((t if 0.0 < t <= we else we) - s.due)
    return out


def queue_waits(served: Sequence[Served], ws: float,
                we: float) -> List[float]:
    """Seconds from arrival to admission for every request due in the
    window; one not admitted by ``we`` at its wait so far."""
    out = []
    for s in due_in(served, ws, we):
        r = s.req
        arrived = r.arrival_time if r is not None else s.due
        admitted = r.schedule_time if r is not None else 0.0
        out.append((admitted if 0.0 < admitted <= we else we) - arrived)
    return out


def token_gaps(served: Sequence[Served], ws: float,
               we: float) -> List[float]:
    """Every gap between consecutive output tokens of any request whose
    later token came in ``[ws, we]``."""
    out = []
    for s in served:
        r = s.req
        if r is None or not r.first_token_time:
            continue
        times = [r.first_token_time] + list(r.token_times)
        out += [b - a for a, b in zip(times, times[1:]) if ws <= b <= we]
    return out
