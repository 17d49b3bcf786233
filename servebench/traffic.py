"""Traffic: a mix file of parameters, and the generator it names.

A mix (``servebench/traffic/<name>.json``) states ``generator``, the name
of a module ``servebench/generators/<generator>.py`` that reads the rest
of the file, and ``preroll_s``, the seconds of traffic offered before
the window opens.  A generator module has one entry,

    source(mix, vocab, seed, seconds, rate_per_s=None) -> Source

which makes the requests from ``seed`` (the same seed, the same
requests; token ids in ``[0, vocab)``) for the pre-roll and a window of
``seconds``; ``rate_per_s`` overrides the mix's rate (the knee sweep).
The ``Source`` is the admission policy the harness follows
(``harness.drive``):

- ``take(t, finished)``: the requests to submit ``t`` seconds after the
  traffic's start, each with the time it fell due.  ``finished()``
  gives, for every request submitted so far in order, the seconds after
  the start at which it finished, or None: a closed loop or a session
  hands out a request only once an earlier one is done.
- ``next_due(t)``: when to look again while the engine has nothing to
  do (seconds after the start), or None to wait for the window's close.
- ``preroll_s``.

``Schedule`` is the open loop: requests due at fixed times, whatever the
engine does.  The helpers below make lengths that every generator may
share: the stratified quantiles of a clipped lognormal, in a seeded,
blocked order, so that every seed gets the same sizes.
"""
from __future__ import annotations

import importlib
import math
import statistics
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

_NORMAL = statistics.NormalDist()


@dataclass
class TimedRequest:
    """One request of a run: due ``due_s`` seconds after the traffic's
    start, with its prompt and the number of tokens it is served."""
    due_s: float
    prompt: List[int]
    max_new_tokens: int


class Schedule:
    """An open loop: ``reqs`` fall due at their own times."""

    def __init__(self, reqs: List[TimedRequest], preroll_s: float):
        self.reqs = sorted(reqs, key=lambda r: r.due_s)
        self.preroll_s = float(preroll_s)
        self._next = 0

    def take(self, t: float,
             finished: Optional[Callable] = None) -> List[TimedRequest]:
        i = self._next
        while i < len(self.reqs) and self.reqs[i].due_s <= t:
            i += 1
        out, self._next = self.reqs[self._next:i], i
        return out

    def next_due(self, t: float) -> Optional[float]:
        if self._next < len(self.reqs):
            return self.reqs[self._next].due_s
        return None


def source(mix: dict, vocab: int, seed: int, seconds: float,
           rate_per_s: Optional[float] = None):
    """The ``Source`` of ``mix``'s generator for ``seed``."""
    gen = importlib.import_module(
        f"servebench.generators.{mix['generator']}")
    return gen.source(mix, vocab, seed, seconds, rate_per_s)


# ------------------------------------------------ helpers of generators
def strata(n: int) -> np.ndarray:
    """The midpoints of n equal slices of (0, 1)."""
    return (np.arange(n) + 0.5) / n


def quantile(dist: dict, u: float) -> int:
    """The length at quantile ``u`` of ``{"dist": "lognormal", "median":
    m, "sigma": s, "min": lo, "max": hi}``, clipped to [lo, hi]."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    x = dist["median"] * math.exp(dist["sigma"] * _NORMAL.inv_cdf(u))
    return int(min(max(round(x), dist["min"]), dist["max"]))


def blocked_order(n: int, block: int,
                  rng: np.random.Generator) -> List[int]:
    """A seeded order of n items ranked 0..n-1 in which every block of
    ``block`` consecutive positions holds one item of each of ``block``
    equal bands of the ranks: the blocks' order and the order inside
    each block are shuffled."""
    nb = -(-n // block)
    order: List[int] = []
    for b in rng.permutation(nb).tolist():
        ranks = list(range(b, n, nb))
        order += [ranks[i] for i in rng.permutation(len(ranks)).tolist()]
    return order


def lengths(dist: dict, n: int, rng: np.random.Generator,
            block: int = 10) -> List[int]:
    """n lengths: the stratified quantiles of ``dist`` in a seeded,
    blocked order."""
    vals = [quantile(dist, u) for u in strata(n)]
    return [vals[i] for i in blocked_order(n, block, rng)]
