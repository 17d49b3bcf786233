"""Open-loop Poisson arrivals with the same work for every seed.

Independent users: requests fall due at fixed times, whatever the
engine does.  For the N requests of the pre-roll, and again for the N of
the window (N = rate x seconds), the lengths are the N stratified
quantiles of each length distribution and the gaps between arrivals the
N stratified quantiles of the exponential distribution at the rate; the
seed only orders them and draws the token ids.  The order is shuffled
in blocks: every ``block`` consecutive requests hold one length from
each of ``block`` equal bands of the distribution, and every ``block``
consecutive gaps one from each band of the gaps.  So the window of every
seed holds the same requests' sizes in another order, and a run's spread
is the system's and not the seed's; within a block the arrivals are as
random as Poisson's, and no burst outlasts a block's share of the
longest gaps.

Keys of its mix, besides ``generator`` and ``preroll_s``:

- ``arrivals``: ``{"rate_per_s": r}``.
- ``prompt_tokens`` and ``output_tokens``: lognormal length
  distributions (``traffic.quantile``).
- ``block``: the length of the blocks the order is shuffled in (10
  unless the mix says).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from servebench.traffic import (Schedule, TimedRequest, blocked_order,
                                lengths, strata)


def arrival_times(rate: float, n: int, rng: np.random.Generator,
                  block: int = 10) -> np.ndarray:
    """Due times of n requests: the n stratified quantiles of the
    exponential gap at ``rate``, in a seeded, blocked order, and summed;
    the first request is due after its own gap."""
    gaps = -np.log1p(-strata(n)) / rate
    return np.cumsum(gaps[blocked_order(n, block, rng)])


def requests(mix: dict, vocab: int, seed: int, seconds: float,
             rate_per_s: Optional[float] = None) -> List[TimedRequest]:
    """The pre-roll's requests and then the window's, each part a
    stratified set of its own, sorted by due time."""
    rate = float(rate_per_s if rate_per_s is not None
                 else mix["arrivals"]["rate_per_s"])
    rng = np.random.default_rng(seed % (1 << 63))
    block = int(mix.get("block", 10))
    reqs = []
    start = 0.0
    for span in (float(mix["preroll_s"]), float(seconds)):
        n = round(rate * span)
        if n <= 0:
            continue
        due = start + arrival_times(rate, n, rng, block)
        own = lengths(mix["prompt_tokens"], n, rng, block)
        out = lengths(mix["output_tokens"], n, rng, block)
        for i in range(n):
            body = rng.integers(0, vocab, size=own[i]).tolist()
            reqs.append(TimedRequest(float(due[i]), body, out[i]))
        start += span
    return reqs


def source(mix: dict, vocab: int, seed: int, seconds: float,
           rate_per_s: Optional[float] = None) -> Schedule:
    return Schedule(requests(mix, vocab, seed, seconds, rate_per_s),
                    mix["preroll_s"])
