"""A hand-written kernel's share of its roofline in the traced sub-window.

``kernels(cfg)`` declares the kernels of a configuration: the two that
every paged model launches once a layer (``paged_attention``,
``paged_prefill``), merged with the ``KERNELS`` dict that the
configuration's family module may define (``servebench/families/``); a
family's entry of the same name replaces the default.  Each entry is a
``Kernel``: the device function's name as the profiler gives it, the
step modes that launch it, how many launches one step makes, and the
summed least time of one step's launches from its schedule
(``servebench/roofline.py``).

The sub-window starts and ends on step boundaries with nothing in
flight, so where the trace holds the declared launches for each traced
step of those modes, the launches in order are the steps' in order.
Where it holds another number (a trace that dropped events), each launch
belongs to the step in whose wall-clock span it started, and a step that
then holds another number than the declared one is left out.  The share
is the summed least time of the launches over their summed device time;
with every step left out it reads nothing.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

from servebench.families import family
from servebench.roofline import (bound_s, paged_attention_cost,
                                 paged_prefill_cost)

ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


class Kernel(NamedTuple):
    symbol: str                       # held by the device function's name
    modes: Tuple[str, ...]            # step modes that launch it
    launches: Callable                # (cfg) -> launches a step
    least_s: Callable                 # (cfg, step, page, esize) -> seconds


def per_layer(symbol: str, modes: Tuple[str, ...], cost: Callable) -> Kernel:
    """A kernel launched once on each of ``num_hidden_layers`` layers,
    each launch doing ``cost(cfg, step, page, esize)``'s (operations,
    bytes)."""
    return Kernel(symbol, modes, lambda cfg: cfg["num_hidden_layers"],
                  lambda cfg, step, page, es: cfg["num_hidden_layers"]
                  * bound_s(*cost(cfg, step, page, es)))


KERNELS = {
    "paged_attention": per_layer(
        "paged_attention_kernel", ("mixed", "decode"),
        lambda cfg, s, page, es: paged_attention_cost(cfg, s.dec_lens, page,
                                                      es)),
    "paged_prefill": per_layer(
        "paged_prefill_kernel", ("mixed", "prefill"),
        lambda cfg, s, page, es: paged_prefill_cost(cfg, s.chunks, page,
                                                    es)),
}


def kernels(cfg: dict) -> Dict[str, Kernel]:
    """The kernels of ``cfg``: the defaults, and its family's ``KERNELS``
    over them."""
    return {**KERNELS, **getattr(family(cfg), "KERNELS", {})}


def step_launches(run, kernel: str):
    """(step, its launches of ``kernel``) for every traced step of a mode
    that launches it."""
    k = kernels(run.cfg)[kernel]
    steps = [s for s in run.trace_steps if s.mode in k.modes]
    n = k.launches(run.cfg)
    every = sorted(run.trace.launches(k.symbol, run.trace.t0_ns / 1e9,
                                      run.trace.t1_ns / 1e9))
    if len(every) == n * len(steps):
        return [(s, every[i * n:(i + 1) * n]) for i, s in enumerate(steps)]
    return [(s, run.trace.launches(k.symbol, s.wall0, s.wall1))
            for s in steps]


def roofline_pct(run, kernel: str) -> Optional[float]:
    if run.trace is None:
        return None
    k = kernels(run.cfg)[kernel]
    n = k.launches(run.cfg)
    e = run.cfg["engine"]
    least = device_ns = 0.0
    for step, launched in step_launches(run, kernel):
        if len(launched) != n:
            continue
        least += k.least_s(run.cfg, step, e["page_size"], ESIZE[e["dtype"]])
        device_ns += sum(b - a for a, b in launched)
    return 100.0 * least / (device_ns / 1e9) if device_ns > 0 else None
