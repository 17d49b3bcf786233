"""A hand-written kernel's share of its roofline in the traced sub-window.

The kernels' device functions, as the profiler names them, the step modes
that launch each once a layer, and the cost of one launch from a step's
schedule (``servebench/roofline.py``).  The sub-window starts and ends
on step boundaries with nothing in flight, so where the trace holds one
launch a layer for each traced step of those modes, the launches in
order are the steps' in order.  Where it holds another number (a trace
that dropped events), each launch belongs to the step in whose
wall-clock span it started, and a step that then holds another number
than one a layer is left out.  The share is the summed least time of the
launches over their summed device time; with every step left out it
reads nothing.
"""
from __future__ import annotations

from typing import Optional

from servebench.roofline import (bound_s, paged_attention_cost,
                                 paged_prefill_cost)

ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
KERNELS = {
    "paged_attention": ("paged_attention_kernel", ("mixed", "decode"),
                        lambda cfg, s, page, es: paged_attention_cost(
                            cfg, s.dec_lens, page, es)),
    "paged_prefill": ("paged_prefill_kernel", ("mixed", "prefill"),
                      lambda cfg, s, page, es: paged_prefill_cost(
                          cfg, s.chunks, page, es)),
}


def step_launches(run, kernel: str):
    """(step, its launches of ``kernel``) for every traced step of a mode
    that launches it."""
    symbol, modes, _ = KERNELS[kernel]
    steps = [s for s in run.trace_steps if s.mode in modes]
    layers = run.cfg["num_hidden_layers"]
    every = sorted(run.trace.launches(symbol, run.trace.t0_ns / 1e9,
                                      run.trace.t1_ns / 1e9))
    if len(every) == layers * len(steps):
        return [(s, every[i * layers:(i + 1) * layers])
                for i, s in enumerate(steps)]
    return [(s, run.trace.launches(symbol, s.wall0, s.wall1))
            for s in steps]


def roofline_pct(run, kernel: str) -> Optional[float]:
    if run.trace is None:
        return None
    cost = KERNELS[kernel][2]
    layers = run.cfg["num_hidden_layers"]
    e = run.cfg["engine"]
    least = device_ns = 0.0
    for step, launched in step_launches(run, kernel):
        if len(launched) != layers:
            continue
        least += layers * bound_s(*cost(run.cfg, step, e["page_size"],
                                        ESIZE[e["dtype"]]))
        device_ns += sum(b - a for a, b in launched)
    return 100.0 * least / (device_ns / 1e9) if device_ns > 0 else None
