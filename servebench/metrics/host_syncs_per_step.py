"""Runner: the calls in which the host waited for the device (readbacks,
blocking copies to the device), a step, over the window's executed
steps, from the program's own counter (``host_syncs`` of each
``engine.step`` span; ``servebench/program_trace.py``)."""
from servebench.program_trace import window_steps


def read(run):
    steps = window_steps(run)
    if not steps:
        return None
    return sum(s.host_syncs for s in steps) / len(steps)
