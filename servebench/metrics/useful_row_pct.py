"""Runner: the rows the window's executed steps really ran over the rows
the runner's input tensors held, in %, from the program's own counters
(``rows_real``, ``rows_padded`` of each ``engine.step`` span;
``servebench/program_trace.py``)."""
from servebench.program_trace import window_steps


def read(run):
    steps = window_steps(run)
    if not steps:
        return None
    return (100.0 * sum(s.rows_real for s in steps)
            / sum(s.rows_padded for s in steps))
