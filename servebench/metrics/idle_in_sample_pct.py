"""Runner: the share of the traced sub-window in which the device idled
while the host was innermost in ``runner.sample``, ``runner.readback``
or ``engine.update`` (sampling, waiting for the tokens, the scheduler's
bookkeeping on them), in % (``servebench/program_trace.py``)."""
from servebench.program_trace import idle_pct


def read(run):
    return idle_pct(run, ("runner.sample", "runner.readback",
                          "engine.update"))
