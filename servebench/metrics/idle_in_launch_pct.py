"""Model step: the share of the traced sub-window in which the device
idled while the host was innermost in ``runner.forward`` (enqueuing the
forward pass), in % (``servebench/program_trace.py``)."""
from servebench.program_trace import idle_pct


def read(run):
    return idle_pct(run, ("runner.forward",))
