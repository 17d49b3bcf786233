"""Engine loop: the share of the traced sub-window in which the device
idled while the host was innermost in ``engine.schedule`` or
``runner.inputs`` (scheduling, filling and copying the inputs), in %
(``servebench/program_trace.py``)."""
from servebench.program_trace import idle_pct


def read(run):
    return idle_pct(run, ("engine.schedule", "runner.inputs"))
