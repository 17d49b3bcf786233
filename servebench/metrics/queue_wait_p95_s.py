"""Scheduler queue wait, 95th percentile, in seconds: admission minus
arrival for every request due in the window (``servebench/window.py``)."""
from servebench.window import percentile, queue_waits


def read(run):
    return percentile(queue_waits(run.served, run.ws, run.we), 95)
