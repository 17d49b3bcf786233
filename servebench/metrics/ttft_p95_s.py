"""Time to first token, 95th percentile, in seconds: every request due in
the window, timed from when it was due (``servebench/window.py``)."""
from servebench.window import percentile, ttfts


def read(run):
    return percentile(ttfts(run.served, run.ws, run.we), 95)
