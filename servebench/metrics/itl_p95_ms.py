"""Gap between consecutive output tokens, 95th percentile, in ms: every
gap of every request whose later token came in the window."""
from servebench.window import percentile, token_gaps


def read(run):
    p = percentile(token_gaps(run.served, run.ws, run.we), 95)
    return None if p is None else p * 1e3
