"""Model step: forward operations of the real tokens the window's steps
processed, counted from shapes (``servebench/roofline.py``), over the
window's seconds at the card's bf16 peak, in %."""
from servebench.roofline import PEAK_FLOPS, forward_flops


def read(run):
    steps = run.window_steps
    if not steps:
        return None
    flops = sum(forward_flops(run.cfg, s) for s in steps)
    return 100.0 * flops / (run.seconds * PEAK_FLOPS)
