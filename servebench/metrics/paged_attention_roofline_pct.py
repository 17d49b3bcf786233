"""Kernel ``paged_attention``: its least possible time over its device
time in the traced sub-window, in %.  The least time of each launch is
the larger of its operations at the bf16 peak and its bytes at the HBM
bandwidth, from the executed schedules' decode rows
(``servebench/roofline.py``).  A traced step that holds another
number of launches than the declared one (one a layer, unless the
family declares otherwise) is left out (``servebench/kernel_share.py``)."""
from servebench.kernel_share import roofline_pct


def read(run):
    return roofline_pct(run, "paged_attention")
