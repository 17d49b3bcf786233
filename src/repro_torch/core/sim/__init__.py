"""The port's copy of ``repro/core/sim``: the workload generators and
their summaries (``workloads.py``) only.

One difference from the reference ``__init__``: that one also imports
the discrete-event cluster simulator (``cluster_sim``, ``sim_engine``,
``events``, ``chaos``), which needs ``core/diagnostics``.  The launcher
uses none of it, and neither is copied yet.
"""
from repro_torch.core.sim import workloads  # noqa: F401
