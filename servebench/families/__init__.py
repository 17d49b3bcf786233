"""Model families: what the benchmark knows of each architecture.

A configuration file's ``family`` key names a module
``servebench/families/<family>.py``, which has:

- ``leaves(cfg)``: (path, shape, scale) of every weight in the port's
  parameter layout, in the order ``weights.make`` draws them;
- ``port_config(cfg)``: the keyword arguments of the port's
  ``ModelConfig`` (``program.py`` builds it; a family imports nothing of
  the program);
- ``token_flops(cfg)`` and ``attention_flops(cfg, keys)``: the forward
  operations of one token outside attention, and of one query row over
  ``keys`` keys (``roofline.forward_flops``);
- ``Reference``: the plain reference of the family, a subclass of
  ``reference.Reference`` that defines ``layer``.

A new architecture is a new module here; no other file changes.
"""
import importlib


def family(cfg: dict):
    """The module of ``cfg``'s family."""
    return importlib.import_module(f"{__name__}.{cfg['family']}")
