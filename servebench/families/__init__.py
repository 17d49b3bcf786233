"""Model families: what the benchmark knows of each architecture.

A configuration file's ``family`` key names a module
``servebench/families/<family>.py``, which has:

- ``leaves(cfg)``: (path, shape, scale) of every weight in the port's
  parameter layout, in the order ``weights.make`` draws them;
- ``port_config(cfg)``: the keyword arguments of the port's
  ``ModelConfig`` as plain data (numbers, strings, lists, dicts), a
  sub-configuration as a nested dict under ``moe``, ``mla``, ``ssm`` or
  ``xlstm`` and the layer types as a ``layer_pattern`` list;
  ``program.model_config`` builds the port's dataclasses from it and
  names any key they lack (a family imports nothing of the program);
- ``token_flops(cfg)``: the forward operations of one token outside
  attention, and ``attention_flops(cfg, step)``: those of a step's
  attention, from its ``roofline.StepRecord`` (each decode row's context
  length, each chunk's start and length), so that a family can count
  its attention row by row and layer by layer, as a window does
  (``roofline.forward_flops``);
- ``Reference``: the plain reference of the family, a subclass of
  ``reference.Reference`` that defines ``layer`` and, where the family's
  RoPE differs, ``_rope_tables``.

It may add ``KERNELS``: ``{name: kernel_share.Kernel}`` for the
hand-written kernels its steps launch (device symbol, step modes,
launches a step, the summed least time of a step's launches), over the
defaults of the same name (``kernel_share.kernels``).  The functions
that count its operations and bytes live in the module and import only
``torch``, ``math``, ``numpy`` and ``servebench``.

A new architecture is a family module here, a configuration
(``configs/``), a traffic file (``traffic/``), a check file
(``checks/``) and its metrics' readers (``metrics/``); no file that is
already there changes.
"""
import importlib


def family(cfg: dict):
    """The module of ``cfg``'s family."""
    return importlib.import_module(f"{__name__}.{cfg['family']}")
